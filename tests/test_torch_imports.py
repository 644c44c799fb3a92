"""The PyTorch port stands alone: no module of `gemnet_pytorch_tpu_torch/`,
and not `chip_smoke.py`, imports JAX, flax, optax or the JAX package; nothing
on the serving or training path imports PyYAML or ase at module level (ase
only inside md.make_ase_calculator)."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gemnet_pytorch_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gemnet_pytorch_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    """(top-level module name, at module level?) of every import in `path`;
    relative imports stay inside the package and are skipped."""
    tree = ast.parse(open(path).read(), path)
    top = set(map(id, tree.body))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], id(node) in top) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append((node.module.split(".")[0], id(node) in top))
    return out


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    bad = [name for name, _ in _imports(path) if name in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_training_modules_are_checked():
    """The training slice's modules are among the files checked above."""
    rel = {os.path.relpath(p, PORT) for p in _port_files() if p.startswith(PORT)}
    for name in ("config.py", "data/provider.py", "training/__init__.py",
                 "training/flat_opt.py", "training/metrics.py", "training/schedules.py",
                 "training/trainer.py"):
        assert name in rel, name


def test_driver_and_probe_modules_are_checked():
    """The train.py driver, checkpoints, export, the split3 and row-gather
    ops and the probe are among the files checked above, and the split3 and
    row-gather kernel entries are built and bound by `_cuda`."""
    from gemnet_pytorch_tpu_torch.ops import _cuda

    rel = {os.path.relpath(p, PORT) for p in _port_files() if p.startswith(PORT)}
    for name in ("train.py", "training/checkpoint.py", "compat.py", "ops/segment_outer.py",
                 "ops/row_gather.py", "scripts/__init__.py", "scripts/gather_probe.py"):
        assert name in rel, name
    for source in ("segment_outer.cu", "row_gather.cu"):
        assert source in _cuda.SOURCES and os.path.exists(os.path.join(PORT, "csrc", source))
    for name in ("gemnet_segment_outer_sum_split3", "gemnet_segment_gather_contract_split3",
                 "gemnet_row_gather", "gemnet_row_gather_fm"):
        assert name in _cuda._FUNCTIONS, name
    assert {src for src, _, _ in _cuda._FUNCTIONS.values()} == set(_cuda.SOURCES)


def test_bench_and_perf_modules_are_checked():
    """The bench and its timing, roofline and trace modules are among the
    files checked above."""
    rel = {os.path.relpath(p, PORT) for p in _port_files() if p.startswith(PORT)}
    for name in ("bench.py", "perf/__init__.py", "perf/timing.py", "perf/roofline.py",
                 "perf/trace.py"):
        assert name in rel, name


def test_graph_and_md_modules_are_checked():
    """The CUDA-graph capture, the batch packer and the MD module are among
    the files checked above."""
    rel = {os.path.relpath(p, PORT) for p in _port_files() if p.startswith(PORT)}
    for name in ("graphs.py", "data/packer.py", "md.py"):
        assert name in rel, name


def test_rest_of_training_modules_are_checked():
    """The per-tensor optimizer, scale fitting (its module and its entry
    point) and the scaling bookkeeping are among the files checked above;
    the entry point reads PyYAML only inside `main`."""
    rel = {os.path.relpath(p, PORT) for p in _port_files() if p.startswith(PORT)}
    for name in ("training/tree_opt.py", "training/fit_scaling.py", "fit_scaling.py",
                 "models/scaling.py"):
        assert name in rel, name


def test_serving_path_imports_no_yaml_or_ase():
    """PyYAML is imported only inside the config loader; ase only inside
    md.py's ASE adapter, where it is installed (as the JAX package's md.py)."""
    for path in _port_files():
        for name, at_top in _imports(path):
            assert not (name == "ase" and (at_top or not path.endswith(os.sep + "md.py"))), path
            assert not (name == "yaml" and at_top), path


def test_package_imports_without_jax(tmp_path):
    """Import every module of the port in a fresh interpreter whose `jax`
    and `flax` imports fail."""
    import subprocess
    import sys

    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("raise ImportError('jax is blocked')\n")
    (tmp_path / "flax").mkdir()
    (tmp_path / "flax" / "__init__.py").write_text("raise ImportError('flax is blocked')\n")
    mods = sorted(
        "gemnet_pytorch_tpu_torch." + os.path.relpath(p, PORT)[:-3].replace(os.sep, ".")
        .replace(".__init__", "").replace("__init__", "")
        for p in _port_files() if p.startswith(PORT))
    code = "import importlib\nfor m in %r: importlib.import_module(m.rstrip('.'))\n" % mods
    code += "import chip_smoke\n"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_parallel_modules_are_checked():
    """The parallel package (process groups and 2-D meshes, the collectives,
    data parallelism, the halo and row-space edge partitions, the hybrid
    meshes, the pipeline, tensor parallelism) and the variant sweep are
    among the files checked above, and import without JAX in the fresh
    interpreter of `test_package_imports_without_jax`."""
    rel = {os.path.relpath(p, PORT) for p in _port_files() if p.startswith(PORT)}
    for name in ("parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
                 "parallel/dp.py", "parallel/halo.py", "parallel/ep.py", "parallel/hybrid.py",
                 "parallel/pp.py", "parallel/tp.py", "scripts/sweep.py"):
        assert name in rel, name

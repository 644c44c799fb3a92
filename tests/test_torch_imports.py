"""The PyTorch port stands alone: no module of `gemnet_pytorch_tpu_torch/`,
and not `chip_smoke.py`, imports JAX, flax, optax or the JAX package; nothing
on the serving or training path imports PyYAML or ase at module level."""

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


def test_serving_path_imports_no_yaml_or_ase():
    """PyYAML is imported only inside the config loader, ase nowhere."""
    for path in _port_files():
        for name, at_top in _imports(path):
            assert name != "ase", path
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

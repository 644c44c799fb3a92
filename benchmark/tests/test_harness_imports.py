"""No run loads JAX or the JAX package (compared by whole top-level module
names: the port's name begins with the JAX package's), and the reference
imports nothing of the program under test."""

import ast
import os
import subprocess
import sys

from benchmark import run

REFERENCE = os.path.join(run.HERE, "reference")
PORT = "gemnet_pytorch_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(REFERENCE):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(REFERENCE, name)):
                top = mod.lstrip(".").split(".")[0]
                assert top not in (PORT,) + run.FORBIDDEN, (name, mod)
                assert not mod.startswith("..") and top != "benchmark", (name, mod)


def test_reference_loads_no_program_module():
    code = ("import sys; import benchmark.reference.model, benchmark.reference.graph, "
            "benchmark.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = eval(out)  # a list of names this process printed
    assert PORT not in tops and not set(tops) & set(run.FORBIDDEN)


def test_a_run_loads_no_jax():
    code = (
        "import json, sys, torch; torch.set_num_threads(2)\n"
        "from benchmark import run\n"
        "from benchmark.tests import tiny\n"
        "r = run.run('q-coll-train', 5, 0.2, False, device='cpu', "
        "overrides=tiny.overrides('q-coll-train'))\n"
        "print(json.dumps([r['correct'], run.forbidden_modules(), "
        f"'{PORT}' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    assert out == "[true, [], true]"


def test_the_guard_names_what_it_finds(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    monkeypatch.setitem(sys.modules, "gemnet_pytorch_tpu.models", sys)
    assert run.forbidden_modules() == ["gemnet_pytorch_tpu", "jax"]


def test_a_directory_of_the_benchmark_alone_fails(tmp_path):
    """Without the program beside it, the command exits non-zero and prints
    no result line."""
    import shutil
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "q-coll-train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert p.returncode != 0 and '"correct"' not in p.stdout

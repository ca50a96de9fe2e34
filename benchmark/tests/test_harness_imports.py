"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either: every import statement
at any depth, its top-level name (before the first dot) compared whole,
since the port's name `kdip_tpu_torch` begins with the JAX package's. A run
refuses to print a result when such a module was loaded."""

import ast
import os
import sys
import types

import pytest

import tiny

JAX = {"jax", "jaxlib", "flax", "kdip_tpu"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def sources():
    for d, dirs, files in os.walk(tiny.BENCH):
        dirs[:] = [x for x in dirs if not x.startswith((".", "__"))]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_the_names_are_compared_whole():
    assert "kdip_tpu_torch" not in JAX
    assert "kdip_tpu_torch.ops".split(".")[0] not in JAX
    assert "kdip_tpu.ops".split(".")[0] in JAX


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    paths = list(sources())
    assert len(paths) > 20
    found = [(p, n) for p in paths for n in top_level_imports(p) if n in JAX]
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(tiny.BENCH, "reference")
    paths = [p for p in sources() if p.startswith(ref + os.sep)]
    assert len(paths) >= 5
    banned = JAX | {"kdip_tpu_torch", "harness", "families", "operators"}
    found = [(p, n) for p in paths for n in top_level_imports(p)
             if n in banned]
    assert not found


def test_a_run_names_a_loaded_jax_module(monkeypatch):
    import run
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "kdip_tpu_torch_x",
                        types.ModuleType("kdip_tpu_torch_x"))
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert run.banned_modules() == ["jax"]


def test_no_card_no_result(capsys):
    """Without a CUDA card a run exits with 2 and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    import run
    cwd = os.getcwd()
    os.chdir(tiny.ROOT)
    try:
        rc = run.main(["--workload", "ffhq_dwt_var.inpaint.b8", "--seed",
                       "1", "--seconds", "1", "--trace", "0"])
    finally:
        os.chdir(cwd)
    assert rc == 2
    assert "{" not in capsys.readouterr().out

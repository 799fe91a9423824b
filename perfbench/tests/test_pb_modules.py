"""The check that no JAX and no JAX package is loaded compares
top-level names whole, and the reference imports nothing of JAX, the
JAX package or the port."""

import ast
import glob
import os
import subprocess
import sys
import types

import pytest

import tiny
from harness import run_cell


@pytest.mark.parametrize("name,bad", [
    ("infinistore_tpu_torch.serving", False),
    ("infinistore_tpu_torchx", False),
    ("infinistore_tpu", True),
    ("infinistore_tpu.models.llama", True),
    ("jax", True),
    ("jax.numpy", True),
    ("jaxlib.xla_client", True),
    ("flax.linen", True),
    ("jaxtyping", False),
])
def test_top_level_names_compared_whole(monkeypatch, name, bad):
    for mod in [m for m in sys.modules
                if m.split(".")[0] in run_cell.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, mod)
    assert run_cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bool(run_cell.forbidden_modules()) == bad
    if bad:
        with pytest.raises(run_cell.ForbiddenModule):
            run_cell._check_modules("now")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(tiny.ROOT, "reference", "*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "flax", "infinistore_tpu",
                "infinistore_tpu_torch", "harness"), (path, name)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference.plain; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % tiny.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"jax", "jaxlib", "flax", "infinistore_tpu",
                         "infinistore_tpu_torch"}


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, time
sys.path[:0] = [{tiny.HERE!r}, {tiny.ROOT!r}, {tiny.REPO!r}]
import tiny
from harness import run_cell
root, bench = tiny.make_root({str(tmp_path)!r})
run_cell.run("tiny.sessions", 3, 1.0, False, "cpu", time.perf_counter(),
             bench=bench, root=root)
print(run_cell.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"

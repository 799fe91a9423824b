"""The port stands alone: it imports no JAX, no ml_dtypes and nothing of
the JAX package, and its entry points never drop to the CPU on their
own."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "infinistore_tpu_torch")
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "infinistore_tpu")


def test_port_imports_and_runs_with_jax_blocked():
    """In a fresh interpreter (this one has JAX loaded already), block
    the JAX world with a meta-path finder, import every module of the
    port and run a tiny CPU forward and decode step."""
    script = textwrap.dedent(f"""
        import importlib.abc, sys
        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import torch
        import infinistore_tpu_torch
        import infinistore_tpu_torch.server, infinistore_tpu_torch.cluster
        from infinistore_tpu_torch import cuda
        from infinistore_tpu_torch.example import demo_prefill
        from infinistore_tpu_torch.models import llama
        cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=1,
                                n_heads=2, n_kv_heads=1, d_ff=64,
                                page_size=4, dtype="float32")
        p = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        tok = torch.arange(6)[None] % cfg.vocab_size
        logits, kvs = llama.prefill(p, cfg, tok)
        assert logits.shape == (1, 6, 64)
        kp = torch.zeros(1, 4, *cfg.kv_page_shape())
        table = torch.arange(4, dtype=torch.int32)[None]
        lg, _, _ = llama.decode_step(p, cfg, tok[:, 0], torch.tensor(
            [5], dtype=torch.int32), kp, kp.clone(), table)
        assert torch.isfinite(lg).all()
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ISOLATED_OK")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ISOLATED_OK" in r.stdout


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in BLOCKED:
                    offenders.append(f"{path}: {n}")
    assert not offenders, offenders


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from infinistore_tpu_torch import cuda
    from infinistore_tpu_torch.example import demo_prefill
    from infinistore_tpu_torch.models import llama

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda.CudaKVStore(conn=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo_prefill.run("127.0.0.1", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.params_from_jax({"embed": [[0.0]]}, device="cuda")

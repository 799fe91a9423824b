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
# The card's machine has no transformers: the HF bridge must not need it.
BLOCKED_WITH_HF = BLOCKED + ("transformers",)


def test_port_imports_and_runs_with_jax_blocked():
    """In a fresh interpreter (this one has JAX loaded already), block
    the JAX world with a meta-path finder, import every module of the
    port and run a tiny CPU forward, decode step and training step, of
    the Llama family and of the MoE family; transformers is blocked too
    (the HF bridge takes a config namespace and a state dict). The store
    surface (sharded client, warmup, benchmark, profiling, example
    clients) imports too, and routes a key as the static hash says; so do
    the parallel modules (mesh, launch, transport, ring attention, the
    pipeline, expert parallelism, the pool), checkpoints and the relay,
    and graft_entry's decode step runs."""
    script = textwrap.dedent(f"""
        import importlib.abc, sys, types
        BLOCKED = {BLOCKED_WITH_HF!r}

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
        from infinistore_tpu_torch.example import demo_prefill, serve
        from infinistore_tpu_torch.models import llama
        from infinistore_tpu_torch import serving, serving_http
        from infinistore_tpu_torch.ops import kv_quant, paged_flash_decode_q
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
        opt = llama.adamw(p, 1e-3)
        loss = llama.train_step(p, opt, cfg, tok)
        assert torch.isfinite(loss) and p["layers"][0]["wq"].grad is not None
        eng = serving.ServingEngine(p, cfg, serving.ServingConfig(
            max_slots=2, total_pages=8, spec_k=2), device="cpu")
        out = eng.run([serving.Request("r", [1, 2, 3, 1, 2], 4)])
        assert len(out["r"]) == 4
        qp = llama.quantize_params(p, cfg)
        lq, _ = llama.prefill(qp, cfg, tok)
        assert torch.isfinite(lq).all()
        kq, ks = kv_quant.quantize_kv_pages(
            torch.randn(4, *cfg.kv_page_shape()))
        att = paged_flash_decode_q.decode_attention_quantized(
            torch.randn(1, cfg.n_heads, cfg.head_dim), kq, ks, kq, ks,
            table, torch.tensor([5], dtype=torch.int32))
        assert torch.isfinite(att).all()
        from infinistore_tpu_torch.models import hf, moe
        mcfg = moe.MoEConfig(vocab_size=64, d_model=32, n_layers=1,
                             n_heads=2, n_kv_heads=1, d_ff=32, n_experts=4,
                             page_size=4, dtype="float32")
        mp = moe.init_params(torch.Generator().manual_seed(1), mcfg, "cpu")
        ml, _, aux = moe.forward_dense(mp, mcfg, tok)
        assert ml.shape == (1, 6, 64) and torch.isfinite(aux)
        mg, _, _ = moe.decode_step(mp, mcfg, tok[:, 0], torch.tensor(
            [5], dtype=torch.int32), kp, kp.clone(), table)
        assert torch.isfinite(mg).all()
        mopt = llama.adamw(mp, 1e-3)
        mloss = moe.train_step(mp, mopt, mcfg, tok)
        assert torch.isfinite(mloss)
        assert mp["layers"][0]["router"].grad is not None
        hcfg = types.SimpleNamespace(
            vocab_size=64, hidden_size=32, intermediate_size=32,
            num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=1, num_local_experts=4,
            num_experts_per_tok=2, rope_theta=1e4,
            max_position_embeddings=64, rms_norm_eps=1e-5,
            sliding_window=None, hidden_act="silu")
        assert hf.moe_config_from_hf(hcfg).capacity_factor == 2.0
        import zlib
        from infinistore_tpu_torch import benchmark, sharded, warmup
        from infinistore_tpu_torch.utils import profiling, profile_window
        from infinistore_tpu_torch.example import client, client_async
        assert sharded._shard_of("k", 3) == zlib.crc32(b"k") % 3
        with profile_window() as w:
            pass
        assert not w.op_deltas
        from infinistore_tpu_torch import graft_entry
        from infinistore_tpu_torch.parallel import launch, mesh
        fn, args = graft_entry.entry("cpu")
        assert fn(*args).shape == (2, 256)
        assert mesh.param_sharding_rules()["wo"][1].dim == 0
        from infinistore_tpu_torch.ops import ring_attention
        from infinistore_tpu_torch.parallel import (ici_handoff, pipeline,
                                                    transport)
        from infinistore_tpu_torch.utils import checkpoint, netshaper
        assert pipeline.n_ticks(4, 8) == 11
        assert moe.param_shardings(None, mp)["layers"][0]["e_up"][1].dim == 0
        out, lse = ring_attention._block(
            torch.randn(1, 4, 2, 8), torch.randn(1, 4, 1, 8),
            torch.randn(1, 4, 1, 8), True)
        assert out.shape == (1, 4, 2, 8) and lse.shape == (1, 2, 4)
        assert checkpoint.latest_step("/nonexistent") is None
        relay = netshaper.ShapingRelay(1, rtt_ms=1.0)
        relay.start()
        relay.stop()
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
    paths = list(_sources())
    for mod in ("serving.py", "serving_http.py", "example/serve.py",
                "ops/paged_flash_verify.py", "ops/flash_attention.py",
                "ops/kv_quant.py", "ops/paged_flash_decode_q.py",
                "models/llama.py", "models/moe.py", "models/hf.py",
                "sharded.py", "warmup.py", "benchmark.py",
                "utils/profiling.py", "example/client.py",
                "example/client_async.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/launch.py", "graft_entry.py",
                "parallel/transport.py", "parallel/pipeline.py",
                "parallel/ici_handoff.py", "ops/ring_attention.py",
                "utils/checkpoint.py", "utils/netshaper.py"):
        assert os.path.join(PKG, mod) in paths, mod
    for path in paths:
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
                if n.split(".")[0] in BLOCKED_WITH_HF:
                    offenders.append(f"{path}: {n}")
    assert not offenders, offenders


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from infinistore_tpu_torch import cuda, graft_entry, serving
    from infinistore_tpu_torch.parallel import mesh
    from infinistore_tpu_torch.example import demo_prefill, serve
    from infinistore_tpu_torch.models import hf, llama, moe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda.CudaKVStore(conn=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo_prefill.run("127.0.0.1", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.params_from_jax({"embed": [[0.0]]})
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params_quantized(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ServingEngine({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run("127.0.0.1", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.init_params(torch.Generator(), moe.MoEConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        hf.params_from_hf({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        hf.moe_params_from_hf({}, moe.MoEConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_process_group(0, 1, 1)


def test_parallel_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The sp, pp, ep and pool meshes and a checkpoint restored without a
    template default to the card: without one they raise, on a joined
    one-rank CPU group, rather than fall back to the CPU."""
    from infinistore_tpu_torch.models import llama, moe
    from infinistore_tpu_torch.ops.ring_attention import make_sp_mesh
    from infinistore_tpu_torch.parallel import mesh
    from infinistore_tpu_torch.parallel.ici_handoff import make_pool_mesh
    from infinistore_tpu_torch.parallel.launch import free_port
    from infinistore_tpu_torch.parallel.pipeline import make_pp_mesh
    from infinistore_tpu_torch.utils import (restore_train_state,
                                             save_train_state)

    cfg = llama.LlamaConfig(vocab_size=16, d_model=8, n_layers=1,
                            n_heads=1, n_kv_heads=1, d_ff=8,
                            dtype="float32")
    p = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    save_train_state(tmp_path, 1, p, llama.adamw(p, 1e-3))
    mesh.init_process_group(0, 1, free_port(), device="cpu")
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (make_sp_mesh, make_pp_mesh, make_pool_mesh,
                     lambda: moe.make_ep_mesh(1, 1)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
        with pytest.raises(RuntimeError, match="CUDA"):
            restore_train_state(tmp_path)
    finally:
        torch.distributed.destroy_process_group()


def test_int8_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: K4's wrapper takes CUDA tensors only, and its
    dispatcher refuses devices that are neither CPU nor CUDA."""
    from infinistore_tpu_torch.ops import paged_flash_decode_q as pq

    i8 = torch.zeros(4, 8, 2, 32, dtype=torch.int8)
    sc = torch.ones(4, 8, 2)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pq.paged_flash_decode_quantized(torch.zeros(1, 2, 32), i8, sc, i8,
                                        sc, table, lens)
    launches = pq.launches
    with pytest.raises(ValueError, match="unsupported device"):
        pq.decode_attention_quantized(torch.empty(1, 2, 32, device="meta"),
                                      i8, sc, i8, sc, table, lens)
    assert pq.launches == launches

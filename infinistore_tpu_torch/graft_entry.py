"""Entry points of the port: one decode step, and the multi-rank dry run.

The counterpart of the repository's ``__graft_entry__.py``. ``entry()``
returns the tiny config's paged decode step and its arguments, on the
card unless ``device="cpu"``. ``dryrun_multichip(n, device)`` spawns n
ranks over a (dp, tp) mesh and runs the legs the port has so far: one
training step Megatron-sharded over tp with dp-sharded tokens, the same
step under FSDP, and the paged decode at one kv head per rank against
its single-device result. It prints the JAX dry run's fields for those
legs, in its format.

    python -m infinistore_tpu_torch.graft_entry [--device cpu] [--ranks N]
        [--backend gloo]
"""

import argparse

import numpy as np
import torch

from .models import llama


def tiny_cfg():
    """The dry run's config (``__graft_entry__._tiny_cfg``)."""
    return llama.LlamaConfig(vocab_size=256, d_model=128, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=256, max_seq=64,
                             page_size=8)


def entry(device="cuda"):
    """(fn, example_args): one paged-KV decode step of the tiny config."""
    cfg = tiny_cfg()
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(gen, cfg, device)
    dev = params["embed"].device
    batch, n_pages, max_pages = 2, 16, 4
    kv_shape = (cfg.n_layers, n_pages, *cfg.kv_page_shape())
    k_pages = torch.zeros(kv_shape, dtype=cfg.torch_dtype, device=dev)
    v_pages = torch.zeros_like(k_pages)
    page_table = torch.arange(batch * max_pages, dtype=torch.int32,
                              device=dev).reshape(batch, max_pages)
    token = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    seq_lens = torch.tensor([5, 11], dtype=torch.int32, device=dev)

    def fn(params, token, seq_lens, k_pages, v_pages, page_table):
        logits, _, _ = llama.decode_step(params, cfg, token, seq_lens,
                                         k_pages, v_pages, page_table)
        return logits

    return fn, (params, token, seq_lens, k_pages, v_pages, page_table)


def _dryrun_rank(rank, dev, world, backend, params):
    """One rank of the dry run. ``params``: a numpy tree of the whole
    tiny model (the JAX package's, say), or None for seeded weights."""
    import torch.distributed as dist

    from .ops.paged_attention import paged_decode_attention
    from .ops.paged_flash_decode import decode_attention
    from .parallel import mesh as pmesh

    dp = 2 if world % 2 == 0 else 1
    tp = world // dp
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=dp, tp=tp), dev.type,
                           backend=backend)
    ctx = pmesh.TensorParallel(mesh)
    cfg = tiny_cfg()
    if params is None:
        full = llama.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, dev)
    else:
        full = llama.params_from_jax(params, dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2 * dp, 32), dtype=np.int32)).to(dev)
    rows = pmesh.local_shard(mesh, tokens, pmesh.data_sharding(mesh))

    def step(shardings):
        sharded = pmesh.shard_params(mesh, full, shardings)
        opt = llama.adamw(sharded, 1e-3)
        return float(llama.train_step(sharded, opt, cfg, rows, tp=ctx))

    loss = step(pmesh.param_shardings(mesh, full))
    # FSDP: the same step with every weight matrix 1/dp per rank too;
    # identical math, other placement.
    fsdp_err = abs(step(pmesh.fsdp_param_shardings(mesh, full)) - loss)

    # The paged decode kernel under tp, one kv head per rank: each rank
    # launches it on its own head's q and pages (as each device of the
    # JAX wrapper's shard_map does), and the gathered heads are held to
    # the single-device plain version.
    rng = np.random.default_rng(1)

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    q, k, v = draw(2, 2 * world, 64), draw(9, 8, world, 64), \
        draw(9, 8, world, 64)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    lens = torch.tensor([9, 13], dtype=torch.int32, device=dev)
    local = decode_attention(q[:, 2 * rank:2 * rank + 2].contiguous(),
                             k[:, :, rank:rank + 1].contiguous(),
                             v[:, :, rank:rank + 1].contiguous(), table, lens)
    heads = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(heads, local)
    ref = paged_decode_attention(q, k, v, table, lens)
    tp_err = float((torch.cat(heads, dim=1) - ref).abs().max())
    return {"dp": dp, "tp": tp, "loss": loss, "fsdp_err": fsdp_err,
            "tp_decode_ways": world, "tp_decode_err": tp_err}


def dryrun_multichip(n_devices, device="cuda", backend=None, params=None):
    """Spawn ``n_devices`` ranks on a (dp=2, tp=n/2) mesh (dp=1 for odd
    n), run the dry run's legs, check them (a finite loss, FSDP within
    1e-3 of it, the tp decode within 1e-4 of the single-device one),
    print the result line and return rank 0's readings with it.
    ``device``/``backend`` as ``parallel.mesh.init_process_group`` takes
    them (ranks sharing one card ask for gloo); ``params`` a numpy tree
    of the whole tiny model, or None for seeded weights."""
    from .parallel.launch import run_ranks

    r = run_ranks(_dryrun_rank, n_devices, (n_devices, backend, params),
                  device=device, backend=backend)[0]
    if not np.isfinite(r["loss"]):
        raise RuntimeError(f"non-finite loss: {r['loss']}")
    if r["fsdp_err"] >= 1e-3:
        raise RuntimeError(f"fsdp loss mismatch: {r['fsdp_err']}")
    if r["tp_decode_err"] >= 1e-4:
        raise RuntimeError(f"tp decode mismatch: {r['tp_decode_err']}")
    r["line"] = (
        f"dryrun_multichip ok: mesh dp={r['dp']} tp={r['tp']}, "
        f"loss={r['loss']:.4f}, fsdp_err={r['fsdp_err']:.1e}, "
        f"tp_pallas_decode={r['tp_decode_ways']}way "
        f"err={r['tp_decode_err']:.1e}")
    print(r["line"])
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
    dryrun_multichip(a.ranks, a.device, a.backend)


if __name__ == "__main__":
    main()

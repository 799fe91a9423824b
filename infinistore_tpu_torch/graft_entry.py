"""Entry points of the port: one decode step, and the multi-rank dry run.

The counterpart of the repository's ``__graft_entry__.py``. ``entry()``
returns the tiny config's paged decode step and its arguments, on the
card unless ``device="cpu"``. ``dryrun_multichip(n, device)`` spawns n
ranks and runs every leg of the JAX dry run: a training step
Megatron-sharded over tp with dp-sharded tokens and the same under FSDP,
ring attention over sp, the device KV pool's handoff, an MoE step under
expert parallelism, the GPipe pipeline, the pool's tiering over a port
store server, and the paged decode at one kv head per rank. It prints
the JAX dry run's result line, field for field.

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


def _dryrun_rank(rank, dev, world, backend, weights, store_port):
    """One rank of the dry run. ``weights``: numpy trees of the JAX dry
    run's weights ({"llama", "moe", "pp_stages", "pp_x"}, any of them),
    the rest seeded; ``store_port``: the port server of the tiering
    leg."""
    import torch.distributed as dist

    from . import ClientConfig, InfinityConnection
    from .cuda import CudaKVStore
    from .models import moe
    from .ops.paged_attention import paged_decode_attention, \
        prefill_attention
    from .ops.paged_flash_decode import decode_attention
    from .ops.ring_attention import make_sp_mesh, ring_attention_global
    from .parallel import mesh as pmesh
    from .parallel.ici_handoff import IciKVPool, make_pool_mesh
    from .parallel.pipeline import make_pp_mesh, pipeline_apply, \
        stack_stage_params, stage_shardings

    weights = weights or {}
    dp = 2 if world % 2 == 0 else 1
    tp = world // dp
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=dp, tp=tp), dev.type,
                           backend=backend)
    ctx = pmesh.TensorParallel(mesh)
    cfg = tiny_cfg()
    if weights.get("llama") is None:
        full = llama.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, dev)
    else:
        full = llama.params_from_jax(weights["llama"], dev)
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

    # Inputs drawn in the JAX dry run's order from one generator.
    rng = np.random.default_rng(1)

    def draw(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)

    # Sequence parallelism: the ring over every rank against dense
    # attention.
    sq = 8 * world
    q, k, v = draw(2, sq, 4, 32), draw(2, sq, 4, 32), draw(2, sq, 4, 32)
    ring = ring_attention_global(q, k, v, make_sp_mesh(world, dev.type,
                                                       backend))
    sp_err = float((ring - prefill_attention(q, k, v, causal=True))
                   .abs().max())

    # The device KV pool: 2 pages on each prefill rank handed to the
    # decode half, bit-exact (on one rank the move stays put).
    page = (cfg.page_size, cfg.n_kv_heads, cfg.head_dim)
    pool = IciKVPool(make_pool_mesh(world, dev.type, backend), page,
                     cfg.torch_dtype, slots_per_device=8)
    n_prefill = max(1, world // 2)
    n_decode = max(1, world - n_prefill)
    hand_keys, hand_pages = [], []
    for d in range(n_prefill):
        pg = draw(2, *page, dtype=cfg.torch_dtype)
        ks = [f"pod_seq{d}_pg{i}" for i in range(2)]
        pool.put(ks, pg, device=d)
        hand_keys += ks
        hand_pages.append(pg)
    moves = {key: min(world - 1, n_prefill + (i % n_decode))
             for i, key in enumerate(hand_keys)}
    pool.handoff(moves)
    ok = (pool.match_last_index(hand_keys) == len(hand_keys) - 1
          and all(pool.device_of(key) == moves[key] for key in hand_keys)
          and torch.equal(pool.get(hand_keys), torch.cat(hand_pages)))
    if not ok:
        raise RuntimeError("pool handoff corrupted its pages")

    # Expert parallelism: one MoE training step on a (dp, ep) mesh.
    ep = max(1, world // dp)
    moe_cfg = moe.MoEConfig(vocab_size=256, d_model=64, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=128, n_experts=ep,
                            top_k=min(2, ep), max_seq=64, page_size=8)
    moe_mesh = moe.make_ep_mesh(dp, ep, dev.type, backend)
    moe_full = (moe.init_params(torch.Generator(device=dev).manual_seed(1),
                                moe_cfg, dev)
                if weights.get("moe") is None
                else llama.params_from_jax(weights["moe"], dev))
    moe_params = moe.shard_params(moe_mesh, moe_full)
    moe_tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, moe_cfg.vocab_size, (2 * dp, 32), dtype=np.int32)).to(dev)
    moe_loss = float(moe.train_step(
        moe_params, llama.adamw(moe_params, 1e-3), moe_cfg,
        pmesh.local_shard(moe_mesh, moe_tokens, pmesh.data_sharding(
            moe_mesh)), ep=moe.ExpertParallel(moe_mesh)))

    # Pipeline parallelism: S = world stages of tanh(x @ w) against the
    # stages applied in turn.
    def pp_stage(p, x):
        return torch.tanh(x @ p["w"])

    d_pp = 16
    if weights.get("pp_stages") is None:
        g = torch.Generator(device=dev).manual_seed(3)
        stages = [{"w": torch.randn(d_pp, d_pp, generator=g, device=dev)
                   / np.sqrt(d_pp)} for _ in range(world)]
        x_micro = torch.randn(2 * world, 2, d_pp, generator=g, device=dev)
    else:
        stages = [{"w": torch.from_numpy(w).to(dev)}
                  for w in weights["pp_stages"]]
        x_micro = torch.from_numpy(weights["pp_x"]).to(dev)
    pp_mesh = make_pp_mesh(world, dev.type, backend)
    stacked = stack_stage_params(stages)
    stacked = pmesh.tree_map(
        lambda _, t, pl: pmesh.distribute(pp_mesh, t, pl), stacked,
        stage_shardings(stacked))
    pp_out = pipeline_apply(pp_stage, stacked, x_micro, pp_mesh)
    ref = x_micro
    for st in stages:
        ref = pp_stage(st, ref)
    pp_err = float((pp_out - ref).abs().max())

    # Store <-> pool tiering: pages only in the host store are fetched
    # on a pool miss, handed off and read back bit-exact; eviction
    # spills them back to the store.
    tier_pages = draw(2, *page, dtype=cfg.torch_dtype)
    tier_keys = [f"tier_pg{i}" for i in range(2)]
    conn = InfinityConnection(ClientConfig(host_addr="127.0.0.1",
                                           service_port=store_port))
    conn.connect()
    store = CudaKVStore(conn, dev)
    try:
        if rank == 0:
            store.put_kv_pages(tier_keys, tier_pages, sync=True)
        dist.barrier()
        ok = (pool.match_last_index(tier_keys) == -1
              and pool.fetch_from_store(store, tier_keys, device=0) == 2)
        pool.handoff({key: world - 1 for key in tier_keys})
        ok = ok and torch.equal(pool.get(tier_keys), tier_pages)
        ok = ok and pool.evict_to_store(store, tier_keys) == 2
        ok = ok and torch.equal(
            store.get_kv_pages(tier_keys, page, cfg.torch_dtype), tier_pages)
    finally:
        store.close()
        conn.close()
    if not ok:
        raise RuntimeError("store <-> pool tiering failed")

    # The paged decode kernel under tp, one kv head per rank: each rank
    # launches it on its own head's q and pages (as each device of the
    # JAX wrapper's shard_map does), and the gathered heads are held to
    # the single-device plain version.
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
            "sp": world, "sp_err": sp_err, "moe_ep": ep,
            "moe_loss": moe_loss, "pp": world, "pp_err": pp_err,
            "handoff_pages": len(hand_keys), "n_prefill": n_prefill,
            "tp_decode_ways": world, "tp_decode_err": tp_err}


def dryrun_multichip(n_devices, device="cuda", backend=None, weights=None):
    """Spawn ``n_devices`` ranks and run the JAX dry run's legs
    (``__graft_entry__._dryrun_multichip_cpu``): one training step on a
    (dp=2, tp=n/2) mesh (dp=1 for odd n) and the same under FSDP, the
    ring over sp = n, the pool's handoff from the prefill half to the
    decode half, an MoE step at ep = n/dp, the pipeline over pp = n, the
    pool's tiering over a port server, and the paged decode at one kv
    head per rank. Checks them as the JAX dry run does (finite losses,
    FSDP within 1e-3, ring, pipeline and tp decode within 1e-4, pages
    bit-exact), prints the JAX result line and returns rank 0's
    readings with it. ``device``/``backend`` as
    ``parallel.mesh.init_process_group`` takes them (ranks sharing one
    card ask for gloo); ``weights`` as :func:`_dryrun_rank` takes them."""
    from . import InfiniStoreServer, ServerConfig
    from .parallel.launch import run_ranks

    srv = InfiniStoreServer(ServerConfig(service_port=0,
                                         prealloc_size=0.0625,
                                         minimal_allocate_size=16))
    port = srv.start()
    try:
        r = run_ranks(_dryrun_rank, n_devices,
                      (n_devices, backend, weights, port), device=device,
                      backend=backend)[0]
    finally:
        srv.stop()
    for name in ("loss", "moe_loss"):
        if not np.isfinite(r[name]):
            raise RuntimeError(f"non-finite {name}: {r[name]}")
    for name, tol in (("fsdp_err", 1e-3), ("sp_err", 1e-4),
                      ("pp_err", 1e-4), ("tp_decode_err", 1e-4)):
        if not r[name] < tol:
            raise RuntimeError(f"{name} {r[name]} not below {tol}")
    r["line"] = (
        f"dryrun_multichip ok: mesh dp={r['dp']} tp={r['tp']}, "
        f"loss={r['loss']:.4f}, fsdp_err={r['fsdp_err']:.1e}, "
        f"sp={r['sp']} ring_err={r['sp_err']:.1e}, "
        f"moe ep={r['moe_ep']} loss={r['moe_loss']:.4f}, "
        f"pp={r['pp']} err={r['pp_err']:.1e}, "
        f"ici_handoff={r['handoff_pages']} pages x {r['n_prefill']}->"
        f"{n_devices - r['n_prefill']} devs bit-exact, "
        f"tiering miss->fetch->handoff->evict ok, "
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

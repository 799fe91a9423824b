"""Rank functions of the port's sequence, pipeline, expert-parallel, pool
and checkpoint tests (test_torch_ring_attention.py,
test_torch_pipeline.py, test_torch_ep.py, test_torch_moe_ep_serving.py,
test_torch_ici_pool.py, test_torch_checkpoint.py), spawned on the CPU over gloo by
``infinistore_tpu_torch.parallel.launch.run_ranks``.

Kept apart from the test files so that a spawned rank imports only torch
and the port, not JAX. Every function takes (rank, device, ...) and
returns picklable numpy results, from rank 0 unless noted.
:func:`pool_scenarios` is shared: the JAX pool runs it in the test
process and the port's on the ranks, so both record the same steps."""

import numpy as np
import torch
import torch.distributed as dist

from infinistore_tpu_torch import ClientConfig, InfinityConnection, TYPE_SHM
from infinistore_tpu_torch.cuda import CudaKVStore
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.models import moe as tmoe
from infinistore_tpu_torch.ops.ring_attention import ring_attention_global
from infinistore_tpu_torch.parallel import mesh as pmesh
from infinistore_tpu_torch.parallel import pipeline as tpp
from infinistore_tpu_torch.parallel import transport
from infinistore_tpu_torch.parallel.ici_handoff import (IciKVPool,
                                                        make_pool_mesh)
from infinistore_tpu_torch.utils import restore_train_state, save_train_state

from torch_tp_ranks import (flat_leaves, model_steps, serve_legs,
                            tree_map_numpy, tree_to_torch)


def _groups(sizes):
    """{n: the group of ranks 0..n-1} (every rank creates every group)."""
    world = dist.get_world_size()
    return {n: (dist.group.WORLD if n == world
                else dist.new_group(list(range(n)))) for n in sizes}


# -- ring attention ---------------------------------------------------------

def ring_cases(rank, dev, cases, odd_seq):
    """Each case (name, n, causal, q, k, v) runs the ring over ranks
    0..n-1 on the whole arrays; rank 0 returns {name: output}, and
    whether a sequence of ``odd_seq`` tokens raised ValueError."""
    groups = _groups({c[1] for c in cases})
    out = {}
    for name, n, causal, q, k, v in cases:
        if rank < n:
            out[name] = ring_attention_global(
                *(torch.from_numpy(a) for a in (q, k, v)), groups[n],
                causal=causal).numpy()
        dist.barrier()
    q = torch.zeros(1, odd_seq, 2, 8)
    try:
        ring_attention_global(q, q, q)
        out["odd_raises"] = False
    except ValueError:
        out["odd_raises"] = True
    return out if rank == 0 else None


# -- the pipeline -----------------------------------------------------------

def _pp_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_cases(rank, dev, cases):
    """Each case (name, S, stages {"w", "b"} stacked [S, ...], x, grad)
    runs ``pipeline_apply`` over ranks 0..S-1 with tanh(x @ w + b)
    stages; with ``grad`` the loss sum(out ** 2) is differentiated and
    the stacked grads, summed over the group, come back too. Rank 0
    returns {name: (out, grads or None, exchanges on rank 0)}."""
    groups = _groups({c[1] for c in cases})
    out = {}
    for name, n, stages, x, grad in cases:
        if rank < n:
            st = {k: torch.from_numpy(v).requires_grad_(grad)
                  for k, v in stages.items()}
            transport.reset_counters()
            y = tpp.pipeline_apply(_pp_stage, st, torch.from_numpy(x),
                                   groups[n])
            grads = None
            if grad:
                (y ** 2).sum().backward()
                grads = {}
                for k, t in st.items():
                    g = t.grad.clone()
                    dist.all_reduce(g, group=groups[n])
                    grads[k] = g.numpy()
            out[name] = (y.detach().numpy(), grads,
                         transport.counters["exchanges"])
        dist.barrier()
    return out if rank == 0 else None


# -- expert parallelism -----------------------------------------------------

def ep_step(rank, dev, dp, ep, cfg, tree, tokens):
    """One MoE AdamW step on a (dp, ep) mesh from the whole numpy
    ``tree``: rank 0 returns the loss, every leaf's whole grad, and the
    local shape and placements of layer 0's expert leaves."""
    mesh = tmoe.make_ep_mesh(dp, ep, "cpu")
    ctx = tmoe.ExpertParallel(mesh)
    sharded = tmoe.shard_params(mesh, tree_to_torch(tree))
    opt = tl.adamw(sharded, 1e-3)
    rows = pmesh.local_shard(mesh, torch.from_numpy(tokens),
                             pmesh.data_sharding(mesh))
    loss = float(tmoe.train_step(sharded, opt, cfg, rows, ep=ctx))
    grads = pmesh.tree_map(
        lambda _, p: pmesh.full_tensor(p.grad).numpy(), sharded)
    layer = sharded["layers"][0]
    local = {name: (tuple(layer[name].to_local().shape),
                    [getattr(p, "dim", None)
                     for p in layer[name].placements])
             for name in ("e_gate", "e_up", "e_down", "router", "wq")}
    return {"loss": loss, "grads": grads, "local": local} if rank == 0 \
        else None


def ep_serve_cases(rank, dev, ep, cfg, engine_cfg, tree, inputs, modes,
                   reqs, offload_port, hit_port, hit_reqs):
    """The MoE at ep on a (1, ep) mesh from the whole numpy tree: its
    model steps under ``cfg`` on ``inputs`` (``torch_tp_ranks.
    model_steps``, every rank holding every kv head) and the ep engine's
    legs under ``engine_cfg`` (``torch_tp_ranks.serve_legs``: store-less
    ``modes``, an offload into an empty store, hits on pages a
    single-process engine wrote). Every rank returns (steps, legs)."""
    mesh = tmoe.make_ep_mesh(1, ep, "cpu")
    ctx = tmoe.ExpertParallel(mesh)
    shards = tmoe.shard_params(mesh, tree_to_torch(tree))
    steps = model_steps(tmoe, shards, cfg, inputs, ep=ctx)
    legs = serve_legs(shards, engine_cfg, mesh, tmoe, modes, reqs,
                      offload_port, hit_port, hit_reqs)
    return steps, legs


# -- the device KV pool -----------------------------------------------------

def pool_scenarios(make_pool, to_pages, to_numpy, rounds):
    """The cases of ``tests/test_ici_handoff.py`` (but the store's) at 4
    devices (prefill 0-1, decode 2-3), through any pool with the JAX
    pool's surface: ``make_pool(slots)`` builds one, ``to_pages`` turns
    a numpy array into its pages, ``to_numpy`` its pages back,
    ``rounds(pool)`` counts its handoff rounds. Returns [(case, step,
    value)]: pages, directories, free slots and the errors raised."""
    rec = []
    page = (8, 16)

    def pages(rng, n):
        return rng.standard_normal((n, *page)).astype(np.float32)

    def get(pool, keys):
        return to_numpy(pool.get(keys))

    def raises(fn):
        try:
            fn()
        except MemoryError:
            return "MemoryError"
        return None

    # put/get round trip on one device
    pool, rng = make_pool(8), np.random.default_rng(0)
    pg = pages(rng, 4)
    keys = [f"p{i}" for i in range(4)]
    pool.put(keys, to_pages(pg), device=0)
    rec += [("roundtrip", "pages", get(pool, keys)),
            ("roundtrip", "devices", [pool.device_of(k) for k in keys]),
            ("roundtrip", "sent", pg)]

    # prefill half -> decode half, bit-exact
    pool, rng = make_pool(8), np.random.default_rng(1)
    keys, originals = [], []
    for dev in range(2):
        pg = pages(rng, 3)
        ks = [f"seq{dev}_pg{i}" for i in range(3)]
        pool.put(ks, to_pages(pg), device=dev)
        keys += ks
        originals.append(pg)
    moves = {k: 2 + (i % 2) for i, k in enumerate(keys)}
    pool.handoff(moves)
    rec += [("handoff", "devices", [pool.device_of(k) for k in keys]),
            ("handoff", "pages", get(pool, keys)),
            ("handoff", "sent", np.concatenate(originals)),
            ("handoff", "free", [pool.free_slots(d) for d in range(4)]),
            ("handoff", "directory", dict(pool.directory)),
            ("handoff", "rounds", rounds(pool))]

    # two sources into one destination: two rounds
    pool, rng = make_pool(8), np.random.default_rng(2)
    pa, pb = pages(rng, 2), pages(rng, 2)
    pool.put(["a0", "a1"], to_pages(pa), device=0)
    pool.put(["b0", "b1"], to_pages(pb), device=1)
    pool.handoff({"a0": 3, "a1": 3, "b0": 3, "b1": 3})
    rec += [("one_destination", "pages", get(pool, ["a0", "a1", "b0",
                                                     "b1"])),
            ("one_destination", "sent", np.concatenate([pa, pb])),
            ("one_destination", "devices",
             [pool.device_of(k) for k in ["a0", "a1", "b0", "b1"]]),
            ("one_destination", "free", pool.free_slots(3)),
            ("one_destination", "rounds", rounds(pool))]

    # one source into several destinations
    pool, rng = make_pool(8), np.random.default_rng(3)
    pg = pages(rng, 4)
    keys = [f"m{i}" for i in range(4)]
    pool.put(keys, to_pages(pg), device=1)
    pool.handoff({"m0": 2, "m1": 3, "m2": 0, "m3": 3})
    rec += [("many_destinations", "devices",
             [pool.device_of(k) for k in keys]),
            ("many_destinations", "pages", get(pool, keys)),
            ("many_destinations", "sent", pg),
            ("many_destinations", "rounds", rounds(pool))]

    # pages already on the destination survive the scatter
    pool, rng = make_pool(8), np.random.default_rng(4)
    keep, move = pages(rng, 3), pages(rng, 1)
    pool.put(["keep0", "keep1", "keep2"], to_pages(keep), device=3)
    pool.put(["mv"], to_pages(move), device=0)
    pool.handoff({"mv": 3})
    rec += [("resident", "pages",
             get(pool, ["keep0", "keep1", "keep2", "mv"])),
            ("resident", "sent", np.concatenate([keep, move]))]

    # the store-keyed surface
    pool, rng = make_pool(8), np.random.default_rng(5)
    keys = [f"chain_{i}" for i in range(6)]
    pool.put(keys[:4], to_pages(pages(rng, 4)), device=1)
    first = get(pool, ["chain_0"])
    step = [pool.match_last_index(keys), pool.check_exist("chain_0"),
            pool.check_exist("chain_5")]
    pool.put(["chain_0"], to_pages(pages(rng, 1)), device=2)
    step += [pool.device_of("chain_0"),
             bool(np.array_equal(get(pool, ["chain_0"]), first))]
    pool.drop(keys[:4])
    step += [pool.match_last_index(keys), pool.free_slots(1)]
    rec.append(("surface", "steps", step))

    # capacity errors
    pool, rng = make_pool(2), np.random.default_rng(6)
    pool.put(["x0", "x1"], to_pages(pages(rng, 2)), device=0)
    put_err = raises(lambda: pool.put(["x2"], to_pages(pages(rng, 1)),
                                      device=0))
    pool.put(["y0", "y1"], to_pages(pages(rng, 2)), device=3)
    hand_err = raises(lambda: pool.handoff({"x0": 3}))
    rec.append(("capacity", "errors", [put_err, hand_err]))

    # a steady pairing is one round a handoff
    pool, rng = make_pool(8), np.random.default_rng(7)
    per_round = []
    for i in range(3):
        before = rounds(pool)
        pool.put([f"r{i}"], to_pages(pages(rng, 1)), device=0)
        pool.handoff({f"r{i}": 2})
        per_round.append(rounds(pool) - before)
    rec.append(("steady", "rounds", per_round))
    return rec


def _conn(port):
    conn = InfinityConnection(ClientConfig(host_addr="127.0.0.1",
                                           service_port=port,
                                           connection_type=TYPE_SHM))
    conn.connect()
    return conn


def pool_cases(rank, dev, store_port):
    """:func:`pool_scenarios` on the port's pool over 4 ranks, then the
    store tiering case of ``test_ici_handoff.py`` on the port server at
    ``store_port``. Every rank returns its records (the replicated
    directories must agree)."""
    mesh = make_pool_mesh(dist.get_world_size(), "cpu")
    rec = pool_scenarios(
        lambda slots: IciKVPool(mesh, (8, 16), torch.float32, slots),
        torch.from_numpy, lambda t: t.numpy(), lambda p: p.rounds)
    rec += tiering_case(rank, mesh, store_port, 4, "tier", True)
    rec += failed_eviction(mesh)
    return rec


class _FailingStore:
    def put_kv_pages(self, keys, pages, sync=False):
        raise ConnectionError("store down")


def failed_eviction(mesh):
    """A put that fails on rank 0 (the only writer) raises on every rank
    before the directory changes; rank 0's error is chained."""
    pool = IciKVPool(mesh, (8, 16), torch.float32, 4)
    keys = ["f0", "f1"]
    pool.put(keys, torch.ones(2, 8, 16), device=1)
    before = dict(pool.directory)
    raised = cause_ok = None
    try:
        pool.evict_to_store(_FailingStore(), keys)
    except RuntimeError as e:
        raised = type(e).__name__
        cause_ok = (isinstance(e.__cause__, ConnectionError)
                    if dist.get_rank() == 0 else e.__cause__ is None)
    return [("failed_evict", "raised", raised),
            ("failed_evict", "cause", cause_ok),
            ("failed_evict", "directory_kept", pool.directory == before),
            ("failed_evict", "pages", pool.get(keys).numpy())]


def tiering_case(rank, mesh, store_port, slots, prefix, evict_fresh):
    """``test_ici_handoff.py::test_store_pool_tiering`` (with
    ``evict_fresh``: eviction of fresh keys and their fetch back) or
    ``test_multiprocess_spmd.py``'s flow (eviction of the fetched keys):
    pages held only in the store are fetched on a pool miss onto device
    0, handed to the last device, read back; then evicted and fetched
    again onto device 1."""
    n = dist.get_world_size()
    rng = np.random.default_rng(42)
    page = (8, 16)
    keys = [f"{prefix}_{i}" for i in range(3)]
    pages = rng.standard_normal((3, *page)).astype(np.float32)
    conn = _conn(store_port)
    store = CudaKVStore(conn, "cpu")
    rec = []
    try:
        if rank == 0:
            store.put_kv_pages(keys, torch.from_numpy(pages), sync=True)
        dist.barrier()
        pool = IciKVPool(mesh, page, torch.float32, slots)
        rec.append((prefix, "miss", pool.match_last_index(keys)))
        rec.append((prefix, "fetched",
                    [pool.fetch_from_store(store, keys, device=0),
                     pool.fetch_from_store(store, keys, device=0)]))
        rec.append((prefix, "resident", pool.match_last_index(keys)))
        pool.handoff({k: n - 1 for k in keys})
        rec.append((prefix, "devices", [pool.device_of(k) for k in keys]))
        rec.append((prefix, "pages", pool.get(keys).numpy()))
        rec.append((prefix, "sent", pages))
        if evict_fresh:
            ekeys = [f"{prefix}_evict_{i}" for i in range(3)]
            epages = rng.standard_normal((3, *page)).astype(np.float32)
            pool.put(ekeys, torch.from_numpy(epages), device=n - 2)
        else:
            ekeys, epages = keys, pages
        rec.append((prefix, "evicted", pool.evict_to_store(store, ekeys)))
        rec.append((prefix, "after_evict", [pool.match_last_index(ekeys),
                                             pool.free_slots(n - 2)]))
        back = store.get_kv_pages(ekeys, page, torch.float32).numpy()
        rec.append((prefix, "store_back", back))
        rec.append((prefix, "evict_sent", epages))
        rec.append((prefix, "refetched",
                    pool.fetch_from_store(store, ekeys, device=1)))
        rec.append((prefix, "refetched_pages", pool.get(ekeys).numpy()))
    finally:
        store.close()
        conn.close()
    return rec


def pool_two_process(rank, dev, store_port):
    """``tests/test_multiprocess_spmd.py``'s two-process flow on the port:
    every rank returns its records."""
    mesh = make_pool_mesh(2, "cpu")
    return tiering_case(rank, mesh, store_port, 4, "mp", False)


# -- checkpoints ------------------------------------------------------------

def ckpt_fsdp(rank, dev, cfg, tree, template_tree, tokens, ckpt_dir):
    """dp = 2 FSDP: one step from ``tree``, saved as step 1; then a fresh
    FSDP template (``template_tree``) restored from it. Every rank
    checks its restored shards and moments byte-equal to the saved ones
    and takes one more step from both states. Rank 0 returns the saved
    whole params, both continued losses and the byte checks."""
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=2, tp=1), "cpu")
    ctx = pmesh.TensorParallel(mesh)
    rows = pmesh.local_shard(mesh, torch.from_numpy(tokens),
                             pmesh.data_sharding(mesh))

    def fresh(whole):
        full = tree_to_torch(whole)
        sharded = pmesh.shard_params(mesh, full,
                                     pmesh.fsdp_param_shardings(mesh, full))
        return sharded, tl.adamw(sharded, 1e-3)

    params, opt = fresh(tree)
    tl.train_step(params, opt, cfg, rows, tp=ctx)
    save_train_state(ckpt_dir, 1, params, opt)
    saved = pmesh.tree_map(lambda _, t: pmesh.full_tensor(t).numpy().copy(),
                           params)
    t_params, t_opt = fresh(template_tree)
    step, r_params, r_opt = restore_train_state(
        ckpt_dir, template=(t_params, t_opt))
    same = all(torch.equal(a.to_local(), b.to_local())
               for a, b in zip(tl.param_leaves(params),
                               tl.param_leaves(r_params)))
    moments = all(
        torch.equal(sa[k].to_local() if hasattr(sa[k], "to_local")
                    else sa[k],
                    sb[k].to_local() if hasattr(sb[k], "to_local")
                    else sb[k])
        for sa, sb in zip(opt.state_dict()["state"].values(),
                          r_opt.state_dict()["state"].values())
        for k in sa)
    l1 = float(tl.train_step(params, opt, cfg, rows, tp=ctx))
    l2 = float(tl.train_step(r_params, r_opt, cfg, rows, tp=ctx))
    out = {"step": step, "saved": saved, "shards_equal": same,
           "moments_equal": moments, "losses": (l1, l2),
           "sharded_leaves": sum(
               isinstance(t.placements[0], pmesh.Shard)
               for t in tl.param_leaves(params))}
    return out if rank == 0 else None


__all__ = ["ring_cases", "pipeline_cases", "ep_step", "pool_scenarios",
           "pool_cases", "pool_two_process", "ckpt_fsdp", "flat_leaves",
           "tree_map_numpy"]

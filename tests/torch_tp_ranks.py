"""Rank functions of the port's multi-rank tests (test_torch_mesh.py,
test_torch_tp_train.py, test_torch_tp_serving.py, test_torch_tp_int8.py,
test_torch_moe_tp.py), spawned on the CPU over gloo by
``infinistore_tpu_torch.parallel.launch.run_ranks``.

Kept apart from the test files so that a spawned rank imports only
torch and the port, not JAX. Every function takes (rank, device, ...)
and returns picklable numpy results, from rank 0 unless noted."""

import numpy as np
import torch

from chip_smoke import RoutingCheck
from infinistore_tpu_torch import (ClientConfig, InfinityConnection,
                                   TYPE_SHM)
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.cuda import CudaKVStore
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.models import moe as tmoe
from infinistore_tpu_torch.parallel import mesh as pmesh

FAMILIES = {"llama": tl, "moe": tmoe}


def tree_to_torch(tree):
    """A numpy tree (dicts and lists) -> torch CPU tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def flat_leaves(tree, prefix=""):
    """(dotted name, leaf) of a tree's leaves, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tree_map_numpy(tree, grad=False):
    """A torch tree -> numpy copies of its leaves (or of their grads)."""
    return pmesh.tree_map(
        lambda _, t: (t.grad if grad else t).detach().numpy().copy(), tree)


def mesh_shards(rank, dev, dp, tp, tree):
    """Every rank: its local block of each leaf under the tp and the
    FSDP placements, the placements themselves (per mesh dim, the
    sharded axis or None), and the weights fingerprint of its shards."""
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=dp, tp=tp), "cpu")
    full = tree_to_torch(tree)
    out = {}
    for kind, rule in (("tp", pmesh.param_shardings),
                       ("fsdp", pmesh.fsdp_param_shardings)):
        pl = rule(mesh, full)
        sharded = pmesh.shard_params(mesh, full, pl)
        out[kind] = {
            "placements": pmesh.tree_map(
                lambda _, t, p: [getattr(x, "dim", None) for x in p], full,
                pl),
            "local": pmesh.tree_map(
                lambda _, t: t.to_local().numpy(), sharded),
            "fingerprint": ts.weights_fingerprint(sharded),
        }
    return out


def train_cases(rank, dev, dp, tp, cfg, tree, tokens, cases):
    """One training step per case ("tp" or "fsdp" placements) from the
    same whole weights; rank 0 returns {case: (loss, whole leaf
    grads)}."""
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=dp, tp=tp), "cpu")
    ctx = pmesh.TensorParallel(mesh)
    full = tree_to_torch(tree)
    rows = pmesh.local_shard(mesh, torch.from_numpy(tokens),
                             pmesh.data_sharding(mesh))
    out = {}
    for case in cases:
        rule = (pmesh.fsdp_param_shardings if case == "fsdp"
                else pmesh.param_shardings)
        sharded = pmesh.shard_params(mesh, full, rule(mesh, full))
        opt = tl.adamw(sharded, 1e-3)
        loss = tl.train_step(sharded, opt, cfg, rows, tp=ctx)
        grads = pmesh.tree_map(
            lambda _, p: pmesh.full_tensor(p.grad).numpy(), sharded)
        out[case] = (float(loss), grads)
    return out if rank == 0 else None


class RecordingStore(CudaKVStore):
    """A CudaKVStore that records the keys it puts, in order."""

    def __init__(self, conn, device):
        super().__init__(conn, device=device)
        self.put_keys = []

    def put_kv_pages(self, keys, pages, sync=False):
        self.put_keys.extend(keys)
        return super().put_kv_pages(keys, pages, sync=sync)


def _store(port):
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=port,
        connection_type=TYPE_SHM))
    conn.connect()
    return RecordingStore(conn, "cpu")


def _requests(reqs):
    return [ts.Request(rid, list(p), max_new_tokens=n) for rid, p, n in reqs]


def serve_cases(rank, dev, tp, cfg, tree, modes, reqs, offload_port,
                hit_port, hit_reqs, family="llama"):
    """The tp engine on every rank. Store-less, each of ``modes``
    ({name: ServingConfig kwargs}) serves ``reqs``; then with a store on
    ``offload_port`` (empty) it serves ``reqs`` again (offloading their
    pages); then with a store on ``hit_port`` (pages a single-device
    engine wrote) it serves ``hit_reqs``. Every rank returns its
    outputs, the store legs' stats and put keys (all ranks must agree;
    only tp rank 0 may put), its engine's key namespace, and the share
    of the MoE routing (``family="moe"``) that every rank made alike."""
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=1, tp=tp), "cpu")
    shards = pmesh.shard_params(mesh, tree_to_torch(tree))
    return serve_legs(shards, cfg, mesh, FAMILIES[family], modes, reqs,
                      offload_port, hit_port, hit_reqs)


def replica_serve(rank, dev, kind, cfg, tree, reqs_by_dp):
    """A MoE engine on each dp rank of a (dp, 1) mesh (``kind`` "tp":
    ``parallel.mesh.make_mesh``; "ep": ``moe.make_ep_mesh``), each
    serving its own requests, ``reqs_by_dp[dp rank]``: separate engines
    whose steps need not line up. Every rank returns its outputs."""
    dp = len(reqs_by_dp)
    if kind == "tp":
        mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=dp, tp=1), "cpu")
        shards = pmesh.shard_params(mesh, tree_to_torch(tree))
    else:
        mesh = tmoe.make_ep_mesh(dp, 1, "cpu")
        shards = tmoe.shard_params(mesh, tree_to_torch(tree))
    eng = ts.ServingEngine(shards, cfg, ts.ServingConfig(max_slots=2),
                           model=tmoe, device="cpu", mesh=mesh)
    return eng.run(_requests(reqs_by_dp[mesh.get_local_rank("dp")]))


def serve_legs(shards, cfg, mesh, model, modes, reqs, offload_port,
               hit_port, hit_reqs):
    """serve_cases' legs on any mesh (tp or ep) over ``shards``."""
    out, check = {}, RoutingCheck(torch, tmoe)

    def run(eng, rq):
        with check:
            return eng.run(_requests(rq))

    for name, sc in modes.items():
        out[name] = run(ts.ServingEngine(shards, cfg, ts.ServingConfig(**sc),
                                         model=model, device="cpu",
                                         mesh=mesh), reqs)
    for name, port, rq in (("offload", offload_port, reqs),
                           ("hit", hit_port, hit_reqs)):
        store = _store(port)
        try:
            eng = ts.ServingEngine(
                shards, cfg, ts.ServingConfig(max_slots=2), store=store,
                model=model, device="cpu", mesh=mesh)
            out[name] = {"tokens": run(eng, rq),
                         "stats": dict(eng.stats),
                         "put_keys": list(store.put_keys),
                         "pool_heads": int(eng.k_pages.shape[3]),
                         "namespace": eng._ns}
        finally:
            store.close()
            store.conn.close()
    out["routing_agreement"] = check.agreement()
    out["routed_layers"] = len(check.rows)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kv_numpy(kvs):
    return [(k.numpy(), v.numpy()) for k, v in kvs]


def model_steps(model, params, cfg, inputs, heads=lambda t: t, **kw):
    """The model's prefill, prefill_with_prefix, decode_step and (when
    ``inputs`` has one) verify_step on ``inputs`` (whole numpy arrays;
    ``heads`` cuts the pages and prefixes to what this rank holds), as
    numpy: {step: (logits, KV or pages)}. ``kw``: the mesh argument."""
    out = {}
    with torch.no_grad():
        logits, kvs = model.prefill(params, cfg, _t(inputs["tokens"]), **kw)
        out["prefill"] = (logits.numpy(), _kv_numpy(kvs))
        prefix = [(heads(_t(k)), heads(_t(v))) for k, v in inputs["prefix"]]
        logits, kvs = model.prefill_with_prefix(
            params, cfg, _t(inputs["suffix"]), prefix, pos0=0, **kw)
        out["prefix"] = (logits.numpy(), _kv_numpy(kvs))
        kp, vp = heads(_t(inputs["k_pages"])), heads(_t(inputs["v_pages"]))
        logits, kp, vp = model.decode_step(
            params, cfg, _t(inputs["token"]), _t(inputs["seq_lens"]), kp,
            vp, _t(inputs["table"]), **kw)
        out["decode"] = (logits.numpy(), kp.numpy(), vp.numpy())
        if "verify" in inputs:
            kp = heads(_t(inputs["k_pages"]))
            vp = heads(_t(inputs["v_pages"]))
            logits, kp, vp = model.verify_step(
                params, cfg, _t(inputs["verify"]), _t(inputs["seq_lens"]),
                kp, vp, _t(inputs["table"]), _t(inputs["valid_len"]), **kw)
            out["verify"] = (logits.numpy(), kp.numpy(), vp.numpy())
    return out


def tp_steps(rank, dev, tp, family, cfg, tree, inputs):
    """:func:`model_steps` at tp on the Megatron-sharded tree, every
    rank on its kv heads, with the rank's local block of every leaf and
    the fingerprint of its shards. Every rank returns its own."""
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=1, tp=tp), "cpu")
    ctx = pmesh.TensorParallel(mesh)
    shards = pmesh.shard_params(mesh, tree_to_torch(tree))
    out = model_steps(FAMILIES[family], shards, cfg, inputs,
                      heads=ctx.head_slice, tp=ctx)
    out["local"] = pmesh.tree_map(lambda _, t: t.to_local().numpy(), shards)
    out["fingerprint"] = ts.weights_fingerprint(shards)
    return out


def moe_routing_checks(rank, dev, tp, cfg, tree, tokens):
    """The routing agreement of one MoE prefill at tp as the ranks ran
    it, then with one ulp planted on tp rank 1's first router input:
    every rank returns [agreement, agreement with the planted ulp]."""
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=1, tp=tp), "cpu")
    ctx = pmesh.TensorParallel(mesh)
    shards = pmesh.shard_params(mesh, tree_to_torch(tree))
    out = []
    for plant in (False, True):
        # The nudge goes in front of the check, which records what the
        # router was given.
        with torch.no_grad(), RoutingCheck(torch, tmoe) as check:
            route = tmoe._route

            def nudged(layer, h, *a, **kw):
                h = h.clone()
                flat = h.view(-1)
                flat[0] = torch.nextafter(flat[0],
                                          torch.tensor(float("inf")))
                return route(layer, h, *a, **kw)

            if plant and ctx.tp_rank == 1:
                tmoe._route = nudged
            tmoe.prefill(shards, cfg, _t(tokens), tp=ctx)
        out.append(check.agreement())
    return out


def moe_train(rank, dev, dp, tp, cfg, tree, tokens, plant_sum):
    """One MoE AdamW step on a (dp, tp) mesh from the whole numpy tree:
    rank 0 returns the loss and every leaf's whole grad. With
    ``plant_sum`` the router's and experts' grads are summed over tp
    before the optimizer steps (the fault a tp step must not have)."""
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=dp, tp=tp), "cpu")
    ctx = pmesh.TensorParallel(mesh)
    sharded = pmesh.shard_params(mesh, tree_to_torch(tree))
    opt = tl.adamw(sharded, 1e-3)
    rows = pmesh.local_shard(mesh, torch.from_numpy(tokens),
                             pmesh.data_sharding(mesh))
    if plant_sum:
        step = opt.step

        def summed_step(*a, **kw):
            for layer in sharded["layers"]:
                for name in ("router", "e_gate", "e_up", "e_down"):
                    torch.distributed.all_reduce(
                        layer[name].grad.to_local(), group=ctx.tp_group)
            return step(*a, **kw)
        opt.step = summed_step
    loss = float(tmoe.train_step(sharded, opt, cfg, rows, tp=ctx))
    grads = pmesh.tree_map(
        lambda _, p: pmesh.full_tensor(p.grad).numpy(), sharded)
    return {"loss": loss, "grads": grads} if rank == 0 else None


def several(rank, dev, calls):
    """Each (rank function, its arguments) of ``calls`` in turn on the
    one world of ranks (each builds its own mesh): one spawn for a
    module's cases. Returns their results in order."""
    return [fn(rank, dev, *args) for fn, args in calls]

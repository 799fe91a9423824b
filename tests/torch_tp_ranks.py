"""Rank functions of the port's multi-rank tests (test_torch_mesh.py,
test_torch_tp_train.py, test_torch_tp_serving.py), spawned on the CPU
over gloo by ``infinistore_tpu_torch.parallel.launch.run_ranks``.

Kept apart from the test files so that a spawned rank imports only
torch and the port, not JAX. Every function takes (rank, device, ...)
and returns picklable numpy results, from rank 0 unless noted."""

import numpy as np
import torch

from infinistore_tpu_torch import (ClientConfig, InfinityConnection,
                                   TYPE_SHM)
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.cuda import CudaKVStore
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.parallel import mesh as pmesh


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
                hit_port, hit_reqs):
    """The tp engine on every rank. Store-less, each of ``modes``
    ({name: ServingConfig kwargs}) serves ``reqs``; then with a store on
    ``offload_port`` (empty) it serves ``reqs`` again (offloading their
    pages); then with a store on ``hit_port`` (pages a single-device
    engine wrote) it serves ``hit_reqs``. Every rank returns its
    outputs, the store legs' stats and put keys (all ranks must agree;
    only tp rank 0 may put)."""
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=1, tp=tp), "cpu")
    shards = pmesh.shard_params(mesh, tree_to_torch(tree))
    out = {}
    for name, sc in modes.items():
        eng = ts.ServingEngine(shards, cfg, ts.ServingConfig(**sc),
                               device="cpu", mesh=mesh)
        out[name] = eng.run(_requests(reqs))
    for name, port, rq in (("offload", offload_port, reqs),
                           ("hit", hit_port, hit_reqs)):
        store = _store(port)
        try:
            eng = ts.ServingEngine(shards, cfg, ts.ServingConfig(max_slots=2),
                                   store=store, device="cpu", mesh=mesh)
            out[name] = {"tokens": eng.run(_requests(rq)),
                         "stats": dict(eng.stats),
                         "put_keys": list(store.put_keys),
                         "pool_heads": int(eng.k_pages.shape[3])}
        finally:
            store.close()
            store.conn.close()
    return out

"""The port's (dp, tp) shardings against the JAX package's
(``infinistore_tpu/parallel/mesh.py``): for every leaf of the tiny Llama
tree, ``param_shardings`` and ``fsdp_param_shardings`` place the leaf as
the JAX ``PartitionSpec`` does, and each of 8 gloo ranks on a dp=2 x
tp=4 mesh holds exactly the block that the JAX ``NamedSharding`` puts on
the matching device of the 8-device CPU mesh (rank r is device r: both
meshes lay the ranks out dp-major). Each rank's weights fingerprint of
its shards (``serving.weights_fingerprint``, which keys a tp engine's
store namespace) is the whole tree's. The 8 ranks are spawned once for
the module."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import torch_tp_ranks
from infinistore_tpu.models import llama as jl
from infinistore_tpu.parallel import mesh as jmesh
from infinistore_tpu_torch import graft_entry
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.parallel import mesh as pmesh
from infinistore_tpu_torch.parallel.launch import run_ranks

DP, TP = 2, 4
CFG = jl.LlamaConfig(**dict(dataclasses.asdict(graft_entry.tiny_cfg()),
                            dtype="float32"))
KINDS = {"tp": jmesh.param_shardings, "fsdp": jmesh.fsdp_param_shardings}


# The tiny tree's leaves, in sorted-key order (as JAX flattens a dict).
LEAVES = (["embed", "final_ln", "lm_head"]
          + [f"layers.{i}.{n}" for i in range(CFG.n_layers)
             for n in sorted(("ln1", "ln2", "wq", "wk", "wv", "wo",
                              "w_gate", "w_up", "w_down"))])


@pytest.fixture(scope="module")
def shards():
    """{kind: {leaf: (port spec, JAX spec, [(port block, JAX block) for
    each rank])}}, and under "fingerprint" {kind: (every rank's
    fingerprint of its shards, the whole tree's)}."""
    jparams = jl.init_params(jax.random.PRNGKey(0), CFG)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    ranks = run_ranks(torch_tp_ranks.mesh_shards, DP * TP, (DP, TP, tree),
                      device="cpu")
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=DP, tp=TP),
                           jax.devices()[:DP * TP])
    values = dict(torch_tp_ranks.flat_leaves(tree))
    out = {}
    for kind, rule in KINDS.items():
        jsh = dict(torch_tp_ranks.flat_leaves(rule(mesh, jparams)))
        axes = dict(torch_tp_ranks.flat_leaves(ranks[0][kind]["placements"]))
        local = [dict(torch_tp_ranks.flat_leaves(r[kind]["local"])) for r in ranks]
        out[kind] = {}
        for leaf in LEAVES:
            ndim = values[leaf].ndim
            spec = [None] * ndim
            for name, i in zip(("dp", "tp"),
                               (axes[f"{leaf}.0"], axes[f"{leaf}.1"])):
                if i is not None:
                    spec[i] = name
            want = list(jsh[leaf].spec) + [None] * (ndim - len(jsh[leaf].spec))
            placed = jax.device_put(values[leaf], jsh[leaf])
            by_device = {sh.device: np.asarray(sh.data)
                         for sh in placed.addressable_shards}
            blocks = [(local[r][leaf], by_device[dev]) for r, dev in
                      enumerate(mesh.devices.reshape(-1))]
            out[kind][leaf] = (spec, want, blocks)
    whole = ts.weights_fingerprint(torch_tp_ranks.tree_to_torch(tree))
    out["fingerprint"] = {kind: ([r[kind]["fingerprint"] for r in ranks],
                                 whole) for kind in KINDS}
    return out


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("leaf", LEAVES)
def test_placements_and_local_blocks_match_jax(shards, kind, leaf):
    spec, want, blocks = shards[kind][leaf]
    assert spec == want, (leaf, spec, want)
    # Rank r holds what the NamedSharding puts on device r.
    for r, (got, ref) in enumerate(blocks):
        assert got.shape == ref.shape, (leaf, r)
        assert got.tobytes() == ref.tobytes(), (leaf, r)


@pytest.mark.parametrize("kind", list(KINDS))
def test_shards_fingerprint_as_the_whole_tree(shards, kind):
    """A tp (or FSDP) engine keys the store under the single-device
    engine's namespace: the fingerprint of every rank's shards, summed
    over the mesh, is the whole tree's."""
    per_rank, whole = shards["fingerprint"][kind]
    assert per_rank == [whole] * (DP * TP)


def test_fingerprint_sees_a_permutation_and_an_element():
    """The checksum weighs each element by its position: two trees that
    differ by a permutation of one leaf, or by one element's last bit,
    fingerprint apart."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((6, 10)).astype(np.float32))
    base = ts.weights_fingerprint({"w": w})
    assert ts.weights_fingerprint({"w": w.flip(0)}) != base
    bumped = w.clone()
    bumped.view(torch.int32)[3, 7] += 1
    assert ts.weights_fingerprint({"w": bumped}) != base
    assert ts.weights_fingerprint({"w": w.clone()}) == base


def test_bias_rules_split_with_their_columns():
    """Biases of the column-parallel projections (Qwen2's bq/bk/bv) split
    with their columns over tp; bo is replicated (added once, after the
    row-parallel all-reduce). The JAX rules leave all four replicated and
    let GSPMD split them inside the program."""
    rules = pmesh.param_sharding_rules()
    for name in ("bq", "bk", "bv"):
        assert rules[name] == (Replicate(), Shard(0))
    assert rules["bo"] == (Replicate(), Replicate())
    tree = {"layers": [{"bq": torch.zeros(8), "wq": torch.zeros(4, 8)}]}

    class _Mesh:  # fsdp_param_shardings reads the dp size alone
        def size(self, dim):
            return 2

    fsdp = pmesh.fsdp_param_shardings(_Mesh(), tree)["layers"][0]
    assert fsdp["bq"] == (Replicate(), Shard(0))  # 1-D: not over dp
    assert fsdp["wq"] == (Shard(0), Shard(1))

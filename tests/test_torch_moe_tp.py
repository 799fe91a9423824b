"""The MoE family under tensor parallelism (gloo ranks on the CPU, tp = 2,
float32): ``models/moe.py``'s steps, engine and training step with
``tp=``, on the tree of ``parallel.mesh.shard_params`` (the attention
Megatron-sharded; the router and experts, which have no tp rule, whole
on every rank), against the JAX package's ``models/moe.py`` on
``parallel.mesh.shard_params(moe.init_params(...))`` over 2 of the
8-device virtual mesh's devices, at ``tests/test_moe.py``'s tiny config.

- ``prefill``, ``prefill_with_prefix``, ``decode_step`` and
  ``verify_step`` give the JAX functions' logits (and KV, and updated
  pages) to 1e-5.
- The tp engine (plain, spec, chunk) emits the JAX engine's tokens
  exactly, writes the single-device port engine's pages under its keys
  (layer 0 byte-equal, layer 1 to 1e-5) and hits them.
- Routing agrees across the ranks: every routed token's router input is
  the same to the bit on both ranks and picks the same experts
  (``chip_smoke.RoutingCheck`` reads 1.0 over every engine run); one ulp
  planted on one rank's router input reads below 1.0.
- Two MoE engines on a (dp = 2, tp = 1) mesh, and two on a (dp = 2,
  ep = 1) mesh, each serving its own requests, emit the single-device
  engine's tokens for them: dp ranks are separate engines, so nothing
  of their routing is summed over dp.
- ``train_step`` at tp = 2 (and at dp = 2 x tp = 2) gives the JAX
  ``moe.train_step``'s loss to rtol 1e-4 and ``jax.grad`` of its loss's
  leaf grads to 1e-4 (relative L2): the replicated experts' grads are
  not summed over tp. A planted sum of them over tp reads grads x tp and
  fails that check.

The tp = 2 cases share one spawn of the ranks and the dp = 2 x tp = 2
step has another, each with a time limit of its own."""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

import torch_tp_ranks
from infinistore_tpu import serving as js
from infinistore_tpu.models import moe as jm
from infinistore_tpu.parallel import mesh as jmesh
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.models import moe as tm
from infinistore_tpu_torch.parallel.launch import run_ranks
from test_torch_tp_int8 import (MODES, RANK_TIMEOUT, TOL, _close, _server,
                                _store, assert_steps_match, jax_steps,
                                step_inputs)

TP = 2
JCFG = jm.MoEConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=64, n_experts=4, top_k=2, max_seq=64,
                    page_size=8, dtype="float32")
TCFG = tm.MoEConfig(**dataclasses.asdict(JCFG))
# The engines run tests/test_moe.py's serving config, capacity factor 4
# (no pass drops a token): the JAX engine pads a prompt to whole pages
# and its padded prefill routes with the capacity of the padded length,
# where the port prefills the real tokens only (tests/test_torch_moe.py's
# engine cases run it so for the same reason). The model steps and the
# training keep the default factor, which drops tokens.
JECFG = dataclasses.replace(JCFG, capacity_factor=4.0)
TECFG = tm.MoEConfig(**dataclasses.asdict(JECFG))
TOL_TRAIN = 1e-4
EXPERT_LEAVES = ("router", "e_gate", "e_up", "e_down")


def jax_mesh(dp=1, tp=TP):
    return jmesh.make_mesh(jmesh.MeshConfig(dp=dp, tp=tp),
                           jax.devices()[:dp * tp])


@pytest.fixture(scope="module")
def weights():
    jparams = jm.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


# Two engines on a (dp = 2, 1) mesh, of either kind, each with its own
# requests: dp rank 0 serves two (8 decode steps), dp rank 1 one (3).
REPLICA_KINDS = ["tp", "ep"]
_rng = np.random.default_rng(34)
REPLICA_REQS = [
    [(f"a{i}", [int(t) for t in _rng.integers(0, JCFG.vocab_size, n)], mx)
     for i, (n, mx) in enumerate([(13, 8), (6, 5)])],
    [("b0", [int(t) for t in _rng.integers(0, JCFG.vocab_size, 21)], 3)],
]

# (case, dp, tp, planted sum of the expert grads over tp)
TRAIN_CASES = [("tp2", 1, 2, False), ("tp2_planted_sum", 1, 2, True),
               ("dp2xtp2", 2, 2, False)]


@pytest.fixture(scope="module")
def world(weights):
    """Every tp = 2 case in one spawn of the ranks (the steps, the
    engines, the routing checks, the plain and the planted training
    step); the dp = 2 x tp = 2 step in another. The JAX references and
    the single-device engine's pages come first."""
    jparams, tree = weights
    jsh = jmesh.shard_params(jax_mesh(), jparams)
    inputs = step_inputs(JCFG, 2, verify=True)
    ref = {"steps": jax_steps(jm, jsh, JCFG, inputs)}
    rng = np.random.default_rng(32)
    V = JCFG.vocab_size
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, V, n)], mx)
            for i, (n, mx) in enumerate([(11, 6), (19, 5)])]
    ref.update({name: js.ServingEngine(jsh, JECFG, js.ServingConfig(**sc),
                                       model=jm).run(
        [js.Request(r, p, n) for r, p, n in reqs])
        for name, sc in MODES.items()})
    route_tokens = np.random.default_rng(3).integers(
        0, V, (2, 12)).astype(np.int32)
    train_tokens = np.random.default_rng(5).integers(
        0, V, (4, 17)).astype(np.int32)
    servers = {"one": _server(), "tp": _server()}
    try:
        single = _store(servers["one"])
        try:
            eng = ts.ServingEngine(tl.params_from_jax(tree, "cpu"), TECFG,
                                   ts.ServingConfig(max_slots=2),
                                   store=single, model=tm, device="cpu")
            ref["single"] = eng.run(torch_tp_ranks._requests(reqs))
            ref["namespace"] = eng._ns
            single_keys = list(single.put_keys)
        finally:
            _close(single)
        hit_reqs = [(f"h{i}", p + ref["plain"][r] + [int(t) for t in
                                                    rng.integers(0, V, 5)],
                     4) for i, (r, p, _) in enumerate(reqs)]
        ref["hit"] = js.ServingEngine(jsh, JECFG, model=jm).run(
            [js.Request(r, p, n) for r, p, n in hit_reqs])
        calls = [
            (torch_tp_ranks.tp_steps, (TP, "moe", TCFG, tree, inputs)),
            (torch_tp_ranks.serve_cases,
             (TP, TECFG, tree, MODES, reqs, servers["tp"].service_port,
              servers["one"].service_port, hit_reqs, "moe")),
            (torch_tp_ranks.moe_routing_checks, (TP, TCFG, tree,
                                                 route_tokens))]
        calls += [(torch_tp_ranks.replica_serve, (kind, TCFG, tree,
                                                  REPLICA_REQS))
                  for kind in REPLICA_KINDS]
        calls += [(torch_tp_ranks.moe_train,
                   (dp, tp, TCFG, tree, train_tokens, plant))
                  for _, dp, tp, plant in TRAIN_CASES if dp == 1]
        ranks = run_ranks(torch_tp_ranks.several, TP, (calls,),
                          device="cpu", timeout=RANK_TIMEOUT)
        pages = {}
        for name, srv in servers.items():
            st = _store(srv)
            try:
                pages[name] = st.get_kv_pages_host(
                    single_keys, TCFG.kv_page_shape(), torch.float32).numpy()
            finally:
                _close(st)
    finally:
        for srv in servers.values():
            srv.stop()
    out = {"steps": [r[0] for r in ranks], "serve": [r[1] for r in ranks],
           "routing": [r[2] for r in ranks]}
    one_dp = [c for c in TRAIN_CASES if c[1] == 1]
    out["replicas"] = {kind: [r[3 + i] for r in ranks]
                       for i, kind in enumerate(REPLICA_KINDS)}
    first = 3 + len(REPLICA_KINDS)
    out["train"] = {c[0]: ranks[0][first + i] for i, c in enumerate(one_dp)}
    for name, dp, tp, plant in TRAIN_CASES:
        if dp > 1:
            out["train"][name] = run_ranks(
                torch_tp_ranks.moe_train, dp * tp,
                (dp, tp, TCFG, tree, train_tokens, plant), device="cpu",
                timeout=RANK_TIMEOUT)[0]
    optimizer = optax.adamw(1e-3)
    _, _, loss = jax.jit(
        lambda p, o, t: jm.train_step(p, o, JCFG, t, optimizer)
    )(jsh, optimizer.init(jsh), train_tokens)
    grads = jax.jit(jax.grad(lambda p, t: jm.loss_fn(p, JCFG, t)))(
        jsh, train_tokens)
    ref["loss"] = float(loss)
    ref["grads"] = jax.tree_util.tree_map(np.asarray, grads)
    return out, ref, single_keys, pages


@pytest.mark.parametrize("step", ["prefill", "prefix", "decode", "verify"])
def test_moe_tp_steps_match_jax_on_the_sharded_tree(world, step):
    out, ref, _, _ = world
    assert_steps_match(out["steps"], ref["steps"], [step])


def test_moe_tp_experts_whole_attention_split(weights, world):
    """The router and experts are whole on every rank; the attention's
    q/k/v columns and wo rows are the rank's Megatron slices."""
    _, tree = weights
    for r, out in enumerate(world[0]["steps"]):
        mine, whole = out["local"]["layers"][0], tree["layers"][0]
        for name in EXPERT_LEAVES:
            np.testing.assert_array_equal(mine[name], whole[name])
        np.testing.assert_array_equal(
            mine["wq"], np.split(whole["wq"], TP, axis=1)[r])
        np.testing.assert_array_equal(
            mine["wo"], np.split(whole["wo"], TP, axis=0)[r])


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_tp_engine_emits_the_jax_engine_tokens(world, mode):
    out, ref, _, _ = world
    for rank_out in out["serve"]:
        assert rank_out[mode] == ref[mode], mode


def test_moe_tp_engine_pages_and_hits(world):
    out, ref, single_keys, pages = world
    legs = [r["offload"] for r in out["serve"]]
    assert legs[0]["tokens"] == ref["single"] == ref["plain"]
    assert all(leg["namespace"] == ref["namespace"] for leg in legs)
    assert all(leg["pool_heads"] == TCFG.n_kv_heads // TP for leg in legs)
    assert single_keys and legs[0]["put_keys"] == single_keys
    assert all(not leg["put_keys"] for leg in legs[1:])
    for key, g, w in zip(single_keys, pages["tp"], pages["one"]):
        if "/L0/" in key:
            assert g.tobytes() == w.tobytes(), key
        else:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= TOL, (key, err)
    for rank_out in out["serve"]:
        leg = rank_out["hit"]
        assert leg["stats"]["prefix_hit_pages"] > 0
        assert leg["stats"]["store_errors"] == 0
        assert leg["tokens"] == ref["hit"]


def test_moe_tp_engine_routes_alike_on_every_rank(world):
    out, _, _, _ = world
    for rank_out in out["serve"]:
        assert rank_out["routed_layers"] > 0
        assert rank_out["routing_agreement"] == 1.0


def test_routing_check_catches_one_ulp(world):
    """One prefill at tp = 2 routes alike (1.0); with one ulp added to
    rank 1's first router input the check reads below 1.0 on both
    ranks."""
    for sound, planted in world[0]["routing"]:
        assert sound == 1.0
        assert planted < 1.0


@pytest.mark.parametrize("kind", REPLICA_KINDS)
def test_moe_engines_at_dp2_serve_their_own_requests(weights, world, kind):
    """Two MoE engines on a (dp = 2, 1) mesh, each serving requests of
    its own with a different number of steps, emit the single-device
    engine's tokens for those requests: nothing is summed over dp, so
    each routes its tokens alone (capacity from its own tokens, at the
    default factor, which drops tokens)."""
    _, tree = weights
    whole = tl.params_from_jax(tree, "cpu")
    for reqs, got in zip(REPLICA_REQS, world[0]["replicas"][kind]):
        want = ts.ServingEngine(whole, TCFG, ts.ServingConfig(max_slots=2),
                                model=tm, device="cpu").run(
            torch_tp_ranks._requests(reqs))
        assert got == want


def grad_errors(got, want):
    """Relative L2 of every leaf's grad, by dotted leaf name."""
    g = dict(torch_tp_ranks.flat_leaves(got))
    w = dict(torch_tp_ranks.flat_leaves(want))
    assert g.keys() == w.keys()
    return {k: float(np.linalg.norm(g[k] - w[k])
                     / max(np.linalg.norm(w[k]), 1e-30)) for k in g}


@pytest.mark.parametrize("case", ["tp2", "dp2xtp2"])
def test_moe_tp_train_step_matches_jax(world, case):
    out, ref, _, _ = world
    got = out["train"][case]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=TOL_TRAIN)
    errs = grad_errors(got["grads"], ref["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL_TRAIN, (case, worst, errs[worst])


def test_planted_expert_grad_sum_fails_the_check(world):
    """Summing the router's and experts' grads over tp (as if each rank
    held only a part of them) reads grads x tp: the check above fails on
    every such leaf, and only on them."""
    out, ref, _, _ = world
    errs = grad_errors(out["train"]["tp2_planted_sum"]["grads"],
                       ref["grads"])
    for name, err in errs.items():
        if name.split(".")[-1] in EXPERT_LEAVES:
            assert abs(err - (TP - 1)) < 1e-3, (name, err)
        else:
            assert err <= TOL_TRAIN, (name, err)

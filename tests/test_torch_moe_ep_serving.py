"""The MoE family's serving path under expert parallelism (gloo ranks on
the CPU, ep = 2, float32): ``moe.prefill``, ``prefill_with_prefix``,
``decode_step`` and ``verify_step`` with ``ep=`` and the ServingEngine
on a (dp, ep) mesh from ``moe.make_ep_mesh`` (``mesh=``), on the tree of
``moe.shard_params`` (4 experts, 2 a rank; the attention, router and
everything else whole on every rank).

- Every step at ep = 2 equals the single-process step bit for bit
  (logits, KV and updated pages): a token's top-2 picks sum in float32
  as a + 0 on one rank and 0 + b on the other, and one all-reduce gives
  a + b, as one process sums them.
- The ep engine emits the JAX engine's tokens on
  ``moe.param_shardings(make_ep_mesh(1, 2))`` (2 of the 8-device virtual
  mesh's devices) in plain, spec and chunk modes; every rank routes
  alike (``chip_smoke.RoutingCheck`` reads 1.0).
- Its offloaded pages are byte-equal to the single-process port
  engine's under the same keys, every layer (ep rank 0 alone puts, the
  pool holds every kv head), and a prefix hit on that engine's pages
  through the SHM store restores them and gives the JAX engine's
  tokens.

The ranks are spawned once, with a time limit of their own."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks
import torch_tp_ranks
from infinistore_tpu import serving as js
from infinistore_tpu.models import moe as jm
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.models import moe as tm
from infinistore_tpu_torch.parallel.launch import run_ranks
from test_torch_tp_int8 import (MODES, RANK_TIMEOUT, _close, _server,
                                _store, arrays, step_inputs)

EP = 2
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
STEPS = ["prefill", "prefix", "decode", "verify"]


@pytest.fixture(scope="module")
def world():
    jparams = jm.init_params(jax.random.PRNGKey(1), JCFG)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    mesh = jm.make_ep_mesh(1, EP, jax.devices()[:EP])
    jsh = jax.device_put(jparams, jm.param_shardings(mesh, jparams))
    inputs = step_inputs(JCFG, 4, verify=True)
    whole = tl.params_from_jax(tree, "cpu")
    ref = {"steps": torch_tp_ranks.model_steps(tm, whole, TCFG, inputs)}
    rng = np.random.default_rng(33)
    V = JCFG.vocab_size
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, V, n)], mx)
            for i, (n, mx) in enumerate([(11, 6), (19, 5)])]
    ref.update({name: js.ServingEngine(jsh, JECFG, js.ServingConfig(**sc),
                                       model=jm).run(
        [js.Request(r, p, n) for r, p, n in reqs])
        for name, sc in MODES.items()})
    servers = {"one": _server(), "ep": _server()}
    try:
        single = _store(servers["one"])
        try:
            eng = ts.ServingEngine(whole, TECFG, ts.ServingConfig(max_slots=2),
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
        ranks = run_ranks(torch_parallel_ranks.ep_serve_cases, EP,
                          (EP, TCFG, TECFG, tree, inputs, MODES, reqs,
                           servers["ep"].service_port,
                           servers["one"].service_port, hit_reqs),
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
    return ranks, ref, single_keys, pages


@pytest.mark.parametrize("step", STEPS)
def test_ep_steps_equal_one_process_bit_for_bit(world, step):
    ranks, ref, _, _ = world
    want = list(arrays(ref["steps"][step]))
    for steps, _ in ranks:
        got = list(arrays(steps[step]))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), step


@pytest.mark.parametrize("mode", list(MODES))
def test_ep_engine_emits_the_jax_engine_tokens(world, mode):
    ranks, ref, _, _ = world
    for _, legs in ranks:
        assert legs[mode] == ref[mode], mode
        assert legs["routing_agreement"] == 1.0
        assert legs["routed_layers"] > 0


def test_ep_offload_pages_byte_equal_to_one_process(world):
    ranks, ref, single_keys, pages = world
    legs = [r[1]["offload"] for r in ranks]
    assert legs[0]["tokens"] == ref["single"] == ref["plain"]
    assert all(leg["namespace"] == ref["namespace"] for leg in legs)
    assert all(leg["pool_heads"] == TCFG.n_kv_heads for leg in legs)
    assert single_keys and legs[0]["put_keys"] == single_keys
    assert all(not leg["put_keys"] for leg in legs[1:])
    assert pages["ep"].tobytes() == pages["one"].tobytes()


def test_ep_engine_hits_through_the_shm_store(world):
    ranks, ref, _, _ = world
    for _, legs in ranks:
        leg = legs["hit"]
        assert leg["stats"]["prefix_hit_pages"] > 0
        assert leg["stats"]["restored_pages"] > 0
        assert leg["stats"]["store_errors"] == 0
        assert leg["tokens"] == ref["hit"]


def test_ep_mesh_takes_only_the_moe():
    """An ep mesh under a Llama config is refused before any collective
    (the check reads the mesh's dim names alone)."""
    class Mesh:
        mesh_dim_names = tm.EP_AXES
    cfg = tl.LlamaConfig(dtype="float32")
    params = tl.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="ep mesh takes a MoE"):
        ts.ServingEngine(params, cfg, device="cpu", mesh=Mesh())

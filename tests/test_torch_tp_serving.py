"""The port's ServingEngine over a tensor-parallel mesh (gloo ranks on the
CPU, ``ServingEngine(..., mesh=)``) against the JAX package's engine on
Megatron-sharded weights (``tests/test_serving_mesh.py``: plain, spec and
chunk modes emit the single-device token stream), at tp 2 and 4, f32,
over the JAX weights carried by ``params_from_jax``; and against the
port's single-device engine through the port's store: the tp engine
offloads whole pages (kv heads gathered, tp rank 0 puts) under the
single-device engine's keys, and hits on pages that engine wrote.

Byte-equality of the pages holds where the arithmetic is the same: the
first layer's K and V come from the same columns of the same products,
so their pages are byte-equal. Every later layer's input went through a
row-parallel all-reduce, which regroups the f32 sums of wo and w_down,
so those pages agree to f32 rounding (1e-5 relative), not to the bit.

Each tp world is spawned once for the module; its cases are asserted
one by one."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_tp_ranks
from infinistore_tpu import serving as js
from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM)
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.cuda import CudaKVStore
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.parallel.launch import run_ranks

JCFG = jl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=8,
                      n_kv_heads=4, d_ff=128, max_seq=128, page_size=8,
                      dtype="float32")
TCFG = tl.LlamaConfig(**dataclasses.asdict(JCFG))
MODES = {"plain": dict(max_slots=2), "spec": dict(max_slots=2, spec_k=2),
         "chunk": dict(max_slots=2, prefill_chunk=4)}
TPS = (2, 4)
TOL = 1e-5


def _server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=16))
    srv.start()
    return srv


def _store(srv):
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=TYPE_SHM))
    conn.connect()
    return torch_tp_ranks.RecordingStore(conn, "cpu")


def _close(store):
    store.close()
    store.conn.close()


@pytest.fixture(scope="module")
def world():
    jparams = jl.init_params(jax.random.PRNGKey(0), JCFG)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(31)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, 128, n)], mx)
            for i, (n, mx) in enumerate([(11, 6), (19, 5)])]
    ref = {name: js.ServingEngine(jparams, JCFG, js.ServingConfig(**sc)).run(
        [js.Request(r, p, n) for r, p, n in reqs]) for name, sc in
        MODES.items()}
    # The single-device port engine writes the requests' pages into
    # server A; each tp world offloads into a server of its own.
    servers = {"A": _server(), **{t: _server() for t in TPS}}
    try:
        single = _store(servers["A"])
        try:
            eng = ts.ServingEngine(tl.params_from_jax(tree, "cpu"), TCFG,
                                   ts.ServingConfig(max_slots=2),
                                   store=single, device="cpu")
            ref["single"] = eng.run(torch_tp_ranks._requests(reqs))
            single_keys = list(single.put_keys)
        finally:
            _close(single)
        # Next turns: each conversation so far plus new tokens.
        hit_reqs = [(f"h{i}", p + ref["plain"][r] + [int(t) for t in
                                                    rng.integers(0, 128, 5)],
                     4) for i, (r, p, _) in enumerate(reqs)]
        ref["hit"] = js.ServingEngine(jparams, JCFG).run(
            [js.Request(r, p, n) for r, p, n in hit_reqs])
        out = {t: run_ranks(
            torch_tp_ranks.serve_cases, t,
            (t, TCFG, tree, MODES, reqs, servers[t].service_port,
             servers["A"].service_port, hit_reqs), device="cpu")
            for t in TPS}
        pages = {}
        for name, srv in servers.items():
            st = _store(srv)
            try:
                pages[name] = st.get_kv_pages_host(
                    single_keys, TCFG.kv_page_shape(), torch.float32).numpy()
            finally:
                _close(st)
        yield out, ref, single_keys, pages
    finally:
        for srv in servers.values():
            srv.stop()


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("mode", list(MODES))
def test_tp_engine_emits_the_jax_engine_tokens(world, tp, mode):
    out, ref, _, _ = world
    for rank_out in out[tp]:
        assert rank_out[mode] == ref[mode], (tp, mode)


@pytest.mark.parametrize("tp", TPS)
def test_tp_offload_writes_the_single_device_pages(world, tp):
    out, ref, single_keys, pages = world
    legs = [r["offload"] for r in out[tp]]
    assert legs[0]["tokens"] == ref["single"] == ref["plain"]
    assert all(leg["tokens"] == legs[0]["tokens"] for leg in legs)
    assert all(leg["pool_heads"] == TCFG.n_kv_heads // tp for leg in legs)
    # Tp rank 0 alone puts, the single-device engine's keys in its order.
    assert single_keys and legs[0]["put_keys"] == single_keys
    assert all(not leg["put_keys"] for leg in legs[1:])
    assert all(leg["stats"]["offloaded_pages"]
               == legs[0]["stats"]["offloaded_pages"] > 0 for leg in legs)
    got, want = pages[tp], pages["A"]
    for key, g, w in zip(single_keys, got, want):
        if "/L0/" in key:
            assert g.tobytes() == w.tobytes(), key
        else:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= TOL, (key, err)


@pytest.mark.parametrize("tp", TPS)
def test_tp_engine_hits_single_device_pages(world, tp):
    out, ref, _, _ = world
    for rank_out in out[tp]:
        leg = rank_out["hit"]
        assert leg["stats"]["prefix_hit_pages"] > 0
        assert leg["stats"]["store_errors"] == 0
        assert leg["tokens"] == ref["hit"]

"""The device KV pool (``parallel/ici_handoff.py``) on gloo CPU ranks,
one rank per device, against the JAX package's ``IciKVPool`` on
``make_pool_mesh(4)``: the cases of ``tests/test_ici_handoff.py`` at 4
devices (prefill 0-1, decode 2-3) run through both pools by one scenario
(``torch_parallel_ranks.pool_scenarios``), and every step must agree:
pages bit-exact (and equal to what was put), directories, free slots,
rounds, errors. Its executable-reuse case becomes "a steady pairing is
one round". The store tiering case runs on a port server, and so does
``tests/test_multiprocess_spmd.py``'s two-process flow. Every rank's
records must agree (the replicated directory contract)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_parallel_ranks
from infinistore_tpu.parallel.ici_handoff import IciKVPool, make_pool_mesh
from infinistore_tpu_torch import InfiniStoreServer, ServerConfig
from infinistore_tpu_torch.parallel.launch import run_ranks

WORLD = 4


@pytest.fixture(scope="module")
def port_server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=4))
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def port_runs(port_server):
    four = run_ranks(torch_parallel_ranks.pool_cases, WORLD,
                     (port_server.service_port,), device="cpu", timeout=300)
    two = run_ranks(torch_parallel_ranks.pool_two_process, 2,
                    (port_server.service_port,), device="cpu", timeout=300)
    return four, two


def _jax_records():
    mesh = make_pool_mesh(WORLD)

    def make(slots):
        pool = IciKVPool(mesh, (8, 16), jnp.float32, slots_per_device=slots)
        pool.n_rounds = 0
        inner = pool._handoff_round

        def counted(routes):
            pool.n_rounds += 1
            return inner(routes)
        pool._handoff_round = counted
        return pool

    return torch_parallel_ranks.pool_scenarios(
        make, jnp.asarray, np.asarray, lambda p: p.n_rounds)


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


CASES = ["roundtrip", "handoff", "one_destination", "many_destinations",
         "resident", "surface", "capacity", "steady"]


@pytest.mark.parametrize("case", CASES)
def test_pool_matches_jax_pool(port_runs, case):
    four, _ = port_runs
    jax_rec = [r for r in _jax_records() if r[0] == case]
    port_rec = [r for r in four[0] if r[0] == case]
    assert [r[1] for r in port_rec] == [r[1] for r in jax_rec]
    for (_, step, got), (_, _, want) in zip(port_rec, jax_rec):
        assert _same(got, want), (case, step, got, want)
    # Pages read back are the bytes put, bit for bit.
    steps = dict((s, v) for _, s, v in port_rec)
    if "sent" in steps:
        assert np.array_equal(steps["pages"], steps["sent"])


def test_ranks_agree(port_runs):
    """The directory contract: every rank records the same steps."""
    four, two = port_runs
    for runs in (four, two):
        for other in runs[1:]:
            assert len(other) == len(runs[0])
            for a, b in zip(runs[0], other):
                assert a[:2] == b[:2] and _same(a[2], b[2]), a[:2]


def _records(rec, prefix):
    return {s: v for p, s, v in rec if p == prefix}


def test_store_pool_tiering(port_runs):
    """``test_ici_handoff.py::test_store_pool_tiering`` on the port:
    miss, fetch onto device 0 (once), handoff to device 3, bit-exact;
    eviction of fresh keys frees their slots and the store holds their
    bytes; they fetch back on a miss."""
    four, _ = port_runs
    r = _records(four[0], "tier")
    assert r["miss"] == -1 and r["fetched"] == [3, 0]
    assert r["resident"] == 2 and r["devices"] == [3, 3, 3]
    assert np.array_equal(r["pages"], r["sent"])
    assert r["evicted"] == 3 and r["after_evict"] == [-1, 4]
    assert np.array_equal(r["store_back"], r["evict_sent"])
    assert r["refetched"] == 3
    assert np.array_equal(r["refetched_pages"], r["evict_sent"])


def test_two_process_pool_tiering(port_runs):
    """``test_multiprocess_spmd.py::test_two_process_spmd_pool_tiering``
    on the port: two processes, the store as the byte rendezvous, a
    handoff across the processes, eviction (the fetched keys, which the
    store holds: first writer wins) and a fetch onto the other device,
    read back bit-exact on both processes."""
    _, two = port_runs
    for rec in two:
        r = _records(rec, "mp")
        assert r["miss"] == -1 and r["fetched"] == [3, 0]
        assert r["devices"] == [1, 1, 1]
        assert np.array_equal(r["pages"], r["sent"])
        assert r["evicted"] == 3 and r["after_evict"][0] == -1
        assert np.array_equal(r["store_back"], r["sent"])
        assert r["refetched"] == 3
        assert np.array_equal(r["refetched_pages"], r["sent"])


def test_failed_eviction_raises_on_every_rank(port_runs):
    """``evict_to_store``'s multi-process form: rank 0's failed put
    (its own error chained) makes every rank raise before any directory
    change, so the replicated directories stay equal and the pages stay
    resident."""
    four, _ = port_runs
    for rec in four:
        r = _records(rec, "failed_evict")
        assert r["raised"] == "RuntimeError" and r["cause"]
        assert r["directory_kept"]
        assert np.array_equal(r["pages"], np.ones((2, 8, 16), np.float32))

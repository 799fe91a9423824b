"""Offloads written behind the step (``serving._WriteBehind``): on the
CPU, a tiny ``ServingEngine`` over the port's in-process server, on SHM
and on STREAM. While the engine has other work, a finished request's
pages are staged to host memory and handed to one write-behind thread,
which puts them and waits for the ack; the step goes on. Checked: the
outputs and the stored bytes, a probe of pages still in flight, the
bound on offloads in flight, a failing put, a connection closed under
the thread, the paths that wait for their ack, and that both kinds of
offload store the same."""

import threading
import time

import numpy as np
import pytest
import torch

from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM, TYPE_STREAM)
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.cuda import CudaKVStore
from infinistore_tpu_torch.models import llama as tl

CFG = tl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=128, max_seq=256, page_size=16,
                     dtype="float32")
# Each scenario's thread is given this long: a hang fails the test.
LIMIT_S = 60.0


@pytest.fixture(scope="module")
def params():
    return tl.init_params(torch.Generator().manual_seed(0), CFG, "cpu")


@pytest.fixture(scope="module")
def server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=4))
    srv.start()
    yield srv
    srv.stop()


def _connect(srv, kind):
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=TYPE_SHM if kind == "shm" else TYPE_STREAM))
    conn.connect()
    return conn, CudaKVStore(conn, device="cpu")


@pytest.fixture(params=["shm", "stream"])
def store(request, server):
    conn, st = _connect(server, request.param)
    yield request.param, st
    st.close()
    conn.close()


class _GateConn:
    """The store's connection with its ``sync`` behind the gate."""

    def __init__(self, conn, gate):
        self._conn, self._gate = conn, gate

    def sync(self):
        self._gate.wait("ack")
        return self._conn.sync()

    def __getattr__(self, name):
        return getattr(self._conn, name)


class _Gate:
    """A real store behind a gate: with ``where`` "put" (or "ack") the
    page writes (or the acks) wait until ``open`` is set; ``fail`` makes
    the writes raise. Records each write's keys in order."""

    def __init__(self, store, where=None, fail=False):
        self._store, self.where, self.fail = store, where, fail
        self.open = threading.Event()
        self.entered = threading.Event()
        self.puts = []
        self.threads = []
        self.conn = _GateConn(store.conn, self)

    def wait(self, where):
        if self.where == where:
            self.entered.set()
            assert self.open.wait(LIMIT_S)

    def put_kv_pages(self, keys, pages, sync=False):
        self.puts.append(list(keys))
        self.threads.append(threading.current_thread())
        self.wait("put")
        if self.fail:
            raise ConnectionError("store down")
        return self._store.put_kv_pages(keys, pages, sync)

    def __getattr__(self, name):
        return getattr(self._store, name)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, CFG.vocab_size, n)]
            for n in lengths]


def _requests(seed, lengths, new):
    return [ts.Request(f"q{i}", p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(seed, lengths), new))]


def _storeless(params, reqs, **sc):
    eng = ts.ServingEngine(params, CFG, ts.ServingConfig(**sc),
                           device="cpu")
    return eng.run([ts.Request(r.request_id, r.prompt, r.max_new_tokens)
                    for r in reqs])


def _within(fn):
    """Run ``fn`` on a thread; fail if it outlives LIMIT_S or raises."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test's thread
            out["error"] = e

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(LIMIT_S)
    assert not th.is_alive(), "the scenario hung"
    if "error" in out:
        raise out["error"]
    return out.get("value")


@pytest.fixture
def thread_errors(monkeypatch):
    """Exceptions that escaped any thread during the test."""
    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda a: seen.append(a))
    return seen


def _pool_snapshots(eng):
    """Wrap the engine's finish: the pool pages each finished request
    offloads, page-major as (page, layer, kind) rows, taken before the
    pool can reuse them. Returns the list they are appended to, in
    finish order."""
    snaps = []
    finish = eng._finish

    def wrapped(i, s):
        lo = max(s.cached_pages, s.released)
        n_full = s.seq_len // CFG.page_size
        if n_full > lo:
            ids = torch.as_tensor(s.page_ids[lo:n_full])
            snaps.append(torch.stack(
                [eng.k_pages[:, ids], eng.v_pages[:, ids]], dim=1
            ).movedim(2, 0).reshape(-1, *CFG.kv_page_shape()).clone())
        return finish(i, s)

    eng._finish = wrapped
    return snaps


def _read(st, keys):
    return st.get_kv_pages(keys, CFG.kv_page_shape(), CFG.torch_dtype)


# Store pages one pool page makes: every layer's k and v.
GROUP = 2 * CFG.n_layers


def _runs_of(monkeypatch, pages):
    """The write-behind thread's runs: ``pages`` pool pages each."""
    monkeypatch.setattr(ts, "OFFLOAD_RUN_BYTES",
                        pages * GROUP * CFG.kv_page_bytes())


def _offloads(puts, snaps):
    """The puts' keys joined into one list per offload (a put behind the
    step writes one run of it), paired with the offloads' snapshots."""
    out, i = [], 0
    for pool in snaps:
        keys = []
        while len(keys) < pool.shape[0]:
            keys += puts[i]
            i += 1
        assert len(keys) == pool.shape[0]
        out.append((keys, pool))
    assert i == len(puts)
    return out


def test_outputs_and_stored_pages_match(params, store, monkeypatch,
                                        thread_errors):
    """(a) Outputs equal a store-less engine's; after run() every page
    offloaded is in the store, byte-equal to the pool page it came from;
    most offloads went behind the step, in runs of whole pages; the
    store's own counters equal the engine's folded ones though two
    threads used the store."""
    kind, st = store
    _runs_of(monkeypatch, 1)
    gate = _Gate(st)
    sc = dict(max_slots=2, total_pages=48)
    eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
        model_id=f"behind-a-{kind}", **sc), store=gate, device="cpu")
    snaps = _pool_snapshots(eng)
    reqs = _requests(11, (40, 21, 35, 50, 33, 18), (9, 5, 12, 7, 3, 10))
    out = eng.run(reqs)
    assert out == _storeless(params, reqs, **sc)
    s = eng.stats
    assert len(snaps) == s["offload_n"] == 6
    assert s["offload_behind_n"] >= 4  # the last finish runs alone
    assert any(t is not threading.current_thread() for t in gate.threads)
    assert all(st.stats[k] == s[k] for k in st.stats if k.endswith("_n"))
    # One put a pool page behind the step: more puts than offloads.
    assert len(gate.puts) > s["offload_n"] == s["offload_step_n"]
    for keys, pool in _offloads(gate.puts, snaps):
        assert torch.equal(_read(st, keys), pool)
    assert s["offloaded_pages"] * GROUP == sum(len(k) for k in gate.puts)
    assert s["offload_bytes"] == sum(p.numel() * 4 for p in snaps)
    assert s["offload_ack_n"] == len(gate.puts)
    assert s["offload_write_n"] == s["offload_n"]
    assert 0 < s["offload_step_ns"] - s["offload_room_wait_ns"] \
        <= s["offload_ns"]
    assert eng._behind.in_flight == 0
    assert not thread_errors


@pytest.mark.parametrize("where", ["put", "ack"])
def test_step_returns_while_the_offload_is_in_flight(params, store, where,
                                                     monkeypatch,
                                                     thread_errors):
    """(b) The first run's put (or its ack) waits at a gate: the step
    that finished the request returns, and a probe of its pages misses,
    or finds the first run's pages whole (every layer's k and v);
    drain() waits for the acks, and then every page is there."""
    kind, st = store
    _runs_of(monkeypatch, 2)
    gate = _Gate(st, where=where)
    eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
        model_id=f"behind-b-{kind}-{where}", max_slots=1, total_pages=32),
        store=gate, device="cpu")
    snaps = _pool_snapshots(eng)
    reqs = _requests(12, (100, 30), (4, 4))

    def scenario():
        for r in reqs:
            eng.submit(r)
        while eng.stats["offload_behind_n"] == 0:
            eng.step()
        assert gate.entered.wait(LIMIT_S)
        n = snaps[0].shape[0] // GROUP  # pool pages, 2 a run
        assert n > 2 and len(gate.puts) == 1
        keys = gate.puts[0]
        probe = keys[::GROUP]  # layer 0's k key of each page
        hit = st.cached_prefix_len(probe)
        if where == "put" or kind == "stream":
            assert hit in (0, 2) if where == "ack" else hit == 0
        else:  # SHM commits inside the put
            assert hit == 2
        if hit:
            assert torch.equal(_read(st, keys[:hit * GROUP]),
                               snaps[0][:hit * GROUP])
        # The engine steps on meanwhile: the next request is admitted.
        assert eng.stats["offloaded_pages"] == 0
        eng.step()
        assert eng.slots[0] is not None
        gate.open.set()
        eng.drain()
        assert eng._behind.in_flight == 0
        (keys, pool), = _offloads(gate.puts, snaps)
        assert st.cached_prefix_len(keys[::GROUP]) == n
        assert torch.equal(_read(st, keys), pool)
        assert eng.stats["offloaded_pages"] == n
        return eng.run()

    out = _within(scenario)
    assert out == _storeless(params, reqs, max_slots=1, total_pages=32)
    assert eng.stats["store_errors"] == 0
    assert not thread_errors


def test_offload_beyond_the_bound_waits(params, server, monkeypatch,
                                        thread_errors):
    """(c) The first put waits at a gate: offloads pile up to the bound,
    and the next one waits in its step (offload_room_wait) until the
    gate opens."""
    conn, st = _connect(server, "stream")
    waiting = threading.Event()

    class _Watched(ts._WriteBehind):
        def __init__(self, store):
            super().__init__(store)
            done = self.done

            class _Done:
                def get(self, *a, **kw):
                    waiting.set()
                    return done.get(*a, **kw)

                def get_nowait(self):
                    return done.get_nowait()

                def put(self, job):
                    done.put(job)

            self.done = _Done()

    monkeypatch.setattr(ts, "_WriteBehind", _Watched)
    bound = ts.OFFLOADS_IN_FLIGHT
    try:
        gate = _Gate(st, where="put")
        eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
            model_id="behind-c", max_slots=1, total_pages=32),
            store=gate, device="cpu")
        n_req = bound + 3
        reqs = _requests(13, [20 + 3 * i for i in range(n_req)],
                         [2] * n_req)
        seen = {}

        def opener():
            assert waiting.wait(LIMIT_S)
            seen["behind"] = eng.stats["offload_behind_n"]
            seen["puts"] = len(gate.puts)
            time.sleep(0.2)
            gate.open.set()

        helper = threading.Thread(target=opener, daemon=True)
        helper.start()
        out = _within(lambda: eng.run(reqs))
        helper.join(LIMIT_S)
        assert seen == {"behind": bound, "puts": 1}
        s = eng.stats
        assert s["offload_room_wait_n"] >= 1
        assert s["offload_room_wait_ns"] >= 0.2e9
        assert s["offload_behind_n"] == n_req - 1  # the last runs alone
        assert s["offloaded_pages"] > 0 and s["store_errors"] == 0
        assert out == _storeless(params, reqs, max_slots=1, total_pages=32)
    finally:
        st.close()
        conn.close()
    assert not thread_errors


def test_failing_put_downgrades_once(params, store, thread_errors):
    """(d) The first put fails while two more wait behind it: one store
    error, the sticky downgrade, the waiting ones dropped, nothing raised
    on any thread, outputs as without a store."""
    kind, st = store
    gate = _Gate(st, where="put", fail=True)
    eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
        model_id=f"behind-d-{kind}", max_slots=1, total_pages=32),
        store=gate, device="cpu")
    reqs = _requests(14, (30, 41, 25, 37), (3, 3, 3, 3))

    def scenario():
        for r in reqs:
            eng.submit(r)
        while eng.stats["offload_behind_n"] < 3:
            eng.step()
        gate.open.set()
        return eng.run()

    out = _within(scenario)
    assert out == _storeless(params, reqs, max_slots=1, total_pages=32)
    s = eng.stats
    assert s["store_errors"] == 1 and not eng._store_ok
    assert len(gate.puts) == 1 and s["offloaded_pages"] == 0
    assert s["offload_behind_n"] == 3 and s["offload_bytes"] == 0
    n = len(gate.puts)
    eng.run([ts.Request("again", _prompts(15, (33,))[0], 3)])
    assert len(gate.puts) == n  # the downgrade is sticky
    assert not thread_errors


@pytest.mark.parametrize("kind", ["shm", "stream"])
@pytest.mark.parametrize("when", ["before_put", "racing"])
def test_connection_closed_with_offloads_in_flight(params, server, kind,
                                                   when, thread_errors):
    """(e) The store and its connection close (as the benchmark closes
    them after its window) while offloads are in flight: the close ends
    within the limit, nothing is raised into the step or on any thread,
    the engine serves on (store-less after the error), and the
    write-behind thread ends."""
    conn, st = _connect(server, kind)
    gate = _Gate(st, where="put" if when == "before_put" else None)
    eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
        model_id=f"behind-e-{kind}-{when}", max_slots=1, total_pages=32),
        store=gate, device="cpu")
    reqs = _requests(16, (60, 48, 52, 40), (3, 3, 3, 3))

    def scenario():
        for r in reqs:
            eng.submit(r)
        while eng.stats["offload_behind_n"] == 0:
            eng.step()
        if when == "before_put":
            assert gate.entered.wait(LIMIT_S)
        t0 = time.monotonic()
        st.close()
        conn.close()
        closed_s = time.monotonic() - t0
        gate.open.set()
        return closed_s, eng.run()

    closed_s, out = _within(scenario)
    assert closed_s < 15.0
    assert out == _storeless(params, reqs, max_slots=1, total_pages=32)
    errors = eng.stats["store_errors"]
    assert errors == 1 if when == "before_put" else errors <= 1
    deadline = time.monotonic() + 10
    while eng._behind._thread is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng._behind._thread is None and eng._behind.in_flight == 0
    assert not thread_errors


def test_close_waits_for_a_call_inside_the_connection(server):
    """The close a write-behind thread may meet: it waits for a call
    inside the connection to leave before it frees the handle, and
    refuses calls from then on."""
    conn, st = _connect(server, "stream")
    inside, leave = threading.Event(), threading.Event()

    def holder():
        with conn.in_use():
            inside.set()
            leave.wait(LIMIT_S)

    th = threading.Thread(target=holder, daemon=True)
    th.start()
    assert inside.wait(LIMIT_S)
    threading.Timer(0.3, leave.set).start()
    t0 = time.monotonic()
    st.close()
    conn.close()
    assert time.monotonic() - t0 >= 0.25
    th.join(LIMIT_S)
    with pytest.raises(Exception, match="Not connected"):
        conn.sync()


class _Mesh:
    """A mesh of one rank, as the engine sees its context."""

    leader = True
    split_heads = False

    def __init__(self):
        self.agreed = 0

    def agree(self, value, largest=False):
        self.agreed += 1
        return value


def test_preemption_and_a_mesh_offload_synchronously(params, store,
                                                     thread_errors):
    """(f) A preemption's offload, and every offload of an engine with a
    mesh, runs on the step's thread and waits for its ack:
    offload_behind_n does not count them."""
    kind, st = store
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, CFG.vocab_size, 48)]
               for _ in range(2)]
    gate = _Gate(st)
    sc = dict(max_slots=2, total_pages=8, max_pages_per_seq=8)
    eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
        model_id=f"behind-f-{kind}", **sc), store=gate, device="cpu")
    main = threading.current_thread()
    during = []
    preempt = eng._preempt

    def counted(i, s):
        n = len(gate.puts)
        preempt(i, s)
        during.extend(gate.threads[n:])

    eng._preempt = counted
    reqs = [ts.Request(f"r{i}", p, max_new_tokens=24)
            for i, p in enumerate(prompts)]
    out = eng.run(reqs)
    s = eng.stats
    assert s["preemptions"] >= 1 and during
    assert all(t is main for t in during)
    on_main = sum(t is main for t in gate.threads)
    assert s["offload_behind_n"] == s["offload_n"] - on_main
    for r in reqs:  # as one slot with room for the whole request
        assert out[r.request_id] == _storeless(
            params, [r], max_slots=1, total_pages=16)[r.request_id]

    mesh_gate = _Gate(st)
    meshed = ts.ServingEngine(params, CFG, ts.ServingConfig(
        model_id=f"behind-f-mesh-{kind}", max_slots=1, total_pages=32),
        store=mesh_gate, device="cpu")
    meshed.par = _Mesh()
    reqs = _requests(17, (30, 41, 25), (3, 3, 3))
    out = meshed.run(reqs)
    s = meshed.stats
    assert s["offload_n"] == 3 and s["offload_behind_n"] == 0
    assert meshed._behind is None
    assert all(t is main for t in mesh_gate.threads)
    assert meshed.par.agreed >= 3 and s["offloaded_pages"] > 0
    assert out == _storeless(params, reqs, max_slots=1, total_pages=32)
    assert not thread_errors


@pytest.mark.parametrize("kind", ["shm", "stream"])
def test_offloads_behind_and_waited_store_the_same(params, kind,
                                                   monkeypatch,
                                                   thread_errors):
    """(g) The same requests served twice, each time on a fresh server:
    once by a busy engine, so offloads go behind the step in runs of one
    pool page, and once by an engine with the mesh stand-in, so every
    offload waits and is written in one run. The store holds the same
    bytes under the same keys, and the engines count the same offloads,
    pages and bytes."""
    _runs_of(monkeypatch, 1)
    held, stats = [], []
    for waited in (False, True):
        srv = InfiniStoreServer(ServerConfig(
            service_port=0, prealloc_size=0.0625, minimal_allocate_size=4))
        srv.start()
        conn, st = _connect(srv, kind)
        try:
            gate = _Gate(st)
            eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
                model_id=f"behind-g-{kind}", max_slots=2, total_pages=48),
                store=gate, device="cpu")
            if waited:
                eng.par = _Mesh()
            eng.run(_requests(18, (40, 21, 35, 50), (9, 5, 12, 7)))
            keys = [k for put in gate.puts for k in put]
            held.append(dict(zip(keys, _read(st, keys))))
            stats.append(eng.stats)
        finally:
            st.close()
            conn.close()
            srv.stop()
    behind, waits = stats
    assert behind["offload_behind_n"] > 0 == waits["offload_behind_n"]
    for key in ("offload_n", "offloaded_pages", "offload_bytes"):
        assert behind[key] == waits[key] > 0, key
    assert held[0].keys() == held[1].keys()
    assert all(torch.equal(held[0][k], held[1][k]) for k in held[0])
    assert not thread_errors

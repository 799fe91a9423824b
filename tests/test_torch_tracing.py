"""Spans and counters inside the port's serving engine and its store
client (``utils.profiling.Span``): on the CPU, a tiny ``ServingEngine``
over the port's in-process server, on SHM and on STREAM. Each counter
pair moves as the work does, an offload's children fit inside it, the
profiler ranges nest and carry request ids, no range is opened without a
profiler, and ``profile_window`` and the HTTP front end's ``/stats``
show the spans. Counts exact; times only ordered."""

import gzip
import json
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM, TYPE_STREAM)
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.cuda import CudaKVStore
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.serving_http import ServingHTTPServer
from infinistore_tpu_torch.utils import Span, profile_window
from infinistore_tpu_torch.utils import profiling

CFG = tl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=128, max_seq=256, page_size=16,
                     dtype="float32")
ENGINE_SPANS = ("admit", "probe", "prefill", "decode", "decode_dispatch",
                "decode_wait", "offload", "offload_gather", "offload_ack",
                "restore")
STORE_SPANS = ("store_allocate", "store_stage", "store_send",
               "store_commit", "store_read", "store_h2d", "store_release")
COUNTERS = ("queue_wait_ns", "queue_wait_n", "step_ns", "step_n",
            "offload_bytes", "restore_bytes")


@pytest.fixture(scope="module")
def params():
    return tl.init_params(torch.Generator().manual_seed(0), CFG, "cpu")


@pytest.fixture(scope="module")
def server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=4,
        trace=True))
    srv.start()
    yield srv
    srv.stop()


def _store(srv, ctype):
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=ctype))
    conn.connect()
    return conn, CudaKVStore(conn, device="cpu")


@pytest.fixture(params=["shm", "stream"])
def store(request, server):
    conn, st = _store(server, TYPE_SHM if request.param == "shm"
                      else TYPE_STREAM)
    yield request.param, st
    st.close()
    conn.close()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, CFG.vocab_size, n)]
            for n in lengths]


class _Puts:
    """The engine's page writes, counted in bytes on the way through."""

    def __init__(self, fn):
        self.fn, self.nbytes, self.calls = fn, 0, 0

    def __call__(self, keys, pages, **kw):
        self.calls += 1
        self.nbytes += pages.numel() * pages.element_size()
        return self.fn(keys, pages, **kw)


def _counted(monkeypatch, names):
    """The engine's calls of the serving module's functions ``names``,
    listed (a call made inside another of them is not the engine's)."""
    calls, depth = [], [0]
    for name in names:
        def wrapped(*a, _fn=getattr(ts, name), _name=name, **kw):
            if not depth[0]:
                calls.append(_name)
            depth[0] += 1
            try:
                return _fn(*a, **kw)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(ts, name, wrapped)
    return calls


@pytest.mark.parametrize("host_steps", [1, 4])
def test_counters_move_as_the_work_does(params, store, monkeypatch,
                                        host_steps):
    kind, st = store
    decodes = _counted(monkeypatch, ("_decode_fused", "_decode_scan"))
    eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
        model_id=f"counters-{kind}-{host_steps}", max_slots=2,
        total_pages=32, host_steps=host_steps), store=st, device="cpu")
    for key in COUNTERS + tuple(f"{k}_{s}" for k in ENGINE_SPANS
                                + STORE_SPANS for s in ("ns", "n")):
        assert eng.stats[key] == 0, key
    puts = _Puts(eng._put_pages)
    eng._put_pages = puts
    prompts = _prompts(1, (40, 21, 35))
    steps = [0]
    step = eng.step

    def counted_step():
        steps[0] += 1
        return step()

    eng.step = counted_step
    eng.run([ts.Request(f"r{i}", p, max_new_tokens=9)
             for i, p in enumerate(prompts)])
    s = eng.stats
    # Three admissions, none refused for pages: one wait each.
    assert s["admit_n"] == s["queue_wait_n"] == s["prefill_n"] == 3
    assert s["probe_n"] == 3  # every prompt is longer than a page
    assert s["restore_n"] == 0 and s["restore_bytes"] == 0
    assert s["decode_n"] == s["decode_dispatch_n"] == s["decode_wait_n"] \
        == len(decodes) > 0
    if host_steps > 1:
        assert "_decode_scan" in decodes
    assert s["step_n"] == steps[0]
    # Every finished request offloads its full pages: one put each.
    assert s["offload_n"] == s["offload_gather_n"] == s["offload_ack_n"] \
        == puts.calls == 3
    assert s["offload_bytes"] == puts.nbytes > 0
    assert s["offload_bytes"] == (s["offloaded_pages"] * 2 * CFG.n_layers
                                  * CFG.kv_page_bytes())
    assert s["store_allocate_n"] == s["store_stage_n"] == 3
    if kind == "shm":
        assert s["store_commit_n"] == 3 and s["store_send_n"] == 0
    else:
        assert s["store_send_n"] == 3 and s["store_commit_n"] == 0
    # The store's own counters hold the same (one engine on this store).
    assert all(st.stats[k] == s[k] for k in st.stats if k.endswith("_n"))
    # An offload's children lie inside it; the decode's inside it.
    children = (s["offload_gather_ns"] + s["store_allocate_ns"]
                + s["store_stage_ns"] + s["store_send_ns"]
                + s["store_commit_ns"] + s["offload_ack_ns"])
    assert 0 < children <= s["offload_ns"]
    assert (s["decode_dispatch_ns"] + s["decode_wait_ns"]
            <= s["decode_ns"] <= s["step_ns"])
    assert s["probe_ns"] + s["prefill_ns"] <= s["admit_ns"]


def test_restore_counters_and_engines_sharing_a_store(params, store):
    """A second engine restores the first one's pages: its restore
    counters move, and each engine's store counters hold only its own
    calls though both use one store."""
    kind, st = store
    sc = ts.ServingConfig(model_id=f"restore-{kind}", max_slots=1,
                          total_pages=32)
    prompt = _prompts(2, (48,))[0]
    first = ts.ServingEngine(params, CFG, sc, store=st, device="cpu")
    out = first.run([ts.Request("a", prompt, max_new_tokens=4)])["a"]
    second = ts.ServingEngine(params, CFG, sc, store=st, device="cpu")
    turn = prompt + out + _prompts(3, (5,))[0]
    second.run([ts.Request("b", turn, max_new_tokens=3)])
    s = second.stats
    assert s["prefix_hit_pages"] > 0
    assert s["restore_n"] == 1
    pages = s["restored_pages"]
    assert s["restore_bytes"] == pages * CFG.kv_page_bytes() > 0
    assert s["store_read_n"] == 1
    if kind == "shm":
        assert s["store_h2d_n"] == s["store_release_n"] == 1
    else:
        # A CPU engine's STREAM read lands in place: no H2D step.
        assert s["store_h2d_n"] == s["store_release_n"] == 0
    assert first.stats["store_read_n"] == 0
    assert first.stats["store_allocate_n"] == 1
    assert (first.stats["store_allocate_n"] + s["store_allocate_n"]
            == st.stats["store_allocate_n"])


def _events_by_name(prof):
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append(e)
    return out


def test_profiler_ranges_nest_with_request_ids(params, store):
    kind, st = store
    eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
        model_id=f"ranges-{kind}", max_slots=2, total_pages=32),
        store=st, device="cpu")
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        eng.run([ts.Request(f"q{i}", p, max_new_tokens=5)
                 for i, p in enumerate(_prompts(4, (33, 40)))])
    ev = _events_by_name(prof)
    parents = {"engine.probe": "engine.admit",
               "engine.prefill": "engine.admit",
               "engine.decode.dispatch": "engine.decode",
               "engine.decode.wait": "engine.decode",
               "engine.offload.gather": "engine.offload",
               "engine.offload.write": "engine.offload",
               "engine.offload.ack": "engine.offload.write",
               "store.allocate": "engine.offload.write",
               "store.stage": "engine.offload.write",
               ("store.commit" if kind == "shm" else "store.send"):
               "engine.offload.write"}
    for child, parent in parents.items():
        assert ev.get(child), child
        for e in ev[child]:
            assert e.cpu_parent is not None and e.cpu_parent.name == parent
    for name in ("engine.admit", "engine.probe", "engine.prefill",
                 "engine.offload", "engine.offload.write"):
        assert sorted(e.kwinputs["rid"] for e in ev[name]) == ["q0", "q1"]
    offload = ev["engine.offload"][0].kwinputs
    assert offload["pages"] > 0
    assert offload["bytes"] == offload["pages"] * CFG.kv_page_bytes()
    assert ev["store.allocate"][0].kwinputs["pages"] == offload["pages"]
    assert len(ev["engine.admit"]) == eng.stats["admit_n"] == 2
    assert len(ev["engine.decode"]) == eng.stats["decode_n"]


def test_no_range_without_a_profiler(params, server, monkeypatch):
    opened = []
    real = profiling._open_range

    def counting(*a):
        opened.append(a[0])
        return real(*a)

    monkeypatch.setattr(profiling, "_open_range", counting)
    conn, st = _store(server, TYPE_STREAM)
    try:
        eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
            model_id="no-range", max_slots=2, total_pages=32), store=st,
            device="cpu")
        eng.run([ts.Request("n", _prompts(5, (36,))[0], max_new_tokens=4)])
        assert eng.stats["offload_n"] == 1 and eng.stats["decode_n"] > 0
        assert opened == []
        with profile(activities=[ProfilerActivity.CPU]):
            eng.run([ts.Request("m", _prompts(6, (20,))[0],
                                max_new_tokens=2)])
        assert "engine.admit" in opened and "store.allocate" in opened
    finally:
        st.close()
        conn.close()


def test_span_counts_and_closes_on_an_exception():
    stats = {"other": 1}
    outer = Span(stats, "test.outer", "outer")
    inner = Span(stats, "test.inner", "inner")
    assert stats == {"other": 1, "outer_ns": 0, "outer_n": 0,
                     "inner_ns": 0, "inner_n": 0}
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with pytest.raises(KeyError):
            with outer.of(rid=7, pages=2, nbytes=64):
                with inner:
                    raise KeyError("x")
        with outer:
            pass
    assert stats["outer_n"] == 2 and stats["inner_n"] == 1
    assert stats["outer_ns"] >= stats["inner_ns"] > 0
    ev = _events_by_name(prof)
    assert len(ev["test.outer"]) == 2
    assert ev["test.inner"][0].cpu_parent.name == "test.outer"
    assert ev["test.outer"][0].kwinputs == {"rid": 7, "pages": 2,
                                            "bytes": 64}
    assert ev["test.outer"][1].kwinputs == {}  # arguments do not linger


def test_profile_window_file_holds_engine_and_server_spans(params, server,
                                                           tmp_path):
    conn, st = _store(server, TYPE_STREAM)
    try:
        eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
            model_id="window", max_slots=1, total_pages=32), store=st,
            device="cpu")
        with profile_window(server, trace_dir=str(tmp_path),
                            trace=True) as w:
            eng.run([ts.Request("w0", _prompts(7, (50,))[0],
                                max_new_tokens=3)])
    finally:
        st.close()
        conn.close()
    with gzip.open(w.trace_path, "rt") as f:
        events = json.load(f)["traceEvents"]
    offload = [e for e in events if e.get("name") == "engine.offload"]
    assert len(offload) == 1 and offload[0]["args"]["rid"] == "w0"
    assert offload[0].get("pid") != 1
    lo = float(offload[0]["ts"]) - w.clock_offset_err_us
    hi = lo + float(offload[0]["dur"]) + 2 * w.clock_offset_err_us
    server_spans = [e for e in events
                    if e.get("pid") == 1 and e.get("ph") == "X"]
    assert server_spans
    # The offload's writes, as the server recorded them, lie inside the
    # engine's range once both are on the torch clock.
    assert any(lo <= float(e["ts"]) <= hi for e in server_spans)
    names = {e.get("name") for e in events}
    assert {"engine.admit", "engine.prefill", "engine.decode",
            "store.allocate", "store.send"} <= names


def test_stats_endpoint_serves_the_new_counters(params, server):
    conn, st = _store(server, TYPE_SHM)
    eng = ts.ServingEngine(params, CFG, ts.ServingConfig(
        model_id="http", max_slots=1, total_pages=32), store=st,
        device="cpu")
    web = ServingHTTPServer(eng)
    port = web.start()
    try:
        body = json.dumps({"prompt": _prompts(8, (34,))[0],
                           "max_new_tokens": 3, "stream": False})
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=body.encode(),
            method="POST"), timeout=60).read()
        served = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=10).read())["engine"]
    finally:
        web.shutdown()
        st.close()
        conn.close()
    for key in COUNTERS + tuple(f"{k}_{s}" for k in ENGINE_SPANS
                                + STORE_SPANS for s in ("ns", "n")):
        assert isinstance(served[key], int), key
    assert served["admit_n"] == served["queue_wait_n"] == 1
    assert served["decode_dispatch_n"] >= 1
    assert served["offload_n"] == served["store_commit_n"] == 1
    assert served["offload_bytes"] > 0

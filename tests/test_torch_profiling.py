"""The port's ``utils.profiling.profile_window`` against the port's server,
held to the JAX package's profiling tests case by case:
``tests/test_trace.py:322`` (clip + merge), ``:400`` (trace needs a
server), ``tests/test_checkpoint.py:82`` (op deltas),
``tests/test_control_plane.py:141`` (reclaim counters) and ``:188``
(gauges are levels). The merge runs the real ``torch.profiler`` here on
the CPU (on a card it also records CUDA activity), and the store spans
land on the torch timeline's clock, aligned at the window's open.
Tolerances: counts exact; the clock alignment to its measured interval."""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM, TYPE_STREAM)
from infinistore_tpu_torch.sharded import ShardedConnection
from infinistore_tpu_torch.utils import profile_window
from infinistore_tpu_torch.utils import profiling


def _conn(srv, ctype, trace=False):
    c = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=ctype, trace=trace))
    c.connect()
    return c


@pytest.fixture(scope="module")
def traced():
    """A workers=2 server with tracing on and a traced STREAM client
    that ran a known put + get workload (``tests/test_trace.py``)."""
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.01, minimal_allocate_size=16,
        workers=2, trace=True))
    srv.start()
    conn = _conn(srv, TYPE_STREAM, trace=True)
    for i in range(12):
        conn.put_cache(np.full(16384, i, dtype=np.uint8), [(f"tr{i}", 0)],
                       16384)
        conn.sync()
        dst = np.zeros(16384, dtype=np.uint8)
        conn.read_cache(dst, [(f"tr{i}", 0)], 16384)
        conn.sync()
        assert dst[0] == i
    yield srv, conn
    conn.close()
    srv.stop()


def test_profile_window_trace_merge(traced, tmp_path):
    """profile_window(trace=True) drains the store-side rings, clips them
    to the window, and merges them with the torch profiler's trace under
    trace_dir into one Perfetto-loadable gzip file."""
    srv, conn = traced
    with profile_window(srv, trace_dir=None, trace=True) as w0:
        pass  # pre-window spans must be clipped out of the NEXT window
    assert w0.store_trace is not None
    with profile_window(srv, trace=True) as wclip:
        conn.put_cache(np.zeros(16384, dtype=np.uint8), [("pwm0", 0)],
                       16384)
        conn.sync()
        win_id = conn.last_trace_id
    span_ids = {
        e.get("args", {}).get("trace_id")
        for e in wclip.store_trace["traceEvents"] if e.get("ph") == "X"
    }
    assert f"0x{win_id:x}" in span_ids
    full_spans = sum(1 for e in srv.trace()["traceEvents"]
                     if e.get("ph") == "X")
    clipped = [e for e in wclip.store_trace["traceEvents"]
               if e.get("ph") == "X"]
    assert 0 < len(clipped) < full_spans
    assert wclip.op_deltas.get("PUT", 0) == 1
    assert wclip.trace_path is None  # no trace_dir: nothing written
    # The merge: a window WITH trace_dir lands both planes in one file.
    with profile_window(srv, trace_dir=str(tmp_path), trace=True) as w:
        conn.put_cache(np.zeros(16384, dtype=np.uint8), [("pwm1", 0)],
                       16384)
        conn.sync()
        x = torch.ones(64, 64)
        (x @ x).sum().item()
    assert w.trace_path and w.trace_path.endswith(".trace.json.gz")
    assert os.path.exists(w.trace_path)
    with gzip.open(w.trace_path, "rt") as f:
        merged = json.load(f)
    store_spans = [e for e in merged["traceEvents"]
                   if e.get("pid") == 1 and e.get("ph") == "X"]
    assert store_spans
    assert any(e.get("name") == "aten::mm" for e in merged["traceEvents"]), \
        "the torch timeline's events survive the merge"


def test_profile_window_aligns_the_two_clocks(traced, tmp_path):
    """The store spans of a window, moved onto the torch clock by the
    offset measured at the window's open, fall inside the torch
    profiler's own span of the window."""
    srv, conn = traced
    with profile_window(srv, trace_dir=str(tmp_path), trace=True) as w:
        conn.put_cache(np.zeros(16384, dtype=np.uint8), [("pwa", 0)],
                       16384)
        conn.sync()
        win_id = conn.last_trace_id
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum().item()
    assert w.clock_offset_us is not None
    assert 0 <= w.clock_offset_err_us < 1e4
    with gzip.open(w.trace_path, "rt") as f:
        events = json.load(f)["traceEvents"]
    torch_x = [e for e in events
               if e.get("ph") == "X" and e.get("pid") != 1]
    start = min(float(e["ts"]) for e in torch_x
                if e.get("name", "").startswith(profiling._MARKER))
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in torch_x)
    mine = [e for e in events
            if e.get("pid") == 1 and e.get("ph") == "X"
            and e.get("args", {}).get("trace_id") == f"0x{win_id:x}"]
    assert mine
    slack = w.clock_offset_err_us
    for e in mine:
        assert start - slack <= e["ts"] <= end + slack, (e, start, end)


def test_profile_window_trace_requires_server():
    class NoTrace:
        def stats(self):
            return {}

    with pytest.raises(ValueError):
        with profile_window(NoTrace(), trace=True):
            pass


@pytest.fixture(scope="module")
def port_server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=16))
    srv.start()
    yield srv
    srv.stop()


def test_profile_window_op_deltas(port_server):
    """The profiling window attributes exactly the workload's store ops
    and byte counts to itself (``tests/test_checkpoint.py:82``)."""
    shm_conn = _conn(port_server, TYPE_SHM)
    try:
        page = 1024
        src = np.random.default_rng(1234).random(page).astype(np.float32)
        with profile_window(shm_conn) as w:
            shm_conn.put_cache(src, [("prof_key", 0)], page)
            shm_conn.sync()
            dst = np.zeros_like(src)
            shm_conn.read_cache(dst, [("prof_key", 0)], page)
            shm_conn.sync()
        assert np.array_equal(src, dst)
        assert w.op_deltas.get("ALLOCATE", 0) >= 1
        # SHM puts move payload one-sided, but the small read rides the
        # socket's server-push path: its payload shows up as bytes_out.
        assert w.op_deltas.get("bytes_out", 0) >= src.nbytes
        with profile_window(shm_conn) as w2:
            pass
        assert w2.op_deltas.get("ALLOCATE", 0) == 0
    finally:
        shm_conn.close()


def test_profile_window_sums_a_sharded_connection():
    """Over a ShardedConnection the op deltas sum across its shards."""
    servers = [InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.03125, minimal_allocate_size=16))
        for _ in range(3)]
    for s in servers:
        s.start()
    sc = ShardedConnection([ClientConfig(
        host_addr="127.0.0.1", service_port=s.service_port,
        connection_type=TYPE_STREAM) for s in servers])
    sc.connect()
    try:
        page = 512
        keys = [f"pws{i}" for i in range(24)]
        src = np.zeros(24 * page, dtype=np.uint8)
        with profile_window(sc) as w:
            sc.put_cache(src, [(k, i * page) for i, k in enumerate(keys)],
                         page)
            sc.sync()
        # One batched allocate + write a shard.
        assert w.op_deltas.get("ALLOCATE", 0) == 3
        assert w.op_deltas.get("WRITE", 0) == 3
        assert w.op_deltas.get("bytes_in", 0) >= src.nbytes
    finally:
        sc.close()
        for s in servers:
            s.stop()


def test_profile_window_deltas_reclaim_gauges():
    """op_deltas includes the reclaim pipeline counters: a window
    containing pool pressure shows reclaim_runs > 0, and an idle window
    deltas nothing (``tests/test_control_plane.py:141``)."""
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=1.0 / 1024, minimal_allocate_size=16,
        enable_eviction=True))
    srv.start()
    conn = _conn(srv, TYPE_STREAM)
    try:
        with profile_window(srv) as idle:
            pass
        assert "reclaim_runs" not in idle.op_deltas
        with profile_window(srv) as w:
            blk = 16384
            for i in range(160):  # working set ~2.5x the pool
                conn.put_cache(np.zeros(blk, dtype=np.uint8),
                               [(f"rw{i}", 0)], blk)
            conn.sync()
        assert w.op_deltas.get("PUT", 0) == 160
        assert w.op_deltas.get("reclaim_runs", 0) > 0
        for key in ("hard_stalls", "spills_cancelled", "evictions"):
            assert w.op_deltas.get(key, 0) >= 0
        assert w.op_deltas.get("evictions", 0) > 0
    finally:
        conn.close()
        srv.stop()


def test_profile_window_gauges_are_levels(tmp_path):
    """Queue-depth gauges are levels, not counters: never deltaed into
    op_deltas, snapshot at both edges into window.gauges
    (``tests/test_control_plane.py:188``)."""
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=1.0 / 1024, minimal_allocate_size=16,
        ssd_path=str(tmp_path), ssd_size=4.0 / 1024))
    srv.start()
    conn = _conn(srv, TYPE_STREAM)
    try:
        blk = 16384
        for i in range(160):
            conn.put_cache(np.zeros(blk, dtype=np.uint8), [(f"gw{i}", 0)],
                           blk)
        conn.sync()
        with profile_window(srv) as w:
            queued = 0
            for _ in range(40):
                res = conn.prefetch([f"gw{i}" for i in range(160)],
                                    wait=True)
                queued += res["queued"]
                if queued:
                    break
                time.sleep(0.05)
            assert queued > 0, res
            deadline = time.time() + 10
            while (time.time() < deadline
                   and srv.stats()["promote_queue_depth"] > 0):
                time.sleep(0.02)
        assert set(w.gauges) == {"promote_queue_depth", "spill_queue_depth"}
        for name, (open_lvl, close_lvl) in w.gauges.items():
            assert open_lvl >= 0 and close_lvl >= 0, (name, w.gauges)
        assert "promote_queue_depth" not in w.op_deltas
        assert "spill_queue_depth" not in w.op_deltas
        assert (w.op_deltas.get("promotes_async", 0)
                + w.op_deltas.get("promotes_cancelled", 0)) >= queued
    finally:
        conn.close()
        srv.stop()

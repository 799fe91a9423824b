"""Tracing/profiling helpers joining the two observability planes (the
port of ``infinistore_tpu/utils/profiling.py``).

The store side publishes native per-op latency histograms (/stats,
/metrics) AND — with ``ServerConfig(trace=True)`` / ``--trace`` /
``ISTPU_TRACE=1`` — per-worker span rings drained as Chrome trace-event
JSON (/trace; beyond the reference, which has only ad-hoc chrono logs,
``infinistore.cpp:1114``); the engine side has ``torch.profiler``. This
module glues them for one workload window:

    with profile_window(server, trace_dir="/tmp/tb", trace=True) as w:
        run_workload()
    print(w.op_deltas)      # store ops (and reclaim runs) in the window
    print(w.trace_path)     # ONE Perfetto file: store spans + torch trace

``op_deltas`` subtracts the server's cumulative per-op COUNTERS across
the window — including the reclaim/read pipeline counters
(``reclaim_runs``, ``hard_stalls``, ``spills_cancelled``,
``promotes_async``, ``disk_reads_inline``), so a window shows whether
background reclaim or promotion ran inside it. Queue-depth GAUGES
(``spill_queue_depth``, ``promote_queue_depth``) are levels, not
counters — they land in ``window.gauges`` as (open, close) snapshots
instead of meaningless deltas. ``trace=True`` additionally drains
the store-side span rings at window close, clips them to the window
(both sides of the native plane share CLOCK_MONOTONIC) and merges them
with the torch profiler timeline (CPU ops and, on a card, its CUDA
kernels and copies) into a single Perfetto-loadable file, on one time
axis (see :func:`_clock_offset_us`).

The serving engine and ``CudaKVStore`` time their own layers with
:class:`Span`: each span always adds its duration and one count to a
counter pair of its owner's ``stats``, and while a torch profiler runs it
also records a profiler range (a child of the range it runs inside,
its request id, pages and bytes as arguments), on the clock of the
profiler's device trace. A ``profile_window(trace_dir=...)`` file so
holds the engine's and the store client's spans, the kernels and the
store server's spans on one axis.
"""

import glob
import gzip
import json
import os
import time
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _autograd_profiler

# Cumulative top-level stats COUNTERS worth windowing alongside the
# per-op table: traffic, the reclaim pipeline counters and the read
# pipeline counters (a window with nonzero reclaim_runs /
# disk_reads_inline explains its own tail).
_WINDOW_COUNTERS = (
    "bytes_in",
    "bytes_out",
    "reclaim_runs",
    "hard_stalls",
    "spills_cancelled",
    "evictions",
    "spills",
    "promotes",
    "promotes_async",
    "promotes_cancelled",
    "disk_reads_inline",
)

# Queue-depth GAUGES are LEVELS, not counters: deltaing them across the
# window (after - before) would report e.g. "-3 spills queued" when a
# busy queue drained, and 0 when a window entered and left equally
# backlogged — both meaningless. They are SNAPSHOT at both edges
# instead and land in ``window.gauges`` as (before, after) pairs.
_WINDOW_GAUGES = (
    "spill_queue_depth",
    "promote_queue_depth",
)

# Markers recorded at the window's open to align the torch timeline
# with the store's clock; the first one pays the profiler's warm-up.
_MARKER = "profile_window.open"
_N_MARKERS = 3


def _open_range(name, rid, pages, nbytes):
    """An entered profiler range named ``name`` whose arguments (shown
    in traces recorded with ``record_shapes``) are the given ones."""
    args = {}
    if rid is not None:
        args["rid"] = rid if isinstance(rid, (int, str)) else str(rid)
    if pages is not None:
        args["pages"] = int(pages)
    if nbytes is not None:
        args["bytes"] = int(nbytes)
    # The C++ range of torch.profiler.record_function, which keeps
    # keyword arguments (the Python one drops its argument string).
    rng = torch._C._profiler._RecordFunctionFast(name, [], args)
    rng.__enter__()
    return rng


class Span:
    """A named timer that adds into the counter pair ``<key>_ns`` /
    ``<key>_n`` of the dict ``stats`` (set to 0 here if absent):

        admit = Span(engine.stats, "engine.admit", "admit")
        with admit.of(rid=request_id):
            ...

    With no profiler running, a use costs a flag check and two reads of
    ``time.perf_counter_ns``: no allocation, no formatting, no device
    sync. While a torch profiler runs it also opens a profiler range
    named ``name`` around the timed interval, with ``rid``, ``pages``
    and ``bytes`` as its arguments. A span object times one interval at
    a time: its owner uses it from one thread, and never inside itself.
    """

    __slots__ = ("name", "_stats", "_ns", "_n", "_t0", "_range", "_rid",
                 "_pages", "_bytes")

    def __init__(self, stats, name, key):
        self.name = name
        self._stats = stats
        self._ns, self._n = f"{key}_ns", f"{key}_n"
        stats.setdefault(self._ns, 0)
        stats.setdefault(self._n, 0)
        self._t0 = 0
        self._range = self._rid = self._pages = self._bytes = None

    def of(self, rid=None, pages=None, nbytes=None):
        """This span, with the arguments its next profiler range takes."""
        self._rid, self._pages, self._bytes = rid, pages, nbytes
        return self

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = _open_range(self.name, self._rid, self._pages,
                                      self._bytes)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter_ns() - self._t0
        stats = self._stats
        stats[self._ns] += dt
        stats[self._n] += 1
        self._rid = self._pages = self._bytes = None
        rng = self._range
        if rng is not None:
            self._range = None
            rng.__exit__(exc_type, exc, tb)
        return False


def _op_counts(stats):
    if isinstance(stats, list):  # ShardedConnection.stats(): per-shard
        merged = {}
        for shard in stats:
            for k, v in _op_counts(shard).items():
                merged[k] = merged.get(k, 0) + v
        return merged
    out = {}
    for op, s in (stats.get("op_stats") or {}).items():
        out[op] = int(s.get("count", 0))
    for key in _WINDOW_COUNTERS:
        out[key] = int(stats.get(key, 0))
    return out


def _gauge_levels(stats):
    """Current LEVEL of each windowed gauge (summed across shards for a
    ShardedConnection stats list)."""
    if isinstance(stats, list):
        merged = {}
        for shard in stats:
            for k, v in _gauge_levels(shard).items():
                merged[k] = merged.get(k, 0) + v
        return merged
    return {
        key: int(stats.get(key, 0))
        for key in _WINDOW_GAUGES
        if key in stats
    }


_MERGED_NAME = "merged.trace.json.gz"


class ProfileWindow:
    def __init__(self):
        self.op_deltas = {}
        # Queue-depth gauges, snapshot at both window edges:
        # {name: (level_at_open, level_at_close)} — levels, never
        # deltas (see _WINDOW_GAUGES).
        self.gauges = {}
        self.stats_before = {}
        self.stats_after = {}
        # trace=True outputs
        self.store_trace = None  # dict: {"traceEvents": [...]}, store clock
        self.trace_path = None   # merged Perfetto file on disk
        # trace_dir outputs: the torch timeline's clock minus the
        # store's (µs), and the half-width of the interval it lies in.
        self.clock_offset_us = None
        self.clock_offset_err_us = None


def _store_trace_source(obj):
    """Find a store-side trace getter on ``obj`` (InfiniStoreServer
    exposes ``trace()``; anything duck-typed alike works)."""
    fn = getattr(obj, "trace", None)
    return fn if callable(fn) else None


def _mono_us():
    """The store spans' clock: CLOCK_MONOTONIC in µs (utils.cc now_us)."""
    return time.clock_gettime(time.CLOCK_MONOTONIC) * 1e6


def _open_markers(record_function):
    """Record _N_MARKERS empty profiler ranges, each between two reads of
    the store's clock; returns the [(before, after)] reads."""
    reads = []
    for i in range(_N_MARKERS):
        before = _mono_us()
        with record_function(f"{_MARKER}.{i}"):
            pass
        reads.append((before, _mono_us()))
    return reads


def _clock_offset_us(events, reads):
    """The torch timeline's clock minus the store's, in µs, from the
    window-open markers: (offset, half-width of its interval).

    Kineto stamps its events on its own clock (wall-clock µs less a
    base, not CLOCK_MONOTONIC), so the two timelines are aligned at the
    window's open by measurement rather than by assumption: a marker
    range [ts, ts + dur] on the torch clock lies inside the store-clock
    reads [before, after] taken around it, so the offset lies in
    [ts + dur - after, ts - before]. The tightest marker's interval
    wins; its midpoint is the offset, its half-width the error."""
    best = None
    for i, (before, after) in enumerate(reads):
        ev = next((e for e in events
                   if e.get("name") == f"{_MARKER}.{i}"
                   and e.get("ph") == "X"), None)
        if ev is None:
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0))
        lo, hi = ts + dur - after, ts - before
        if best is None or hi - lo < best[1] - best[0]:
            best = (lo, hi)
    if best is None:
        return None, None
    return (best[0] + best[1]) / 2, (best[1] - best[0]) / 2


def _shifted(events, offset_us):
    """Store events moved onto the torch clock (metadata unchanged)."""
    out = []
    for ev in events:
        if "ts" in ev and ev.get("ph") != "M":
            ev = dict(ev, ts=ev["ts"] + offset_us)
        out.append(ev)
    return out


def _merge_perfetto(trace_dir, store_events):
    """Merge the store spans into the newest torch profiler trace under
    ``trace_dir`` (``*.trace.json.gz``); fall back to a store-only file
    when the profiler wrote nothing. Returns the merged file's path.
    The caller has already put the store spans on the torch clock."""
    merged = {"traceEvents": []}
    # Exclude our own output: a later window against the same trace_dir
    # must not pick a previous merged file as its torch base and
    # re-accumulate the earlier window's store spans.
    candidates = sorted(
        (
            p
            for p in glob.glob(
                os.path.join(trace_dir, "**", "*.trace.json.gz"),
                recursive=True,
            )
            if os.path.basename(p) != _MERGED_NAME
        ),
        key=os.path.getmtime,
    )
    if candidates:
        with gzip.open(candidates[-1], "rt") as f:
            merged = json.load(f)
        if not isinstance(merged.get("traceEvents"), list):
            merged["traceEvents"] = []
    merged["traceEvents"].extend(store_events)
    out_path = os.path.join(trace_dir, _MERGED_NAME)
    with gzip.open(out_path, "wt") as f:
        json.dump(merged, f)
    return out_path


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # Shapes recorded: the program's spans carry their arguments
    # (request id, pages, bytes) into the trace only so.
    prof = profile(activities=activities, record_shapes=True)
    prof.start()
    return prof, _open_markers(record_function)


@contextmanager
def profile_window(conn_or_server=None, trace_dir=None, trace=False):
    """Profile one workload window.

    conn_or_server: anything with ``.stats()`` (InfinityConnection,
        ShardedConnection or InfiniStoreServer) — per-op counter deltas
        land in ``window.op_deltas``. Optional.
    trace_dir: when set, wraps the window in ``torch.profiler`` (CPU
        activity, and CUDA activity where a card is present); its
        timeline lands there as ``torch.<pid>.<ns>.trace.json.gz``
        (Chrome trace JSON, Perfetto-loadable), with the program's
        :class:`Span` ranges and their arguments.
    trace: when True, also drain the STORE-side span rings at window
        close (requires ``conn_or_server`` to expose ``.trace()`` — an
        ``InfiniStoreServer`` whose config enables tracing; the rings
        live server-side, so a plain client cannot drain them) and
        merge them with the torch trace into ``window.trace_path``
        (``<trace_dir>/merged.trace.json.gz``, the store spans shifted
        onto the torch clock; store-only file when the profiler wrote
        no timeline; ``window.store_trace`` always gets the span dict,
        on the store's clock, even without a trace_dir).
    """
    w = ProfileWindow()
    trace_fn = None
    if trace:
        trace_fn = _store_trace_source(conn_or_server)
        if trace_fn is None:
            raise ValueError(
                "profile_window(trace=True) needs an object with a "
                ".trace() method (InfiniStoreServer); clients cannot "
                "drain the server-side span rings"
            )
    if conn_or_server is not None:
        w.stats_before = conn_or_server.stats()
    # Window start on the native spans' clock (CLOCK_MONOTONIC µs —
    # utils.cc now_us): ring entries from before the window are clipped
    # out of the merged export.
    t0_us = _mono_us()
    prof = reads = None
    if trace_dir is not None:
        os.makedirs(str(trace_dir), exist_ok=True)
        prof, reads = _start_profiler()
    try:
        yield w
    finally:
        torch_path = None
        if prof is not None:
            prof.stop()
            torch_path = os.path.join(
                str(trace_dir),
                f"torch.{os.getpid()}.{time.time_ns()}.trace.json.gz")
            prof.export_chrome_trace(torch_path)
        if conn_or_server is not None:
            w.stats_after = conn_or_server.stats()
            before = _op_counts(w.stats_before)
            after = _op_counts(w.stats_after)
            w.op_deltas = {
                k: after.get(k, 0) - before.get(k, 0)
                for k in after
                if after.get(k, 0) != before.get(k, 0)
            }
            g0 = _gauge_levels(w.stats_before)
            g1 = _gauge_levels(w.stats_after)
            w.gauges = {
                k: (g0.get(k, 0), g1.get(k, 0))
                for k in sorted(set(g0) | set(g1))
            }
        if torch_path is not None:
            with gzip.open(torch_path, "rt") as f:
                torch_events = json.load(f).get("traceEvents", [])
            w.clock_offset_us, w.clock_offset_err_us = _clock_offset_us(
                torch_events, reads)
        if trace_fn is not None:
            full = trace_fn()
            events = [
                ev
                for ev in full.get("traceEvents", [])
                if ev.get("ph") == "M"
                or ev.get("ts", 0) + ev.get("dur", 0) >= t0_us
            ]
            w.store_trace = {"traceEvents": events}
            if trace_dir is not None:
                w.trace_path = _merge_perfetto(
                    str(trace_dir),
                    _shifted(events, w.clock_offset_us or 0.0))


__all__ = ["profile_window", "ProfileWindow", "Span"]

"""Server CLI + management control plane.

Parity target: reference ``infinistore/server.py`` (C13 in SURVEY.md §2):
argparse flags, a FastAPI/uvicorn manage plane with ``POST /purge``,
``GET /kvmap_len`` and ``POST /selftest/{port}``, optional warmup
subprocess (``--warmup``: ``python -m infinistore_tpu_torch.warmup``),
and OOM-score protection.
FastAPI/uvicorn are not available in this environment, so the manage
plane is a stdlib ThreadingHTTPServer with the same endpoints
(+ ``GET /stats`` and ``GET /health`` beyond parity).

Unlike the reference — which embeds its libuv loop *inside* the Python
uvloop (lib.py:193-204, infinistore.cpp:1276-1285) — the native server
here runs its own epoll loop on a dedicated thread, so the Python process
only hosts the control plane and stays fully responsive.
"""

import argparse
import ctypes as ct
import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import _native
from .config import ServerConfig
from .lib import Logger, set_log_level


class InfiniStoreServer:
    """Owns the native server instance. Usable programmatically (tests,
    benchmarks) or via the ``infinistore-tpu`` CLI."""

    def __init__(self, config: ServerConfig):
        config.verify()
        self.config = config
        self._lib = _native.get_lib()
        set_log_level(config.log_level)
        self._h = None
        self.service_port = None

    def start(self):
        if self._h is not None:
            raise Exception("server already started")
        cfg = self.config
        self._h = self._lib.ist_server_create(
            cfg.host.encode(),
            cfg.service_port,
            int(cfg.prealloc_size * (1 << 30)),
            cfg.minimal_allocate_size << 10,
            1 if cfg.auto_increase else 0,
            int(cfg.extend_size * (1 << 30)),
            1 if cfg.enable_shm else 0,
            cfg.shm_prefix.encode(),
            1 if cfg.enable_eviction else 0,
            cfg.ssd_path.encode(),
            int(cfg.ssd_size * (1 << 30)),
            int(cfg.max_outq_size * (1 << 20)),
            int(cfg.workers),
            ct.c_double(cfg.reclaim_high),
            ct.c_double(cfg.reclaim_low),
            1 if cfg.trace else 0,
            1 if cfg.promote else 0,
            cfg.engine.encode(),
            1 if cfg.watchdog else 0,
            cfg.bundle_dir.encode(),
            int(cfg.bundle_keep),
        )
        port = self._lib.ist_server_start(self._h)
        if port < 0:
            self._lib.ist_server_destroy(self._h)
            self._h = None
            raise Exception(
                "failed to start server (bind error, or engine="
                f"{cfg.engine!r} unsupported on this kernel — see the "
                "native log)"
            )
        self.service_port = port
        return port

    def stop(self):
        if self._h is not None:
            self._lib.ist_server_stop(self._h)
            self._lib.ist_server_destroy(self._h)
            self._h = None

    def kvmap_len(self):
        return int(self._lib.ist_server_kvmap_len(self._h))

    def purge(self):
        return int(self._lib.ist_server_purge(self._h))

    def _read_blob(self, fn, initial=65536):
        """Call a snprintf-style native getter (returns the REQUIRED
        length; copies at most cap-1 bytes) and regrow until the whole
        blob fits — the stats JSON (histogram buckets x ops x workers)
        and especially the trace export outgrow any fixed buffer."""
        cap = initial
        while True:
            buf = ct.create_string_buffer(cap)
            n = int(fn(self._h, buf, cap))
            if n < 0:
                raise Exception("native blob read failed")
            if n < cap:
                return buf.value.decode()
            cap = n + 1

    def stats(self):
        return json.loads(self._read_blob(self._lib.ist_server_stats))

    def trace_json(self):
        """Drain the span rings as Chrome trace-event JSON text
        (Perfetto-loadable; served raw by ``GET /trace``). With tracing
        off (no ``trace=True`` / ``--trace`` / ``ISTPU_TRACE=1``) the
        event list is empty."""
        return self._read_blob(self._lib.ist_server_trace, initial=1 << 20)

    def trace(self):
        """``trace_json`` parsed into a dict ({"traceEvents": [...]})."""
        return json.loads(self.trace_json())

    def events(self, since_seq=0):
        """Drain the always-on flight recorder (native/src/events.h) as
        a dict: ``{"events": [{seq, t_us, track, name, severity, a0,
        a1}...], "recorded", "overwritten", "capacity", "enabled"}``.
        ``since_seq`` filters to events newer than a previously
        observed high-water mark (``stats()["events"]["recorded"]``).
        Served raw by ``GET /events``."""
        return json.loads(self._read_blob(
            lambda h, buf, cap: self._lib.ist_server_events(
                h, int(since_seq), buf, cap)))

    def debug_state(self):
        """Deep-state introspection (``GET /debug/state``): per-
        connection protocol phase / in-flight bytes / current op,
        per-worker queue depth + heartbeat + uring slot occupancy,
        per-stripe entry/byte counts with LRU-age histograms and
        pool/disk/limbo location mix, per-arena pool fragmentation,
        and the spill/promote queue summaries."""
        return json.loads(
            self._read_blob(self._lib.ist_server_debug_state)
        )

    def history(self):
        """Metrics-history ring (``GET /history``): the overwrite-
        oldest ring of ~1 Hz stats snapshots (occupancy, queue depths,
        counter + latency-histogram deltas, breaker/degraded flags),
        oldest first — sampled on the native watchdog thread every
        ``watchdog_interval_ms``, included in every watchdog bundle as
        ``history.json``, rendered as sparklines by tools/istpu_top.py
        and consumed by :class:`SLOTracker` for burn rates. Survives
        ``purge()`` (gauges reset in later samples; the ring itself is
        never cleared)."""
        return json.loads(
            self._read_blob(self._lib.ist_server_history)
        )

    def workload(self):
        """Workload observability plane (``GET /workload``): the
        always-on profiler's demand model — the online miss-ratio
        curve over hypothetical pool sizes {¼, ½, 1, 2, 4}× (SHARDS
        spatially-hashed reuse-distance sampling, byte-weighted),
        the working-set-size estimate, ghost-ring eviction-quality
        counters (``premature_evictions`` = get-misses on recently
        evicted keys, ``thrash_cycles`` = spill→promote round trips),
        the projected dedup ratio over sampled content fingerprints
        and the hash-prefix heat classes. ``ISTPU_WORKLOAD=0`` (the
        bench denominator only) disables recording; ``purge()``
        clears the ghost rings and reuse stacks but never the
        cumulative counters."""
        return json.loads(
            self._read_blob(self._lib.ist_server_workload)
        )

    def slo_trip(self, detail, a0=0, a1=0):
        """Fire the ``slo_burn`` watchdog verdict (the SLO tracker's
        trigger): emits the ``watchdog.slo_burn`` catalog event, counts
        the trip and captures a diagnostic bundle like the native
        verdict kinds. Returns True when the verdict fired, False while
        the per-kind cooldown holds."""
        return int(self._lib.ist_server_slo_trip(
            self._h, str(detail).encode(), int(a0), int(a1)
        )) == 1

    def fault(self, spec):
        """Arm/disarm failpoints from a spec string (grammar in
        native/src/failpoint.h): ``"name=policy[:action];..."`` with
        policies ``off | once | every(N) | prob(P) | count(K)`` and
        actions ``err[(errno)] | short | delay(us) | kill``; the bare
        word ``"off"`` disarms everything. Returns the number of
        points touched; raises on a parse error (all-or-nothing —
        nothing from a bad spec is applied). Also reachable as
        ``POST /fault`` on the manage plane and the ``ISTPU_FAILPOINTS``
        env var at server start."""
        err = ct.create_string_buffer(256)
        n = int(self._lib.ist_server_fault(
            self._h, spec.encode(), err, len(err)))
        if n < 0:
            raise ValueError(
                f"failpoint spec rejected: {err.value.decode()}"
            )
        return n

    def faults(self):
        """Every registered failpoint with its current arming and fire
        count: ``{"failpoints": [{name, spec, fired}], "fired_total"}``
        (``GET /fault`` serves the same blob)."""
        return json.loads(
            self._read_blob(self._lib.ist_server_fault_list, initial=8192)
        )

    def snapshot(self, path):
        """Write every committed entry to ``path`` (atomic tmp+rename).
        Returns the entry count; raises on IO failure. Beyond reference
        parity — the reference's store is volatile (restart ⇒ cache
        cold, SURVEY.md §5)."""
        n = int(self._lib.ist_server_snapshot(self._h, path.encode()))
        if n < 0:
            raise Exception(f"snapshot to {path} failed")
        return n

    def snapshot_range(self, path, ring_lo, ring_hi):
        """Range-filtered snapshot (the cluster tier's migration export
        half): every committed entry whose CRC-32 ring coordinate falls
        in ``[ring_lo, ring_hi)`` — wrap-around when lo > hi — in the
        ordinary snapshot format, adopted on the target via
        :meth:`restore`. Returns entries written."""
        n = int(self._lib.ist_server_snapshot_range(
            self._h, path.encode(), int(ring_lo), int(ring_hi)))
        if n < 0:
            raise Exception(f"range snapshot to {path} failed")
        return n

    def delete_range(self, ring_lo, ring_hi):
        """Drop every committed entry in the ring-hash range (the
        migration commit's source-side evict; per-entry epoch bumps
        like delete). Returns entries erased."""
        n = int(self._lib.ist_server_delete_range(
            self._h, int(ring_lo), int(ring_hi)))
        if n < 0:
            raise Exception("delete_range failed")
        return n

    def cluster(self):
        """The native cluster mirror (``GET /directory`` body, minus
        the shard_id the control plane injects): ``{"epoch",
        "migration_phase", "migration_cursor", "migration_total",
        "directory": pushed-blob-or-None}``."""
        return json.loads(
            self._read_blob(self._lib.ist_server_cluster, initial=8192)
        )

    def set_cluster(self, epoch, directory=None, phase=-1, cursor=0,
                    total=0):
        """Push directory/migration state into the native mirror (so
        stats/history carry the epoch and bundles carry cluster.json).
        Returns False when ``epoch`` is OLDER than the stored one
        (nothing applied — the caller answers WRONG_EPOCH)."""
        blob = b"" if directory is None else json.dumps(directory).encode()
        rc = int(self._lib.ist_server_cluster_set(
            self._h, int(epoch), blob, int(phase), int(cursor),
            int(total)))
        return rc == 0

    def migration_trip(self, detail, a0=0, a1=0):
        """Fire the ``watchdog.migration`` verdict (the rebalance
        coordinator's stalled-range trigger): catalog event + trip +
        diagnostic bundle whose cluster.json carries the directory and
        range cursor. False while the per-kind cooldown holds."""
        return int(self._lib.ist_server_migration_trip(
            self._h, str(detail).encode(), int(a0), int(a1)
        )) == 1

    def digest_range(self, ring_lo, ring_hi):
        """Replica-divergence digest over one ring-hash range (the
        anti-entropy MEASUREMENT half): an order-
        independent, process-deterministic mix over the committed
        {key, size} set, so two replicas holding the same range
        produce the same value whatever their stripe layout. Returns
        ``{"lo", "hi", "digest" (hex string — u64 does not survive
        JSON number parsing), "count", "bytes"}``; served by
        ``GET/POST /digest`` for the fleet aggregator."""
        d = ct.c_uint64()
        n = ct.c_uint64()
        b = ct.c_uint64()
        rc = int(self._lib.ist_server_digest_range(
            self._h, int(ring_lo), int(ring_hi),
            ct.byref(d), ct.byref(n), ct.byref(b)))
        if rc != 0:
            raise Exception("digest_range failed")
        return {"lo": int(ring_lo), "hi": int(ring_hi),
                "digest": f"{d.value:016x}",
                "count": int(n.value), "bytes": int(b.value)}

    def cluster_trip(self, kind, detail, a0=0, a1=0):
        """Fire a fleet-aggregator verdict: ``kind`` 0 =
        ``watchdog.replica_divergence``, 1 = ``watchdog.epoch_lag``.
        Catalog event + trip counter + diagnostic bundle under the
        per-kind cooldown (the aggregator then drops fleet.json into
        the bundle). False while cooling."""
        return int(self._lib.ist_server_cluster_trip(
            self._h, int(kind), str(detail).encode(), int(a0), int(a1)
        )) == 1

    def restore(self, path):
        """Load a snapshot (existing keys win; stops when the pool is
        full, keeping what fits; a truncated tail keeps the valid
        prefix and returns its count). Returns entries loaded; raises
        when the file is missing or its header is not a snapshot."""
        n = int(self._lib.ist_server_restore(self._h, path.encode()))
        if n < 0:
            raise Exception(f"restore from {path} failed")
        return n

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class SLOTracker:
    """Multi-window burn-rate SLO tracker over the metrics-history ring
   . Objectives:

    - **latency**: a fraction ``latency_objective`` of ops must finish
      under ``latency_threshold_ms``. Per window, "bad" ops are counted
      from the ring's aggregate latency-histogram deltas — every op in
      a power-of-two bucket whose lower bound is >= the threshold
      (conservative: the threshold's own bucket is not counted).
    - **availability** (store-health proxy): ``disk_io_errors_delta``
      per op must stay under ``1 - availability_objective``. The
      counter covers EVERY tier IO error — foreground reads AND
      background spill/promote writes (a failed background spill is
      absorbed without failing any client op) — so this objective
      burns on store health, not strictly on client-visible failures;
      a flaky tier under spill pressure pages here even while reads
      are 100% healthy, which is the early warning it exists to give.

    Burn rate per window = (bad fraction) / (1 - objective); 1.0 means
    the error budget burns exactly at the sustainable rate. The verdict
    requires BOTH windows (short AND long) over ``burn_threshold`` —
    the standard multi-window guard: the long window proves it is not a
    blip, the short window proves it is still happening.

    ``status()`` computes on demand (``GET /slo``); ``start()`` spawns
    the polling thread that calls :meth:`InfiniStoreServer.slo_trip`
    when burning — the native side emits the ``watchdog.slo_burn``
    event and captures the bundle (with the ring as ``history.json``),
    under the native per-kind cooldown."""

    _LAT_BUCKETS = 20  # LatHist::kBuckets (the ring's lat_delta width)

    def __init__(self, server, latency_threshold_ms=100.0,
                 latency_objective=0.999, availability_objective=0.999,
                 short_window_s=60.0, long_window_s=300.0,
                 burn_threshold=2.0, interval_s=1.0):
        if not (0.0 < latency_objective < 1.0):
            raise ValueError("latency_objective must be in (0, 1)")
        if not (0.0 < availability_objective < 1.0):
            raise ValueError("availability_objective must be in (0, 1)")
        if short_window_s > long_window_s:
            raise ValueError("short window must be <= long window")
        self.server = server
        self.latency_threshold_us = int(latency_threshold_ms * 1000)
        self.latency_objective = float(latency_objective)
        self.availability_objective = float(availability_objective)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.burn_threshold = float(burn_threshold)
        self.interval_s = max(float(interval_s), 0.01)
        self.trips = 0
        self._stop = threading.Event()
        self._thread = None
        # Live-status cache (interval_s TTL): a /metrics scrape, a
        # GET /slo and the verdict thread would otherwise each drain
        # and re-parse the whole 512-sample ring — once per interval
        # is all the signal changes.
        self._cache = None
        self._cache_t = 0.0
        # Smallest bucket counted "bad": lower bound 2^b >= threshold,
        # clamped to the LAST bucket — it is open-ended ([2^19, inf)),
        # so a threshold beyond the histogram range degrades to "ops
        # slower than ~0.52 s count bad" (over-alerting) instead of
        # silently never counting anything (lat_delta[20:] is empty).
        b = 0
        while ((1 << b) < self.latency_threshold_us
               and b < self._LAT_BUCKETS - 1):
            b += 1
        self._bad_bucket = b

    # -- burn-rate math (pure; testable without a server) --------------

    def _window(self, samples, now_us, window_s):
        cut = now_us - int(window_s * 1e6)
        total = bad = errs = 0
        for s in samples:
            if s.get("t_us", 0) < cut:
                continue
            total += s.get("ops_delta", 0)
            errs += s.get("disk_io_errors_delta", 0)
            lat = s.get("lat_delta", [])
            bad += sum(lat[self._bad_bucket:])
        lat_burn = (
            (bad / total) / (1.0 - self.latency_objective)
            if total else 0.0
        )
        avail_burn = (
            (errs / total) / (1.0 - self.availability_objective)
            if total else 0.0
        )
        return {
            "window_s": window_s,
            "ops": total,
            "bad": bad,
            "errors": errs,
            "latency_burn_rate": round(lat_burn, 3),
            "availability_burn_rate": round(avail_burn, 3),
        }

    def status(self, history=None):
        """The ``GET /slo`` blob: objectives + per-window burn rates +
        the current verdict. ``history`` (a pre-fetched ring blob) is
        for tests; normally the live ring is drained — at most once
        per ``interval_s`` (TTL cache shared by the verdict thread,
        /slo and the /metrics families)."""
        if history is None:
            now = time.monotonic()
            if (self._cache is not None
                    and now - self._cache_t < self.interval_s):
                return self._cache
        h = history if history is not None else self.server.history()
        samples = h.get("history", [])
        now_us = h.get("now_us", 0)
        short = self._window(samples, now_us, self.short_window_s)
        long_ = self._window(samples, now_us, self.long_window_s)
        lat_burning = (
            short["latency_burn_rate"] >= self.burn_threshold
            and long_["latency_burn_rate"] >= self.burn_threshold
        )
        avail_burning = (
            short["availability_burn_rate"] >= self.burn_threshold
            and long_["availability_burn_rate"] >= self.burn_threshold
        )
        st = {
            "enabled": bool(h.get("enabled", 0)),
            "latency": {
                "threshold_us": self.latency_threshold_us,
                "objective": self.latency_objective,
            },
            "availability": {
                "objective": self.availability_objective,
            },
            "burn_threshold": self.burn_threshold,
            "short": short,
            "long": long_,
            "burning": lat_burning or avail_burning,
            "latency_burning": lat_burning,
            "availability_burning": avail_burning,
            "trips": self.trips,
        }
        if history is None:
            self._cache = st
            self._cache_t = time.monotonic()
        return st

    # -- verdict thread ------------------------------------------------

    def poll_once(self):
        """One tracker pass; returns the status blob. Fires the native
        slo_burn verdict (event + bundle, native cooldown) when both
        windows burn over threshold."""
        st = self.status()
        if st["burning"]:
            kind = ("latency" if st["latency_burning"]
                    else "availability")
            burn = st["short"][f"{kind}_burn_rate"]
            detail = (
                f"{kind} burn rate {burn}x over budget in both windows "
                f"({self.short_window_s:.0f}s/{self.long_window_s:.0f}s,"
                f" threshold {self.burn_threshold}x)"
            )
            if self.server.slo_trip(detail, int(burn * 1000),
                                    int(self.short_window_s)):
                self.trips += 1
                Logger.warning(f"slo_burn verdict: {detail}")
        return st

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="istpu-slo"
        )
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — keep polling
                Logger.debug(f"slo tracker poll failed: {e}")

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


def _selftest(service_port):
    """RDMA-loopback self-test analogue (reference server.py:41-91):
    write/read/verify a small payload through the real data path."""
    import numpy as np

    from .config import ClientConfig
    from .lib import InfinityConnection

    conn = InfinityConnection(
        ClientConfig(host_addr="127.0.0.1", service_port=service_port)
    )
    try:
        conn.connect()
        src = np.arange(4096, dtype=np.float32)
        key = "selftest_key"
        conn.delete_keys([key])
        blocks = conn.allocate([key], src.nbytes)
        conn.write_cache(src, [0], src.size, blocks)
        conn.sync()
        dst = np.zeros_like(src)
        conn.read_cache(dst, [(key, 0)], src.size)
        conn.sync()
        ok = bool(np.array_equal(src, dst))
        conn.delete_keys([key])
        return ok
    finally:
        conn.close()


def _prometheus_metrics(stats, slo=None, aggregator=None):
    """Render the native stats blob in Prometheus text format
    (observability beyond the reference, which exposes only
    /kvmap_len + /purge + /selftest — reference server.py:29-96).
    ``slo`` (an :class:`SLOTracker`) adds the burn-rate families;
    ``aggregator`` (a :class:`cluster.FleetAggregator`) adds the
    fleet families from its LAST scrape (never a fresh one — a
    metrics pull must not fan out HTTP probes)."""
    g = [  # (stat key, metric name, help)
        ("kvmap_len", "keys", "committed + inflight keys in the index"),
        ("inflight", "inflight_writes", "uncommitted allocations"),
        ("leases", "pin_leases", "active SHM read leases"),
        ("pools", "pools", "DRAM pool count"),
        ("pool_bytes", "pool_bytes", "total DRAM pool capacity"),
        ("used_bytes", "pool_used_bytes", "allocated DRAM pool bytes"),
        ("connections", "connections", "open client connections"),
        ("workers", "workers", "data-plane worker threads"),
        ("disk_bytes", "disk_tier_bytes", "disk spill tier capacity"),
        ("disk_used", "disk_tier_used_bytes", "disk spill tier usage"),
    ]
    g = g + [
        ("spill_queue_depth", "spill_queue_depth",
         "entries queued to the async spill writer"),
        ("promote_queue_depth", "promote_queue_depth",
         "entries queued to the async promotion worker"),
        # Failure model: every degradation an operator must
        # see — a tier gone read-only behind its breaker, a dead
        # background worker running in inline-fallback mode.
        ("tier_breaker_open", "tier_breaker_open",
         "disk-tier write circuit breaker open (1 = stores refused, "
         "pure-pool degraded mode, backoff re-probe pending)"),
        ("workers_dead", "workers_dead",
         "background workers (reclaimer/spill/promote) that died; "
         "their kick paths degrade to inline fallbacks"),
    ]
    c = [
        ("ops", "ops", "requests handled"),
        ("bytes_in", "bytes_in", "payload+metadata bytes received"),
        ("bytes_out", "bytes_out", "payload+metadata bytes sent"),
        ("evictions", "evictions", "entries hard-evicted under pressure"),
        ("spills", "spills", "entries spilled to the disk tier"),
        ("promotes", "promotes", "entries promoted back from disk"),
        ("reclaim_runs", "reclaim_runs",
         "background watermark-reclaim passes"),
        ("hard_stalls", "hard_stalls",
         "allocations that paid inline reclaim (reclaimer behind)"),
        ("spills_cancelled", "spills_cancelled",
         "async spills abandoned (read-cancelled, raced or tier-full)"),
        ("promotes_async", "promotes_async",
         "disk entries promoted by the async promotion worker"),
        ("promotes_cancelled", "promotes_cancelled",
         "async promotions abandoned (raced by delete/re-put/spill, "
         "or pool full)"),
        ("disk_reads_inline", "disk_reads_inline",
         "disk reads paid on the data plane (cold gets served from "
         "their extents + inline promotions)"),
        ("disk_io_errors", "disk_io_errors",
         "disk-tier IO errors (failed pread/pwrite/pwritev, real or "
         "injected); write errors feed the tier circuit breaker"),
        ("failpoints_fired", "failpoints_fired",
         "fault injections fired across all armed failpoints"),
        # Transport engine: all three are 0 under epoll.
        ("uring_sqes", "uring_sqes",
         "io_uring submission queue entries issued by the workers"),
        ("uring_zc_sends", "uring_zc_sends",
         "zero-copy sends (SEND_ZC/SENDMSG_ZC) issued for responses"),
        ("uring_copies_avoided", "uring_copies_avoided",
         "payload bytes moved without a kernel bounce copy (direct "
         "pool reads + zero-copy sends)"),
        # One-sided fabric plane. The ring-plane counters
        # (attaches/commit_records/one_sided_puts/doorbells) move only
        # under engine=fabric; fabric_writes is protocol-level — the
        # cross-host OP_FABRIC_WRITE rides the shared state machine
        # and counts on ANY engine serving a use_fabric client.
        ("fabric_attaches", "fabric_attaches",
         "per-connection shm commit rings attached (OP_FABRIC_ATTACH "
         "grants on the fabric engine)"),
        ("fabric_commit_records", "fabric_commit_records",
         "commit records drained from the shm doorbell rings"),
        ("fabric_one_sided_puts", "fabric_one_sided_puts",
         "keys committed whose payload the server never touched (the "
         "client wrote it one-sided; the commit arrived via the ring)"),
        ("fabric_doorbells", "fabric_doorbells",
         "doorbell frames received (sent only when the worker "
         "advertised an idle ring)"),
        ("fabric_writes", "fabric_writes",
         "keys carried by cross-host OP_FABRIC_WRITE frames (payload "
         "scattered straight into lease-carved blocks)"),
    ]
    lines = []
    # Selected transport engine as an info-style gauge: the engine name
    # rides a label so dashboards can alert on an unexpected fallback.
    engine = stats.get("engine", "epoll")
    lines.append(
        "# HELP infinistore_engine transport engine selected at start "
        "(1 for the active one)"
    )
    lines.append("# TYPE infinistore_engine gauge")
    lines.append(f'infinistore_engine{{engine="{engine}"}} 1')
    # Build-info gauge: the facts dashboards used
    # to scrape out of /stats prose — ABI version, selected engine,
    # kernel release, data-plane worker count — as labels on a constant
    # 1 (the Prometheus info-metric idiom).
    import platform

    try:
        abi = int(_native.get_lib().ist_abi_version())
    except Exception:
        abi = 0
    lines.append(
        "# HELP infinistore_build_info build/runtime identity "
        "(constant 1; the facts ride the labels)"
    )
    lines.append("# TYPE infinistore_build_info gauge")
    lines.append(
        f'infinistore_build_info{{abi_version="{abi}",'
        f'engine="{engine}",kernel="{platform.release()}",'
        f'workers="{stats.get("workers", 0)}"}} 1'
    )
    for key, name, help_ in g:
        lines.append(f"# HELP infinistore_{name} {help_}")
        lines.append(f"# TYPE infinistore_{name} gauge")
        lines.append(f"infinistore_{name} {stats.get(key, 0)}")
    for key, name, help_ in c:
        lines.append(f"# HELP infinistore_{name}_total {help_}")
        lines.append(f"# TYPE infinistore_{name}_total counter")
        lines.append(f"infinistore_{name}_total {stats.get(key, 0)}")
    # Per-worker breakdown (one contiguous group per metric): load
    # imbalance — one hot connection pinning one worker — is visible
    # here instead of hiding in the aggregates.
    per_worker = stats.get("per_worker", [])
    pw = [
        ("connections", "gauge", "open connections owned by the worker"),
        ("ops", "counter", "requests handled by the worker"),
        ("bytes_in", "counter", "bytes received by the worker"),
        ("bytes_out", "counter", "bytes sent by the worker"),
        ("uring_sqes", "counter",
         "io_uring SQEs submitted by the worker (0 under epoll)"),
        ("uring_zc_sends", "counter",
         "zero-copy sends issued by the worker (0 under epoll)"),
        ("uring_copies_avoided", "counter",
         "payload bytes the worker moved with no bounce copy"),
    ]
    for key, kind, help_ in pw:
        suffix = "_total" if kind == "counter" else ""
        lines.append(f"# HELP infinistore_worker_{key}{suffix} {help_}")
        lines.append(f"# TYPE infinistore_worker_{key}{suffix} {kind}")
        for w in per_worker:
            lines.append(
                f'infinistore_worker_{key}{suffix}'
                f'{{worker="{w.get("worker", 0)}"}} {w.get(key, 0)}'
            )
    # One contiguous group per metric (exposition-format requirement).
    op_stats = stats.get("op_stats", {})
    lines.append("# HELP infinistore_op_count_total per-op request count")
    lines.append("# TYPE infinistore_op_count_total counter")
    for op, s in op_stats.items():
        lines.append(
            f'infinistore_op_count_total{{op="{op}"}} {s.get("count", 0)}'
        )

    def render_histogram(name, help_, series):
        """True Prometheus histogram from the native power-of-two
        buckets: bucket b counts integer-microsecond observations in
        [2^b, 2^(b+1)), whose INCLUSIVE upper bound — Prometheus
        defines bucket{le=X} as count(obs <= X) — is 2^(b+1)-1 (an op
        of exactly 4 us lives in [4,8) and must be counted under
        le="7", not appear only at le="8"); the last native bucket
        absorbs everything slower and maps to +Inf. series:
        [(labels, entry)] where entry is a stats hist dict
        ({hist, total_us, count})."""
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} histogram")
        rendered = []
        for labels, s in series:
            hist = s.get("hist") or []
            sep = "," if labels else ""
            cum = 0
            for b, n in enumerate(hist):
                cum += n
                le = (
                    "+Inf"
                    if b == len(hist) - 1
                    else str((1 << (b + 1)) - 1)
                )
                lines.append(
                    f'{name}_bucket{{{labels}{sep}le="{le}"}} {cum}'
                )
            rendered.append((labels, s, cum))
        # _sum / _count after every _bucket line: the exposition format
        # wants each sample name's lines contiguous.
        for labels, s, _ in rendered:
            brace = f"{{{labels}}}" if labels else ""
            lines.append(f'{name}_sum{brace} {s.get("total_us", 0)}')
        for labels, s, cum in rendered:
            brace = f"{{{labels}}}" if labels else ""
            lines.append(f'{name}_count{brace} {s.get("count", cum)}')

    render_histogram(
        "infinistore_op_latency_us",
        "per-op handler latency (us; power-of-two buckets)",
        [(f'op="{op}"', s) for op, s in op_stats.items()],
    )
    # p50/p99 convenience gauges (bucket midpoints) under their own
    # metric name — the same family name cannot be both a histogram and
    # a gauge in the exposition format.
    lines.append(
        "# HELP infinistore_op_latency_quantile_us per-op handler "
        "latency (us, histogram-midpoint percentiles)"
    )
    lines.append("# TYPE infinistore_op_latency_quantile_us gauge")
    for op, s in op_stats.items():
        for q, label in (("p50_us", "0.5"), ("p99_us", "0.99")):
            lines.append(
                f'infinistore_op_latency_quantile_us{{op="{op}",'
                f'quantile="{label}"}} {s.get(q, 0)}'
            )
    # Always-on wait histograms: where an op's time went while it was
    # NOT running — contended stripe-lock acquisition and the acceptor
    # handoff queue.
    waits = stats.get("wait_stats", {})
    render_histogram(
        "infinistore_stripe_lock_wait_us",
        "contended stripe-lock wait on the data plane (us)",
        [("", waits.get("stripe_lock_wait", {}))],
    )
    render_histogram(
        "infinistore_handoff_queue_wait_us",
        "accept-handoff queue wait, enqueue to adoption (us)",
        [("", waits.get("handoff_queue_wait", {}))],
    )
    trace = stats.get("trace", {})
    lines.append(
        "# HELP infinistore_trace_enabled request tracing active (0/1)"
    )
    lines.append("# TYPE infinistore_trace_enabled gauge")
    lines.append(f'infinistore_trace_enabled {trace.get("enabled", 0)}')
    lines.append(
        "# HELP infinistore_trace_spans_total spans recorded to the "
        "trace rings"
    )
    lines.append("# TYPE infinistore_trace_spans_total counter")
    lines.append(
        f'infinistore_trace_spans_total {trace.get("spans", 0)}'
    )
    # Flight recorder + anomaly watchdog (always on): the alerting
    # surface for "the store detected its own anomaly" — dashboards
    # page on watchdog_stalled / watchdog_trips_total movement and
    # read the bundle on disk for the forensics.
    wd = stats.get("watchdog", {})
    ev = stats.get("events", {})
    lines.append(
        "# HELP infinistore_watchdog_stalled current stall verdict "
        "(worker/background heartbeat over threshold, or a worker "
        "died)"
    )
    lines.append("# TYPE infinistore_watchdog_stalled gauge")
    lines.append(f'infinistore_watchdog_stalled {wd.get("stalled", 0)}')
    lines.append(
        "# HELP infinistore_watchdog_trips_total watchdog triggers "
        "by kind"
    )
    lines.append("# TYPE infinistore_watchdog_trips_total counter")
    for kind, key in (("stall", "stall_trips"),
                      ("slow_op", "slow_op_trips"),
                      ("queue_growth", "queue_trips"),
                      ("slo_burn", "slo_trips"),
                      ("thrash", "thrash_trips"),
                      ("migration", "migration_trips"),
                      ("io_deadline", "io_deadline_trips")):
        lines.append(
            f'infinistore_watchdog_trips_total{{kind="{kind}"}} '
            f'{wd.get(key, 0)}'
        )
    lines.append(
        "# HELP infinistore_watchdog_bundles_total diagnostic "
        "bundles captured"
    )
    lines.append("# TYPE infinistore_watchdog_bundles_total counter")
    lines.append(
        f'infinistore_watchdog_bundles_total {wd.get("bundles", 0)}'
    )
    # Background-IO scheduler (ABI v17+): per-class served/miss
    # counters are the starvation dashboard — a moving
    # promote-class deadline_misses series means interactive reads
    # are waiting behind bulk background IO.
    io = stats.get("iosched", {})
    lines.append(
        "# HELP infinistore_iosched_enabled background-IO scheduler "
        "active (0 = ISTPU_IOSCHED=0 or pre-v17 native)"
    )
    lines.append("# TYPE infinistore_iosched_enabled gauge")
    lines.append(f'infinistore_iosched_enabled {io.get("enabled", 0)}')
    lines.append(
        "# HELP infinistore_iosched_budget_mbps shared disk budget "
        "(0 = unlimited, accounting only)"
    )
    lines.append("# TYPE infinistore_iosched_budget_mbps gauge")
    lines.append(
        f'infinistore_iosched_budget_mbps {io.get("budget_mbps", 0)}'
    )
    lines.append(
        "# HELP infinistore_iosched_served_total scheduler grants "
        "by deadline class"
    )
    lines.append("# TYPE infinistore_iosched_served_total counter")
    for c in io.get("classes", []):
        lines.append(
            f'infinistore_iosched_served_total'
            f'{{cls="{c.get("name", "?")}"}} {c.get("served", 0)}'
        )
    lines.append(
        "# HELP infinistore_iosched_deadline_misses_total acquires "
        "that proceeded past their class deadline bound"
    )
    lines.append(
        "# TYPE infinistore_iosched_deadline_misses_total counter"
    )
    for c in io.get("classes", []):
        lines.append(
            f'infinistore_iosched_deadline_misses_total'
            f'{{cls="{c.get("name", "?")}"}} '
            f'{c.get("deadline_misses", 0)}'
        )
    lines.append(
        "# HELP infinistore_iosched_decisions_total closed-loop "
        "controller knob changes (iosched.decision events)"
    )
    lines.append("# TYPE infinistore_iosched_decisions_total counter")
    lines.append(
        f'infinistore_iosched_decisions_total '
        f'{io.get("iosched_decisions", 0)}'
    )
    lines.append(
        "# HELP infinistore_events_recorded_total flight-recorder "
        "events recorded since process start"
    )
    lines.append("# TYPE infinistore_events_recorded_total counter")
    lines.append(
        f'infinistore_events_recorded_total {ev.get("recorded", 0)}'
    )
    lines.append(
        "# HELP infinistore_events_last_age_us age of the newest "
        "flight-recorder event (-1 = none)"
    )
    lines.append("# TYPE infinistore_events_last_age_us gauge")
    lines.append(
        f'infinistore_events_last_age_us '
        f'{ev.get("last_event_age_us", -1)}'
    )
    # Workload observability headline (the full model is GET
    # /workload): the demand-side gauges ROADMAP item 5's closed-loop
    # tuning will consume — dashboards plot WSS against pool_bytes and
    # alert on premature-eviction movement.
    wl = stats.get("workload", {})
    lines.append(
        "# HELP infinistore_workload_enabled workload profiler "
        "recording (0 only under the ISTPU_WORKLOAD=0 bench "
        "denominator)"
    )
    lines.append("# TYPE infinistore_workload_enabled gauge")
    lines.append(
        f'infinistore_workload_enabled {wl.get("enabled", 0)}'
    )
    lines.append(
        "# HELP infinistore_workload_wss_bytes SHARDS working-set "
        "estimate (live sampled bytes / sample rate)"
    )
    lines.append("# TYPE infinistore_workload_wss_bytes gauge")
    lines.append(
        f'infinistore_workload_wss_bytes {wl.get("wss_bytes", 0)}'
    )
    lines.append(
        "# HELP infinistore_workload_predicted_miss_1x predicted LRU "
        "miss ratio at the current pool size (reuse-distance sampler)"
    )
    lines.append("# TYPE infinistore_workload_predicted_miss_1x gauge")
    lines.append(
        f'infinistore_workload_predicted_miss_1x '
        f'{wl.get("predicted_miss_1x_milli", 0) / 1000.0}'
    )
    lines.append(
        "# HELP infinistore_workload_premature_evictions_total "
        "get-misses on recently-evicted keys (the reclaimer dropped "
        "something the workload still wanted)"
    )
    lines.append(
        "# TYPE infinistore_workload_premature_evictions_total counter"
    )
    lines.append(
        f'infinistore_workload_premature_evictions_total '
        f'{wl.get("premature_evictions", 0)}'
    )
    lines.append(
        "# HELP infinistore_workload_thrash_cycles_total "
        "spill-then-promote round trips (two tier IOs for nothing)"
    )
    lines.append(
        "# TYPE infinistore_workload_thrash_cycles_total counter"
    )
    lines.append(
        f'infinistore_workload_thrash_cycles_total '
        f'{wl.get("thrash_cycles", 0)}'
    )
    lines.append(
        "# HELP infinistore_workload_dedup_ratio projected dedup "
        "ratio over sampled content fingerprints (1.0 = no "
        "duplication; the ROADMAP item 3 capacity multiplier)"
    )
    lines.append("# TYPE infinistore_workload_dedup_ratio gauge")
    lines.append(
        f'infinistore_workload_dedup_ratio '
        f'{wl.get("dedup_ratio_milli", 1000) / 1000.0}'
    )
    # Content-addressed dedup: the MEASURED capacity
    # multiplier the workload profiler's dedup_ratio prediction above
    # is scored against, plus logical-vs-physical occupancy — the
    # users_per_gb headline is logical_bytes / pool_used_bytes.
    dd = stats.get("dedup", {})
    lines.append(
        "# HELP infinistore_dedup_enabled content-addressed dedup "
        "index active (0 only under the ISTPU_DEDUP=0 bench "
        "denominator)"
    )
    lines.append("# TYPE infinistore_dedup_enabled gauge")
    lines.append(f'infinistore_dedup_enabled {dd.get("enabled", 0)}')
    lines.append(
        "# HELP infinistore_dedup_hits_total commits that pinned an "
        "existing block instead of keeping new pool bytes (hash-first "
        "HAVE verdicts + commit-time adoption)"
    )
    lines.append("# TYPE infinistore_dedup_hits_total counter")
    lines.append(
        f'infinistore_dedup_hits_total {dd.get("dedup_hits", 0)}'
    )
    lines.append(
        "# HELP infinistore_dedup_bytes_saved_total pool bytes the "
        "dedup index declined to keep (cumulative)"
    )
    lines.append("# TYPE infinistore_dedup_bytes_saved_total counter")
    lines.append(
        f'infinistore_dedup_bytes_saved_total '
        f'{dd.get("dedup_bytes_saved", 0)}'
    )
    lines.append(
        "# HELP infinistore_dedup_hash_hits_total hash-first put "
        "probes answered HAVE (zero payload transfer)"
    )
    lines.append("# TYPE infinistore_dedup_hash_hits_total counter")
    lines.append(
        f'infinistore_dedup_hash_hits_total '
        f'{dd.get("dedup_hash_hits", 0)}'
    )
    lines.append(
        "# HELP infinistore_dedup_hash_misses_total hash-first put "
        "probes answered NEED (payload follows on the normal path)"
    )
    lines.append("# TYPE infinistore_dedup_hash_misses_total counter")
    lines.append(
        f'infinistore_dedup_hash_misses_total '
        f'{dd.get("dedup_hash_misses", 0)}'
    )
    lines.append(
        "# HELP infinistore_dedup_wire_hits_total HAVE verdicts whose "
        "payload never crossed the transport (OP_PUT_HASH / ring v2 "
        "hash records)"
    )
    lines.append("# TYPE infinistore_dedup_wire_hits_total counter")
    lines.append(
        f'infinistore_dedup_wire_hits_total '
        f'{dd.get("dedup_wire_hits", 0)}'
    )
    lines.append(
        "# HELP infinistore_dedup_wire_bytes_saved_total payload "
        "bytes that never crossed the transport thanks to HAVE "
        "verdicts"
    )
    lines.append(
        "# TYPE infinistore_dedup_wire_bytes_saved_total counter"
    )
    lines.append(
        f'infinistore_dedup_wire_bytes_saved_total '
        f'{dd.get("dedup_wire_bytes_saved", 0)}'
    )
    lines.append(
        "# HELP infinistore_dedup_logical_bytes committed bytes as "
        "clients see them (physical occupancy is pool_used_bytes; "
        "the gap is live dedup savings)"
    )
    lines.append("# TYPE infinistore_dedup_logical_bytes gauge")
    lines.append(
        f'infinistore_dedup_logical_bytes '
        f'{dd.get("logical_bytes", 0)}'
    )
    lines.append(
        "# HELP infinistore_dedup_saved_live_bytes logical bytes "
        "currently served by shared blocks (drops as sharers are "
        "deleted/evicted)"
    )
    lines.append("# TYPE infinistore_dedup_saved_live_bytes gauge")
    lines.append(
        f'infinistore_dedup_saved_live_bytes '
        f'{dd.get("dedup_saved_live", 0)}'
    )
    lines.append(
        "# HELP infinistore_dedup_measured_ratio measured capacity "
        "multiplier logical/(logical-saved_live); score the workload "
        "profiler's infinistore_workload_dedup_ratio prediction "
        "against this"
    )
    lines.append("# TYPE infinistore_dedup_measured_ratio gauge")
    lines.append(
        f'infinistore_dedup_measured_ratio '
        f'{dd.get("dedup_measured_milli", 1000) / 1000.0}'
    )
    # Cluster tier (GET /directory has the full map): the directory
    # epoch dashboards correlate with re-routing, and the live
    # migration cursor (phase -1 = no migration in flight).
    cl = stats.get("cluster", {})
    lines.append(
        "# HELP infinistore_cluster_epoch shard-directory epoch in "
        "force (0 = not a cluster member)"
    )
    lines.append("# TYPE infinistore_cluster_epoch gauge")
    lines.append(
        f'infinistore_cluster_epoch {cl.get("epoch", 0)}'
    )
    lines.append(
        "# HELP infinistore_cluster_migration_phase live key-range "
        "migration phase (-1 idle, 1 export, 2 adopt, 3 evict)"
    )
    lines.append("# TYPE infinistore_cluster_migration_phase gauge")
    lines.append(
        f'infinistore_cluster_migration_phase '
        f'{cl.get("migration_phase", -1)}'
    )
    lines.append(
        "# HELP infinistore_cluster_migration_cursor chunks of the "
        "in-flight range move completed on this shard"
    )
    lines.append("# TYPE infinistore_cluster_migration_cursor gauge")
    lines.append(
        f'infinistore_cluster_migration_cursor '
        f'{cl.get("migration_cursor", 0)}'
    )
    lines.append(
        "# HELP infinistore_cluster_wrong_epoch_total stale directory "
        "pushes this shard refused with WRONG_EPOCH"
    )
    lines.append("# TYPE infinistore_cluster_wrong_epoch_total counter")
    lines.append(
        f'infinistore_cluster_wrong_epoch_total '
        f'{cl.get("wrong_epoch_rejections", 0)}'
    )
    # Fleet families, rendered from the aggregator's LAST
    # scrape only when one is attached and has scraped — a plain
    # single-node /metrics pull carries none of these.
    fleet = aggregator.cached_status() if aggregator is not None else None
    if fleet is not None:
        div = fleet.get("divergence", {})
        lines.append(
            "# HELP infinistore_cluster_replica_divergence key-ranges "
            "whose replica digests disagree (per range; the "
            "anti-entropy measurement gauge)"
        )
        lines.append(
            "# TYPE infinistore_cluster_replica_divergence gauge"
        )
        for d in div.get("divergent", []):
            lines.append(
                f'infinistore_cluster_replica_divergence'
                f'{{range="{d.get("range", "?")}"}} 1'
            )
        lines.append(
            f'infinistore_cluster_replica_divergence'
            f'{{range="_total"}} {div.get("gauge", 0)}'
        )
        lag = fleet.get("epoch_lag", {})
        lines.append(
            "# HELP infinistore_cluster_epoch_lag_us directory-epoch "
            "propagation lag per shard (push to adopt, wall clock; "
            "-1 = shard down)"
        )
        lines.append("# TYPE infinistore_cluster_epoch_lag_us gauge")
        for sid, v in lag.get("per_shard_us", {}).items():
            lines.append(
                f'infinistore_cluster_epoch_lag_us{{shard="{sid}"}} {v}'
            )
        lines.append(
            "# HELP infinistore_cluster_shard_up scrape health per "
            "directory shard (1 = answering its control plane)"
        )
        lines.append("# TYPE infinistore_cluster_shard_up gauge")
        for r in fleet.get("shards", []):
            lines.append(
                f'infinistore_cluster_shard_up'
                f'{{shard="{r.get("id")}"}} {1 if r.get("up") else 0}'
            )
    # Metrics-history ring meta (the ring itself is GET /history).
    hist = stats.get("history", {})
    lines.append(
        "# HELP infinistore_history_samples_total metrics-history "
        "ring samples recorded since start"
    )
    lines.append("# TYPE infinistore_history_samples_total counter")
    lines.append(
        f'infinistore_history_samples_total {hist.get("recorded", 0)}'
    )
    # SLO burn rates (multi-window, computed by the tracker over the
    # history ring; GET /slo has the full blob).
    if slo is not None:
        try:
            st = slo.status()
        except Exception:
            st = None
        if st is not None:
            lines.append(
                "# HELP infinistore_slo_burn_rate error-budget burn "
                "rate per objective and window (1.0 = sustainable)"
            )
            lines.append("# TYPE infinistore_slo_burn_rate gauge")
            for window in ("short", "long"):
                w = st.get(window, {})
                for obj in ("latency", "availability"):
                    lines.append(
                        f'infinistore_slo_burn_rate{{slo="{obj}",'
                        f'window="{window}"}} '
                        f'{w.get(f"{obj}_burn_rate", 0)}'
                    )
            lines.append(
                "# HELP infinistore_slo_burning both burn-rate "
                "windows over threshold (the slo_burn verdict "
                "condition)"
            )
            lines.append("# TYPE infinistore_slo_burning gauge")
            lines.append(
                f'infinistore_slo_burning '
                f'{1 if st.get("burning") else 0}'
            )
    return "\n".join(lines) + "\n"


def make_control_plane(server: InfiniStoreServer, snapshot_path=None,
                       slo=None, aggregator=None):
    # GET /slo always answers: without an explicitly configured tracker
    # (programmatic users, tests) a default-objective tracker computes
    # on demand — only main() starts the verdict THREAD.
    if slo is None:
        slo = SLOTracker(server)
    # GET /cluster/* always answers too: without an explicitly
    # configured aggregator a default one scrapes on demand, by the
    # directory this shard holds natively (a fresh single-node server
    # holds none → well-formed empty views, never an error). Only
    # main()'s --cluster-aggregator starts the scrape/verdict THREAD.
    if aggregator is None:
        from .cluster import FleetAggregator

        aggregator = FleetAggregator(server=server)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code, text):
            body = text.encode()
            self.send_response(code)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/kvmap_len":
                self._send(200, server.kvmap_len())
            elif self.path == "/stats":
                self._send(200, server.stats())
            elif self.path == "/metrics":
                self._send_text(
                    200, _prometheus_metrics(server.stats(), slo=slo,
                                             aggregator=aggregator)
                )
            elif self.path == "/history":
                # Metrics-history ring: ~1 Hz snapshots with counter/
                # latency-histogram deltas, oldest first. Survives
                # purge (ring never cleared); sparklines via
                # tools/istpu_top.py.
                self._send(200, server.history())
            elif self.path == "/slo":
                # Multi-window burn-rate status over the history ring
                # (objectives, per-window burn rates, verdict state).
                self._send(200, slo.status())
            elif self.path == "/workload":
                # Workload observability plane: MRC over hypothetical
                # pool sizes, WSS estimate, eviction-quality counters,
                # projected dedup ratio, heat classes.
                self._send(200, server.workload())
            elif self.path == "/cluster/status":
                # Fleet view: per-shard gauges + health,
                # skew, epoch-propagation lag, migration progress and
                # the replica-divergence table — scraped from every
                # directory shard by the aggregator.
                self._send(200, aggregator.status())
            elif self.path == "/cluster/slo":
                # Quorum-aware fleet SLO: burn windows summed across
                # shards; availability counts a key-range down only
                # when EVERY replica of it is down (the replicated data-path
                # promise restated for the SLO plane).
                self._send(200, aggregator.slo())
            elif self.path == "/cluster/history":
                # The shards' metrics-history rings merged bucket-wise
                # in the shared LatHist geometry (tail-aligned samples;
                # merged percentiles stay exact).
                self._send(200, aggregator.history())
            elif self.path.startswith("/digest"):
                # Single-range divergence digest of THIS shard:
                # /digest?lo=N&hi=N (ring-hash coordinates, wrap-around
                # when lo > hi). The aggregator's batched pass uses the
                # POST form instead.
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                try:
                    lo = int(q.get("lo", ["0"])[0])
                    hi = int(q.get("hi", [str(1 << 32)])[0])
                except ValueError:
                    self._send(400, {"error": "lo/hi must be ints"})
                    return
                self._send(200, server.digest_range(lo, hi))
            elif self.path == "/directory":
                # Cluster tier: the shard directory this server holds
                # (epoch-numbered map + live migration phase/cursor)
                # plus this server's own shard identity. Epoch 0 with a
                # null directory = not (yet) a cluster member.
                blob = server.cluster()
                blob["shard_id"] = server.config.shard_id
                self._send(200, blob)
            elif self.path == "/trace":
                # Chrome trace-event JSON, already serialized natively:
                # save the body to a file and load it in Perfetto
                # (ui.perfetto.dev) or chrome://tracing. Empty event
                # list unless the server runs with --trace/ISTPU_TRACE=1.
                body = server.trace_json().encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/fault":
                # Failpoint catalog: name, current arming, fire count.
                self._send(200, server.faults())
            elif self.path.startswith("/events"):
                # Flight-recorder drain (always on). ?since=SEQ
                # filters to events newer than a previously observed
                # high-water mark.
                since = 0
                if "?" in self.path:
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        since = int(q.get("since", ["0"])[0])
                    except ValueError:
                        since = 0
                self._send(200, server.events(since_seq=since))
            elif self.path == "/debug/state":
                # Deep-state introspection: per-connection /
                # per-worker / per-stripe / per-arena internals that
                # previously needed a debugger attach.
                self._send(200, server.debug_state())
            elif self.path == "/health":
                # Liveness + failure-model summary: a dead background
                # worker, an open tier breaker or a CURRENT watchdog
                # stall verdict is DEGRADED (the store still serves —
                # inline fallbacks / pure-pool mode), never dead.
                # Before the watchdog fields, a silently stalled
                # worker read "ok" here until heartbeats were
                # correlated by hand.
                st = server.stats()
                wd = st.get("watchdog", {})
                ev = st.get("events", {})
                degraded = bool(
                    st.get("workers_dead", 0)
                    or st.get("tier_breaker_open", 0)
                    or wd.get("stalled", 0)
                )
                self._send(
                    200,
                    {
                        "status": "degraded" if degraded else "ok",
                        "workers_dead": st.get("workers_dead", 0),
                        "tier_breaker_open": st.get(
                            "tier_breaker_open", 0
                        ),
                        "disk_io_errors": st.get("disk_io_errors", 0),
                        # Watchdog verdicts: `stalled` is the CURRENT
                        # sample's verdict (drives `degraded`); trips/
                        # last_trigger summarize history for operators.
                        "watchdog": {
                            "stalled": wd.get("stalled", 0),
                            "trips": wd.get("trips", 0),
                            "last_trigger": wd.get("last_trigger", ""),
                            "bundles": wd.get("bundles", 0),
                        },
                        # Age of the newest flight-recorder event: a
                        # black box that stopped recording is itself an
                        # anomaly worth alerting on.
                        "last_event_age_us": ev.get(
                            "last_event_age_us", -1
                        ),
                    },
                )
            else:
                self._send(404, {"error": "not found"})

        def _json_body(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(length).decode(errors="replace")
            try:
                body = json.loads(raw) if raw.strip() else {}
            except ValueError:
                return None
            return body if isinstance(body, dict) else None

        def _post_directory(self):
            """Install a pushed directory epoch. The WRONG_EPOCH
            contract (the ctl-page-epoch idiom, cluster-sized): a
            push older than what this shard holds is answered 409 +
            the CURRENT map — the pusher learns the truth in the same
            round trip, and a stale coordinator can never roll a shard
            backwards."""
            body = self._json_body()
            if body is None or "epoch" not in body:
                self._send(400, {"error": "directory body needs epoch"})
                return
            from .cluster import eval_failpoint

            rc = eval_failpoint("cluster.directory_push")
            if rc:
                # Chaos: this shard refuses the push (partial
                # propagation). 503 = retryable, distinct from the
                # WRONG_EPOCH consistency answer.
                self._send(503, {"error": "PUSH_REFUSED",
                                 "errno": rc})
                return
            if not server.set_cluster(int(body["epoch"]), directory=body):
                cur = server.cluster()
                # The refused pusher gets the held MAP itself (plus the
                # epoch for a quick compare) — the thing it should
                # adopt and retry from, not the whole native mirror.
                self._send(409, {"error": "WRONG_EPOCH",
                                 "epoch": cur.get("epoch", 0),
                                 "directory": cur.get("directory")})
                return
            self._send(200, {"epoch": int(body["epoch"])})

        def _post_migrate(self):
            """The live-rebalance data-plane verbs, driven by
            cluster.ClusterCoordinator. All of them ride machinery the
            store already owns: export = the snapshot extent codec over
            one ring range, import = the restore path (first-writer-
            wins), evict = ranged delete with per-entry epoch bumps,
            verdict = the watchdog.migration trip. The cluster.*
            failpoints fire here — kill exits the process (a source or
            target dying mid-range), err fails the step loudly."""
            from . import cluster as _cluster

            body = self._json_body()
            if body is None:
                self._send(400, {"error": "bad JSON body"})
                return
            action = body.get("action")
            epoch = server.cluster().get("epoch", 0)
            try:
                if action == "export":
                    rc = _cluster.eval_failpoint("cluster.migrate_export")
                    if rc:
                        self._send(500, {"error": "export failed",
                                         "errno": rc})
                        return
                    n = server.snapshot_range(
                        body["path"], int(body["lo"]), int(body["hi"]))
                    server.set_cluster(
                        epoch, phase=_cluster.PHASE_EXPORT,
                        cursor=int(body.get("cursor", 0)),
                        total=int(body.get("total", 0)))
                    self._send(200, {"exported": n})
                elif action == "import":
                    adopted = 0
                    paths = body.get("paths", [])
                    for i, path in enumerate(paths):
                        rc = _cluster.eval_failpoint(
                            "cluster.migrate_adopt")
                        if rc:
                            self._send(500, {"error": "adopt failed",
                                             "errno": rc,
                                             "adopted": adopted})
                            return
                        adopted += server.restore(path)
                        server.set_cluster(
                            epoch, phase=_cluster.PHASE_ADOPT,
                            cursor=i + 1,
                            total=int(body.get("total", len(paths))))
                    self._send(200, {"adopted": adopted})
                elif action == "evict":
                    server.set_cluster(epoch,
                                       phase=_cluster.PHASE_EVICT,
                                       cursor=0, total=0)
                    n = server.delete_range(int(body["lo"]),
                                            int(body["hi"]))
                    # Evict is the migration's last local step: return
                    # the mirror to idle so the phase gauge (-1 idle)
                    # does not report a migration forever. Export/adopt
                    # phases on the OTHER shards were already reset by
                    # the commit's directory push (set_cluster's
                    # default phase is -1).
                    server.set_cluster(epoch, phase=_cluster.PHASE_IDLE)
                    self._send(200, {"evicted": n})
                elif action == "verdict":
                    fired = server.migration_trip(
                        body.get("detail", "migration stalled"),
                        int(body.get("a0", 0)), int(body.get("a1", 0)))
                    self._send(200, {"fired": bool(fired)})
                else:
                    self._send(400, {"error": f"unknown action {action!r}"})
            except KeyError as e:
                self._send(400, {"error": f"missing field {e}"})
            except Exception as e:  # noqa: BLE001 — surfaced to caller
                self._send(500, {"error": str(e)})

        def do_POST(self):
            if self.path == "/purge":
                n = server.purge()
                self._send(200, {"purged": n})
            elif self.path == "/digest":
                # Batched divergence digests: {"ranges": [[lo, hi],
                # ...]} → {"digests": [{lo, hi, digest, count, bytes}]}
                # — ONE round trip per shard per aggregator digest
                # pass, whatever the ring's segment count.
                body = self._json_body()
                if body is None or not isinstance(
                        body.get("ranges"), list):
                    self._send(400, {"error": "body needs ranges list"})
                    return
                try:
                    out = [server.digest_range(int(lo), int(hi))
                           for lo, hi in body["ranges"]]
                except (TypeError, ValueError):
                    self._send(400,
                               {"error": "ranges must be [lo, hi] ints"})
                    return
                self._send(200, {"digests": out})
            elif self.path == "/directory":
                self._post_directory()
            elif self.path == "/migrate":
                self._post_migrate()
            elif self.path == "/fault":
                # Arm/disarm failpoints at runtime. Body: either a raw
                # spec string ("disk.pwrite=once:err(5);...") or JSON
                # {"spec": "..."}; "off" disarms everything. Grammar in
                # native/src/failpoint.h; catalog via GET /fault.
                length = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(length).decode(errors="replace")
                spec = body.strip()
                if spec.startswith("{"):
                    try:
                        spec = json.loads(spec).get("spec", "")
                    except ValueError:
                        self._send(400, {"error": "bad JSON body"})
                        return
                    if not isinstance(spec, str):
                        self._send(400, {"error": "spec must be a string"})
                        return
                try:
                    n = server.fault(spec)
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                    return
                self._send(200, {"armed": n, "spec": spec})
            elif self.path.startswith("/selftest"):
                parts = self.path.rstrip("/").split("/")
                port = (
                    int(parts[-1])
                    if parts[-1].isdigit()
                    else server.service_port
                )
                try:
                    ok = _selftest(port)
                    self._send(200 if ok else 500, {"selftest": ok})
                except Exception as e:  # pragma: no cover - error path
                    self._send(500, {"selftest": False, "error": str(e)})
            elif self.path == "/snapshot":
                if not snapshot_path:
                    self._send(
                        400, {"error": "server started without "
                                       "--snapshot-path"}
                    )
                    return
                try:
                    n = server.snapshot(snapshot_path)
                    self._send(200, {"snapshot": n, "path": snapshot_path})
                except Exception as e:
                    self._send(500, {"error": str(e)})
            else:
                self._send(404, {"error": "not found"})

        def log_message(self, fmt, *args):
            Logger.debug("manage: " + fmt % args)

    return ThreadingHTTPServer((server.config.host, server.config.manage_port),
                               Handler)


def prevent_oom():
    """Shield the store from the OOM killer (reference server.py:202-205)."""
    try:
        with open("/proc/self/oom_score_adj", "w") as f:
            f.write("-1000")
    except OSError:
        Logger.warning("could not adjust oom_score_adj (not privileged)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="infinistore-tpu-torch",
        description="KV-cache memory-pool server (PyTorch port)",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--service-port", type=int, default=22345)
    p.add_argument("--manage-port", type=int, default=18080)
    p.add_argument("--log-level", default="warning",
                   choices=["error", "warning", "info", "debug"])
    p.add_argument("--prealloc-size", type=float, default=16,
                   help="pool preallocation in GB")
    p.add_argument("--minimal-allocate-size", type=int, default=64,
                   help="pool block granularity in KB")
    p.add_argument("--auto-increase", action="store_true",
                   help="grow the pool when usage crosses 50%%")
    p.add_argument("--extend-size", type=float, default=1,
                   help="GB added per auto-increase")
    p.add_argument("--no-shm", action="store_true",
                   help="disable the same-host shared-memory path")
    p.add_argument("--enable-eviction", action="store_true",
                   help="LRU-evict cold committed entries when the pool "
                        "is full (instead of failing allocations)")
    p.add_argument("--ssd-path", default="",
                   help="directory for the disk spill tier's file "
                        "(required with --ssd-size; avoid tmpfs mounts)")
    p.add_argument("--ssd-size", type=float, default=0,
                   help="disk spill tier capacity in GB (0 = disabled); "
                        "cold entries spill to disk under pool pressure "
                        "and promote back on read")
    p.add_argument("--max-outq-size", type=float, default=64,
                   help="per-connection cap in MB on bytes queued to a "
                        "slow reader; reads past the cap fail with BUSY "
                        "(retryable)")
    p.add_argument("--workers", type=int, default=1,
                   help="data-plane epoll worker threads; each worker "
                        "accepts on its own SO_REUSEPORT socket (kernel "
                        "load-spreading; least-loaded handoff fallback) "
                        "so socket<->pool copies run in parallel across "
                        "cores. 1 (default) = the classic single loop, "
                        "0 = auto (min(4, cores-2)); the "
                        "ISTPU_SERVER_WORKERS env var overrides")
    p.add_argument("--reclaim-high", type=float, default=0.95,
                   help="pool-occupancy fraction that wakes the "
                        "background reclaimer (evict/spill off the hot "
                        "path); >= 1.0 disables it (inline-only reclaim)")
    p.add_argument("--reclaim-low", type=float, default=0.85,
                   help="occupancy fraction the background reclaimer "
                        "drives the pool down to per pass")
    p.add_argument("--no-promote", action="store_true",
                   help="disable the async read pipeline (promotion "
                        "worker + disk-served cold gets); disk-resident "
                        "keys then promote inline on the reading worker "
                        "as before. ISTPU_PROMOTE=1/0 overrides")
    p.add_argument("--trace", action="store_true",
                   help="record per-worker request-lifecycle span rings "
                        "(parse, stripe-lock wait, copy, disk IO, "
                        "commit, reclaim/spill tracks); drain as "
                        "Perfetto-loadable JSON via GET /trace. "
                        "ISTPU_TRACE=1/0 overrides")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "epoll", "uring", "fabric"],
                   help="transport engine for the worker IO loops: "
                        "epoll (readiness loop, portable), uring "
                        "(io_uring: registered pool buffers, zero-copy "
                        "sends, multishot recv; fails at startup on "
                        "kernels without io_uring), fabric (one-sided "
                        "data plane: per-connection shm commit rings, "
                        "leased same-host puts never touch the socket; "
                        "falls back to the auto selection loudly "
                        "without POSIX shm), or auto (probe and "
                        "fall back to epoll, logged once; the /stats "
                        "'engine' key reports the selection). The "
                        "ISTPU_ENGINE env var overrides")
    p.add_argument("--no-watchdog", action="store_true",
                   help="disable the anomaly watchdog thread (stall / "
                        "slow-op / queue-growth verdicts + diagnostic "
                        "bundles). ISTPU_WATCHDOG=1/0 overrides")
    p.add_argument("--bundle-dir", default="",
                   help="directory for watchdog diagnostic bundles "
                        "(stats + events + trace + deep state per "
                        "trigger, keep-last---bundle-keep) and the "
                        "crash-dump fd the fatal-signal handler writes "
                        "the raw event rings to; empty = no bundles. "
                        "ISTPU_BUNDLE_DIR overrides")
    p.add_argument("--bundle-keep", type=int, default=4,
                   help="diagnostic bundles retained in --bundle-dir "
                        "(oldest pruned first)")
    p.add_argument("--shard-id", type=int, default=-1,
                   help="this server's shard identity in the cluster "
                        "tier's replicated shard directory (GET "
                        "/directory reports it; POST /directory "
                        "installs epoch-numbered maps; POST /migrate "
                        "drives live key-range rebalance). -1 = not a "
                        "cluster member")
    p.add_argument("--no-slo", action="store_true",
                   help="disable the SLO burn-rate tracker thread "
                        "(GET /slo still computes on demand)")
    p.add_argument("--cluster-aggregator", action="store_true",
                   help="start the fleet-aggregator scrape/verdict "
                        "thread on this node: scrapes every directory "
                        "shard's control plane, serves the merged "
                        "GET /cluster/{status,slo,history} views and "
                        "fires the watchdog.replica_divergence / "
                        "watchdog.epoch_lag verdicts (bundle + "
                        "fleet.json). Without the flag the /cluster/* "
                        "endpoints still compute on demand")
    p.add_argument("--cluster-scrape-interval", type=float, default=1.0,
                   help="fleet-aggregator scrape cadence in seconds "
                        "(divergence digests run every 5th scrape)")
    p.add_argument("--slo-latency-ms", type=float, default=100.0,
                   help="latency SLO threshold: ops slower than this "
                        "count against the error budget")
    p.add_argument("--slo-latency-objective", type=float, default=0.999,
                   help="fraction of ops that must finish under "
                        "--slo-latency-ms (error budget = 1 - this)")
    p.add_argument("--slo-availability-objective", type=float,
                   default=0.999,
                   help="store-health objective: tier IO errors "
                        "(foreground reads AND absorbed background "
                        "spill/promote writes) per op must stay under "
                        "1 - this")
    p.add_argument("--slo-short-window-s", type=float, default=60,
                   help="short burn-rate window (seconds); the verdict "
                        "needs BOTH windows over --slo-burn-threshold")
    p.add_argument("--slo-long-window-s", type=float, default=300,
                   help="long burn-rate window (seconds)")
    p.add_argument("--slo-burn-threshold", type=float, default=2.0,
                   help="burn-rate multiple (1.0 = budget burns exactly "
                        "at the sustainable rate) that, sustained in "
                        "both windows, fires the slo_burn watchdog "
                        "verdict (event + diagnostic bundle)")
    p.add_argument("--warmup", action="store_true",
                   help="run a warmup round-trip after startup")
    p.add_argument("--snapshot-path", default="",
                   help="snapshot file for warm restarts: loaded at "
                        "startup when present, written by POST "
                        "/snapshot and on SIGINT/SIGTERM shutdown")
    p.add_argument("--port-file", default="",
                   help="write {\"service_port\", \"manage_port\", "
                        "\"pid\"} as JSON here once both planes are "
                        "up — how a supervisor (or the cluster chaos "
                        "harness) discovers ephemeral ports without "
                        "scraping logs")
    p.add_argument("--no-oom-protect", action="store_true")
    p.add_argument("--selftest", action="store_true",
                   help="start an ephemeral server, run the loopback "
                        "write/read self-test, print the result and exit "
                        "(the installed-artifact smoke check; service "
                        "equivalent: POST /selftest/{port})")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        config = ServerConfig(
            host="127.0.0.1", service_port=0, log_level=args.log_level,
            prealloc_size=min(args.prealloc_size, 0.0625),
            minimal_allocate_size=args.minimal_allocate_size,
        )
        server = InfiniStoreServer(config)
        server.start()
        try:
            ok = _selftest(server.service_port)
        finally:
            server.stop()
        print(json.dumps({"selftest": bool(ok)}))
        return 0 if ok else 1
    config = ServerConfig(
        host=args.host,
        service_port=args.service_port,
        manage_port=args.manage_port,
        log_level=args.log_level,
        prealloc_size=args.prealloc_size,
        minimal_allocate_size=args.minimal_allocate_size,
        auto_increase=args.auto_increase,
        extend_size=args.extend_size,
        enable_shm=not args.no_shm,
        enable_eviction=args.enable_eviction,
        ssd_path=args.ssd_path,
        ssd_size=args.ssd_size,
        max_outq_size=args.max_outq_size,
        workers=args.workers,
        reclaim_high=args.reclaim_high,
        reclaim_low=args.reclaim_low,
        promote=not args.no_promote,
        trace=args.trace,
        engine=args.engine,
        watchdog=not args.no_watchdog,
        bundle_dir=args.bundle_dir,
        bundle_keep=args.bundle_keep,
        shard_id=args.shard_id,
    )
    server = InfiniStoreServer(config)
    server.start()
    Logger.info(f"service on :{server.service_port}")

    if args.snapshot_path:
        import os

        if os.path.exists(args.snapshot_path):
            # A corrupt snapshot degrades to a COLD start, never a boot
            # failure (a supervisor would otherwise crash-loop on it).
            try:
                n = server.restore(args.snapshot_path)
                Logger.info(
                    f"restored {n} entries from {args.snapshot_path} "
                    "(warm start)"
                )
            except Exception as e:
                Logger.warning(
                    f"snapshot restore failed ({e}); starting cold"
                )

    if not args.no_oom_protect:
        prevent_oom()
    if args.warmup:
        import subprocess

        subprocess.Popen(
            [sys.executable, "-m", "infinistore_tpu_torch.warmup",
             "--service-port", str(server.service_port)]
        )

    slo = SLOTracker(
        server,
        latency_threshold_ms=args.slo_latency_ms,
        latency_objective=args.slo_latency_objective,
        availability_objective=args.slo_availability_objective,
        short_window_s=args.slo_short_window_s,
        long_window_s=args.slo_long_window_s,
        burn_threshold=args.slo_burn_threshold,
    )
    if not args.no_slo:
        slo.start()
    from .cluster import FleetAggregator

    aggregator = FleetAggregator(
        server=server,
        scrape_interval_s=args.cluster_scrape_interval,
    )
    if args.cluster_aggregator:
        aggregator.start()
    httpd = make_control_plane(server, snapshot_path=args.snapshot_path,
                               slo=slo, aggregator=aggregator)
    Logger.info(f"manage plane on :{config.manage_port}")

    if args.port_file:
        import os

        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "service_port": server.service_port,
                "manage_port": httpd.server_address[1],
                "shard_id": config.shard_id,
                "pid": os.getpid(),
            }, f)
        os.rename(tmp, args.port_file)  # atomic: readers never see half

    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        slo.stop()
        aggregator.stop()
        if args.snapshot_path:
            try:
                n = server.snapshot(args.snapshot_path)
                Logger.info(
                    f"snapshotted {n} entries to {args.snapshot_path}"
                )
            except Exception as e:
                Logger.warning(f"shutdown snapshot failed: {e}")
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

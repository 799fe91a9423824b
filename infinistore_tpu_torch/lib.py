"""Python client API for infinistore-tpu (PyTorch port copy).

Parity target: the reference ``infinistore/lib.py`` ``InfinityConnection``
(sync + asyncio variants, torch tensors in/out, element-size scaling of
offsets, callback→future bridging via ``loop.call_soon_threadsafe``,
lib.py:330-707). Differences, all TPU-driven:

- Tensors are numpy arrays or CPU torch tensors (host). The accelerator
  edge (CUDA device pages straight into the pinned pool, per-layer
  overlap) lives in :mod:`infinistore_tpu_torch.cuda`.
- The two data paths are SHM (same-host one-sided shared memory — the
  CUDA-IPC analogue) and STREAM (TCP/DCN — the RDMA analogue). The
  connection probes SHM and falls back automatically (TYPE_AUTO).
- ``register_mr`` is a no-op kept for API compatibility: TCP/SHM need no
  memory-region registration (the reference registers MRs for verbs,
  libinfinistore.cpp:1166-1201).
"""

import asyncio
import collections
import contextlib
import ctypes as ct
import json
import logging
import os
import random
import threading
import time

import numpy as np

from . import _native
from ._native import (
    FAKE_TOKEN,
    KEY_NOT_FOUND,
    OK,
    REMOTE_BLOCK_DTYPE,
    TIMEOUT_ERR,
    pack_keys,
    status_name,
)
from .config import TYPE_AUTO, TYPE_SHM, TYPE_STREAM, ClientConfig

_LOG_LEVEL_TO_NATIVE = {"debug": 0, "info": 1, "warning": 2, "error": 3}

# Native handles that close() could not free because another thread's
# call was still inside one (InfinityConnection.in_use): kept, never
# freed, so that call returns into live memory.
_UNFREED_HANDLES = []


class InfiniStoreError(Exception):
    """Error raised for failed store operations, carrying the status code."""

    def __init__(self, status, message=""):
        self.status = status
        super().__init__(f"{message} (status={status_name(status)})")


class InfiniStoreKeyNotFound(InfiniStoreError):
    pass


# Thread-local active trace id: _stamp_trace/set_trace_id
# publish the id of the op currently running on this thread, so the
# structured-JSON log mode below can correlate every client log line
# with the merged trace (tools/istpu_trace.py) without the caller
# threading ids through by hand.
_log_tls = threading.local()


def _active_trace_id():
    return getattr(_log_tls, "trace_id", 0)


class Logger:
    """Routes Python-side logs into the native logger so both languages
    share one sink/format (reference ``log_msg`` bridge, lib.py:131-150).

    ``ISTPU_LOG_JSON=1`` (read per call — tests flip it) switches every
    client log line to one structured-JSON object carrying the active
    trace id, a wall-clock stamp and the level, so ``grep trace_id``
    joins client logs against a merged Perfetto timeline."""

    _LEVEL_NAMES = ("debug", "info", "warning", "error")

    @staticmethod
    def _emit(level, msg):
        if os.environ.get("ISTPU_LOG_JSON") == "1":
            msg = json.dumps({
                "ts": round(time.time(), 6),
                "level": Logger._LEVEL_NAMES[min(level, 3)],
                "msg": str(msg),
                "trace_id": "0x%x" % _active_trace_id(),
            })
        try:
            _native.get_lib().ist_log_msg(level, str(msg).encode())
        except Exception:
            logging.getLogger("infinistore_tpu_torch").log(
                [logging.DEBUG, logging.INFO, logging.WARNING, logging.ERROR][
                    min(level, 3)
                ],
                msg,
            )

    @classmethod
    def debug(cls, msg):
        cls._emit(0, msg)

    @classmethod
    def info(cls, msg):
        cls._emit(1, msg)

    @classmethod
    def warning(cls, msg):
        cls._emit(2, msg)

    @classmethod
    def error(cls, msg):
        cls._emit(3, msg)


def set_log_level(level_name):
    _native.get_lib().ist_set_log_level(
        _LOG_LEVEL_TO_NATIVE.get(level_name, 2)
    )


def check_supported():
    """Environment sanity check (reference checks nv_peer_mem + ibv
    PORT_ACTIVE, lib.py:208-251). The TPU-host requirements are just a
    writable /dev/shm for the SHM path."""
    import os

    if not os.access("/dev/shm", os.W_OK):
        Logger.warning("/dev/shm not writable: SHM path unavailable")
        return False
    return True


def _as_src_array(cache):
    """View `cache` as a C-contiguous host array without copying when
    possible. Device tensors go through infinistore_tpu_torch.cuda, which
    copies them straight into the pool."""
    if isinstance(cache, np.ndarray):
        arr = cache
    elif hasattr(cache, "__array__"):
        arr = np.asarray(cache)
    else:
        raise TypeError(f"unsupported cache type: {type(cache)!r}")
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("cache tensor must be contiguous")
    return arr


def _as_dst_array(cache):
    if isinstance(cache, np.ndarray):
        arr = cache
    elif type(cache).__module__.split(".")[0] == "torch":
        # CPU torch tensors share memory through __array__, so writes
        # into the view land in the tensor — same zero-copy in/out
        # contract as the reference's torch-first API (lib.py:522-565).
        # Non-CPU tensors must be rejected HERE: converting via .cpu()
        # would make the read land in a throwaway host copy while the
        # caller's device tensor stays silently stale.
        if getattr(cache, "device", None) is not None and \
                cache.device.type != "cpu":
            raise TypeError(
                "read destination must live in host memory; got a torch "
                f"tensor on {cache.device} (reads write in place — a "
                ".cpu() copy would not update your tensor)"
            )
        try:
            arr = np.asarray(cache.detach() if cache.requires_grad else cache)
        except Exception as e:
            raise TypeError(
                f"torch tensor not viewable as numpy ({e}); read "
                "destinations must be plain CPU tensors"
            ) from None
    else:
        raise TypeError(
            "read destination must be a writable numpy array or CPU "
            "torch tensor (use infinistore_tpu_torch.cuda to read into "
            "CUDA tensors)"
        )
    if not arr.flags["C_CONTIGUOUS"] or not arr.flags["WRITEABLE"]:
        raise ValueError("read destination must be contiguous and writable")
    return arr


def _hist_percentile_us(buckets, q):
    """Midpoint-of-bucket percentile over power-of-two buckets — the
    exact convention of the server's LatHist (trace.h), so client and
    server numbers are comparable bucket for bucket."""
    total = sum(buckets)
    if total == 0:
        return 0
    rank = int(q * (total - 1)) + 1
    seen = 0
    for b, n in enumerate(buckets):
        seen += n
        if seen >= rank:
            return (1 << b) + (1 << b) // 2
    return 1 << len(buckets)


def merge_fabric_stats(per_stats):
    """Merge per-connection ``client_stats()["fabric"]`` sections into
    one deployment-level view. Counters sum; ``ring_active`` is the AND across
    members ("does EVERY shard run the one-sided commit plane" — one
    downgraded shard is exactly the deployment bug to surface) while
    ``any_ring_active`` keeps the existence answer; ``stream_active``
    ORs (any cross-host member selects the stream shape)."""
    merged = {
        "ring_posts": 0, "doorbells": 0, "ring_fallbacks": 0,
        "ring_active": bool(per_stats), "any_ring_active": False,
        "stream_active": False,
    }
    for ps in per_stats:
        f = ps.get("fabric", {})
        merged["ring_posts"] += f.get("ring_posts", 0)
        merged["doorbells"] += f.get("doorbells", 0)
        merged["ring_fallbacks"] += f.get("ring_fallbacks", 0)
        merged["ring_active"] &= bool(f.get("ring_active"))
        merged["any_ring_active"] |= bool(f.get("ring_active"))
        merged["stream_active"] |= bool(f.get("stream_active"))
    return merged


class _ClientTelemetry:
    """Client-side op telemetry: per-op latency histograms in
    the SAME power-of-two bucket geometry as the server's LatHist
    (bucket b counts [2^b, 2^(b+1)) µs), plus counters for every retry/
    backoff/reconnect event the connection machinery performs silently.
    With server time on the op reply path (/stats op_stats) this
    decomposes client-visible latency into client+wire vs server time.

    ``ISTPU_CLIENT_STATS=0`` (read at connection construction) disables
    recording — the kill switch exists ONLY as the bench --obs-leg
    overhead denominator (client_telemetry_overhead_p50_ratio <= 1.02).

    When the connection traces (``ClientConfig.trace``), each recorded
    op also lands in a bounded span ring (CLOCK_MONOTONIC timebase via
    time.monotonic_ns — the same clock the server's span rings use, so
    same-host client and server spans align with zero skew) for
    tools/istpu_trace.py's merged timeline."""

    BUCKETS = 20  # LatHist::kBuckets

    def __init__(self, trace_spans=False):
        self.enabled = os.environ.get("ISTPU_CLIENT_STATS", "1") != "0"
        self._lock = threading.Lock()
        self._ops = {}       # name -> [count, total_us, bucket list]
        self._counters = {}
        self._spans = (
            collections.deque(maxlen=4096) if trace_spans else None
        )

    def record(self, op, t0_us, dur_us, trace_id=0):
        if not self.enabled:
            return
        us = int(dur_us)
        # bit_length is the C-speed form of the LatHist bucket loop
        # (us in [2^b, 2^(b+1)) -> b), clamped to the last bucket.
        b = us.bit_length() - 1
        if b < 0:
            b = 0
        elif b >= self.BUCKETS:
            b = self.BUCKETS - 1
        # GIL-relaxed increments (the Python analogue of the native
        # relaxed atomics): the lock guards only dict INSERTION and
        # the stats() copy — a cross-thread increment race can lose a
        # count, never corrupt, and the hot path stays under the 1.02
        # overhead budget the bench obs leg pins.
        try:
            h = self._ops[op]
        except KeyError:
            with self._lock:
                h = self._ops.setdefault(op, [0, 0, [0] * self.BUCKETS])
        h[0] += 1
        h[1] += us
        h[2][b] += 1
        if self._spans is not None:
            self._spans.append((op, int(t0_us), us, int(trace_id)))

    def bump(self, counter, n=1):
        if not self.enabled:
            return
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + n

    def stats(self):
        with self._lock:
            ops = {
                op: {
                    "count": c,
                    "total_us": t,
                    "p50_us": _hist_percentile_us(h, 0.50),
                    "p99_us": _hist_percentile_us(h, 0.99),
                    "hist": list(h),
                }
                for op, (c, t, h) in self._ops.items()
            }
            counters = dict(self._counters)
        return {"enabled": self.enabled, "ops": ops,
                "counters": counters}

    def trace_events(self, pid=0, label="client"):
        """Chrome trace-event dicts for the recorded client spans (one
        'client' thread track; ts/dur in CLOCK_MONOTONIC µs)."""
        evts = [{
            "ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
            "args": {"name": label},
        }]
        for op, t0_us, dur_us, tid in list(self._spans or ()):
            e = {"ph": "X", "pid": pid, "tid": 0, "name": op,
                 "cat": "client", "ts": t0_us, "dur": dur_us}
            if tid:
                e["args"] = {"trace_id": "0x%x" % tid}
            evts.append(e)
        return evts


class InfinityConnection:
    """A connection to one infinistore-tpu server.

    The method surface mirrors the reference ``InfinityConnection``:
    ``connect``, ``allocate_rdma``, ``rdma_write_cache``, ``read_cache``,
    ``local_gpu_write_cache``, ``sync``, ``check_exist``,
    ``get_match_last_index``, plus the async variants. Unified,
    path-agnostic names (``allocate``/``write_cache``) are the primary API.
    """

    def __init__(self, config: ClientConfig):
        config.verify()
        self.config = config
        self._lib = _native.get_lib()
        set_log_level(config.log_level)
        self._h = None
        self.connected = False
        self.shm_connected = False
        self.stream_connected = False
        # Negotiated cross-host fabric mode (set per connect from the
        # native telemetry): gates the put path so non-fabric servers
        # never pay the per-put argument prep for a doomed attempt.
        self._fabric_stream = False
        # Keep (callback, buffers) alive until async ops complete.
        self._keepalive = {}
        self._keepalive_id = 0
        self._keepalive_lock = threading.Lock()
        # Failures of pipelined writes, surfaced at the next sync()
        # (reference w_rdma posts WRs and returns; errors reach the
        # caller through the completion path + sync barrier).
        self._async_errors = []
        self._async_errors_lock = threading.Lock()
        # Reconnect bookkeeping: generation guards against concurrent
        # double-reconnects; dead handles are freed only at close().
        self._reconnect_lock = threading.Lock()
        self._conn_gen = 0
        # Consecutive reconnect-retries without an intervening success:
        # drives the exponential half of the retry backoff.
        self._retry_streak = 0
        self._dead_handles = []
        self._ever_connected = False
        # Request tracing (config.trace): each logical op stamps a
        # fresh 8-byte id onto its wire frames so the server's span
        # rings stitch the op's sub-rpcs together. Random base so two
        # clients' ids cannot collide; last_trace_id is what tests (and
        # humans grepping a Perfetto export) look for.
        self._trace_base = int.from_bytes(os.urandom(8), "little")
        self._trace_ctr = 0
        self._trace_pinned = False  # externally set id (sharded fan-out)
        self.last_trace_id = 0
        # Client-side telemetry (client_stats()): per-op latency
        # histograms + retry/backoff/reconnect counters; span ring for
        # istpu_trace when tracing is on. ISTPU_CLIENT_STATS=0 (read
        # here, once) disables — the bench overhead denominator only.
        self._telemetry = _ClientTelemetry(trace_spans=config.trace)
        self._tel_record = self._telemetry.record  # hot-path binding
        # Pin-cache tallies harvested from RETIRED native handles
        # (close/reconnect) — the counters live on the handle, and
        # client_stats() promises the final totals even after close.
        self._pin_cache_base = [0, 0]
        # Fabric counters accumulated from retired handles (same
        # harvest-on-reconnect discipline as the pin-cache tallies):
        # ring_posts, doorbells, ring_fallbacks.
        self._fabric_base = [0, 0, 0, 0, 0]
        # Calls inside the native handle (in_use) and whether close()
        # has begun: close() waits for those calls before it frees the
        # handle, and refuses new ones meanwhile.
        self._users = 0
        self._users_cv = threading.Condition()
        self._closing = False

    # ------------------------------------------------------------------
    # connection lifecycle
    # ------------------------------------------------------------------

    def connect(self):
        if self.connected:
            raise Exception("Already connected")
        want_shm = self.config.connection_type in (TYPE_SHM, TYPE_AUTO)
        if self.config.connection_type == TYPE_SHM and self.config.host_addr not in (
            "127.0.0.1",
            "localhost",
        ):
            raise Exception("SHM connection must be to localhost")
        # Build the new connection entirely on a local before publishing:
        # self._h is read by concurrent threads (reconnect discipline keeps
        # it pointing at a live or closed-but-unfreed handle), so a
        # half-connected handle that this method is about to destroy on
        # failure must never be visible through it.
        h = self._lib.ist_conn_create(
            self.config.host_addr.encode(),
            self.config.service_port,
            1 if want_shm else 0,
            self.config.window_bytes,
            self.config.timeout_ms,
            1 if self.config.use_lease else 0,
            self.config.lease_blocks,
            self.config.flush_size,
            1 if self.config.use_fabric else 0,
            1 if self.config.use_dedup else 0,
        )
        if not h:
            raise Exception("Failed to create connection")
        with self._users_cv:
            self._closing = False
        if self._lib.ist_conn_connect(h) != 0:
            self._lib.ist_conn_destroy(h)  # never published: safe to free
            raise Exception(
                f"Failed to connect to "
                f"{self.config.host_addr}:{self.config.service_port}"
            )
        shm_active = bool(self._lib.ist_conn_shm_active(h))
        if self.config.connection_type == TYPE_SHM and not shm_active:
            # Tear down only the handle we just created — NOT close(),
            # which would also free handles parked by reconnects while
            # other threads may still be inside native calls on them.
            self._lib.ist_conn_close(h)
            self._lib.ist_conn_destroy(h)
            raise Exception("SHM path requested but unavailable")
        self._h = h
        self.shm_connected = shm_active
        self.stream_connected = not shm_active
        # One telemetry read caches what connect_server actually
        # negotiated (stream mode only exists against fabric-capable
        # servers with use_lease) — the put path gates on this, not on
        # the config wish.
        self._fabric_stream = False
        if self.config.use_fabric:
            z = ct.c_uint64(0)
            modes = ct.c_int(0)
            self._lib.ist_conn_fabric_telemetry(
                h, ct.byref(z), ct.byref(z), ct.byref(z),
                ct.byref(modes))
            self._fabric_stream = bool(modes.value & 2)
        self.connected = True
        self._ever_connected = True
        return 0

    def close(self):
        # New calls are refused from here on; calls another thread has
        # inside the handle (in_use: a write-behind worker's allocate,
        # write or sync) end first, up to the connection's timeout.
        with self._users_cv:
            self._closing = True
            self._users_cv.wait_for(lambda: not self._users,
                                    timeout=self.config.timeout_ms / 1000)
        # Under _reconnect_lock: close() DESTROYS native handles, and
        # both the reconnect machinery and client_stats() (documented
        # for exactly the poll-from-another-thread pattern) read
        # self._h under the same lock — without it a concurrent
        # telemetry read could dereference a freed Connection*.
        with self._reconnect_lock:
            self._close_locked()

    @contextlib.contextmanager
    def in_use(self):
        """A stretch of calls on this connection, on any thread, that
        ``close`` waits for before it frees the native handle and unmaps
        the pools (the SHM copies into them included). Once ``close`` has
        begun it raises as a closed connection does."""
        with self._users_cv:
            if self._closing:
                raise Exception("Not connected to any instance")
            self._users += 1
        try:
            yield
        finally:
            with self._users_cv:
                self._users -= 1
                if not self._users:
                    self._users_cv.notify_all()

    def _free_handle(self, h):
        """``ist_conn_destroy(h)`` once no call is inside the handle:
        ``ist_conn_close`` woke any that waited. A call still inside
        after that keeps the handle alive for good (_UNFREED_HANDLES)."""
        with self._users_cv:
            idle = self._users_cv.wait_for(lambda: not self._users,
                                           timeout=2.0)
        if not idle:
            _UNFREED_HANDLES.append(h)
            Logger.warning("close: a call is still inside the connection; "
                           "its native handle is left unfreed")
            return
        self._lib.ist_conn_destroy(h)

    def _close_locked(self):
        # After a FAILED reconnect, self._h still points at a handle
        # that is ALSO parked in _dead_handles (_reconnect_locked only
        # republishes on success) — destroying it through both paths is
        # a double free (glibc abort; hit by the sharded background
        # redial loop when a shard stays down until close()).
        if self._h and self._h not in self._dead_handles:
            self._harvest_pin_counts(self._h)
            if self.config.use_lease and self.connected:
                # Best-effort: commit the pending deferred batch before
                # teardown, bounded so close() can never hang on a dead
                # server — put_cache(); close() without a sync() then
                # stays loss-free on a healthy one (the pre-lease
                # synchronous-put behavior).
                try:
                    self._lib.ist_lease_flush(self._h)
                    st = self._lib.ist_sync(
                        self._h, min(self.config.timeout_ms, 2000)
                    )
                    lerr = self._lib.ist_lease_take_error(self._h)
                    if st != OK or lerr:
                        # close() must not raise, but a lost tail batch
                        # must not vanish silently either.
                        Logger.warning(
                            "close: deferred leased commit may be lost "
                            f"(sync={status_name(st)}, "
                            f"err={status_name(lerr) if lerr else 'none'})"
                        )
                except Exception:
                    pass
            self._lib.ist_conn_close(self._h)
            self._free_handle(self._h)
        self._h = None
        for h in self._dead_handles:  # handles parked by reconnects
            self._free_handle(h)
        self._dead_handles = []
        self.connected = False
        self.shm_connected = False
        self.stream_connected = False
        self._fabric_stream = False
        self._ever_connected = False  # explicit close: no auto re-dial

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _check(self):
        if self.connected:
            return
        if self.config.auto_reconnect and self._ever_connected:
            # Either a reconnect is in progress on another thread (wait it
            # out — the lock is held for the whole close+connect) or a
            # previous reconnect attempt failed while the server was still
            # down: re-dial here so the client recovers once the server is
            # back instead of being wedged until a manual reconnect().
            with self._reconnect_lock:
                if self.connected:
                    return
                try:
                    self._reconnect_locked()
                    return
                except Exception:
                    pass
        raise Exception("Not connected to any instance")

    def reconnect(self):
        """Tear down and re-establish this connection on a fresh native
        handle (beyond reference parity — the reference has no client
        reconnect, SURVEY.md §5). Outstanding async ops complete with
        INTERNAL_ERROR; RemoteBlocks/tokens obtained before the reconnect
        are invalid (allocate again). After a server restart the SHM pool
        table is re-negotiated via HELLO, so both paths come back."""
        with self._reconnect_lock:
            self._reconnect_locked()
        return 0

    def _reconnect_locked(self):
        # Close the old handle (shuts fds, joins the IO thread, fails all
        # pending ops) but DEFER freeing it until the final close():
        # another thread may still be inside a native call on it, and a
        # closed-but-live handle fails such calls safely while a freed one
        # is a use-after-free.
        # After a FAILED reconnect self._h still points at the handle a
        # previous attempt parked (connect() only republishes on success),
        # so guard against parking the same handle twice — close() would
        # otherwise double-destroy it.
        if self._h and self._h not in self._dead_handles:
            # Fold the retiring handle's pin-cache tallies into the
            # Python-side base — the replacement handle restarts at 0.
            self._harvest_pin_counts(self._h)
            self._lib.ist_conn_close(self._h)
            if self.config.use_lease:
                # Deferred-commit failures latch on the NATIVE handle
                # (in-flight OP_COMMIT_BATCHes failed by the teardown,
                # un-flushed pend batches wiped by close): harvest them
                # into the Python-side error list — which survives the
                # handle swap — or the next sync() would report success
                # for leased puts that never committed.
                lerr = self._lib.ist_lease_take_error(self._h)
                if lerr:
                    with self._async_errors_lock:
                        self._async_errors.append(lerr)
            self._dead_handles.append(self._h)
            # Leave self._h pointing at the closed handle until connect()
            # swaps in the new one: a concurrent thread mid-call fails
            # safely on a closed handle, but would NULL-deref on None
            # (the capi layer also guards NULL as a backstop).
        self.connected = False
        self.shm_connected = False
        self.stream_connected = False
        self.connect()
        self._conn_gen += 1
        self._telemetry.bump("reconnects")

    # Connection-level statuses worth a reconnect+retry. Definitive store
    # answers (KEY_NOT_FOUND, CONFLICT, OUT_OF_MEMORY, BAD_REQUEST) are
    # never retried.
    _RETRYABLE = (TIMEOUT_ERR, _native.INTERNAL_ERROR)

    def _run_reconnecting(self, fn, keys=None):
        """Run ``fn``; when ``config.auto_reconnect`` is set, the error is
        a connection-level status AND the native connection reports itself
        broken (socket failure or timeout teardown — not an op-level error
        on a healthy connection), reconnect once and retry. Only
        key-addressed ops use this — token-based ops (write_cache/commit)
        cannot be replayed because tokens die with the server session.

        ``keys``: for put/allocate retries — keys the dead connection had
        allocated but never committed may still be dedup-poisoned if the
        server has not yet processed the old socket's close (which aborts
        them). One batched OP_RECLAIM erases exactly those orphans (never
        a concurrent writer's live allocation) so the retry can
        re-allocate them."""
        h0 = self._h
        gen = self._conn_gen
        try:
            out = fn()
            self._retry_streak = 0
            return out
        except InfiniStoreError as e:
            self._reconnect_for_retry(e, h0, gen, keys)
            out = fn()
            self._retry_streak = 0
            return out

    def _reconnect_for_retry(self, e, h0, gen, keys):
        """The recovery half of :meth:`_run_reconnecting`: decide whether
        the failure ``e`` (seen on handle ``h0`` at generation ``gen``)
        warrants a reconnect+retry; re-raise ``e`` when it does not,
        otherwise reconnect (unless someone already did) and reclaim
        orphaned ``keys``. Blocking — the async paths call it off-loop."""
        if (
            not self.config.auto_reconnect
            or e.status not in self._RETRYABLE
        ):
            raise e
        with self._reconnect_lock:
            if self._conn_gen == gen:
                # Nobody reconnected since our attempt; only do it if
                # the connection is actually dead.
                if not self._h or not self._lib.ist_conn_broken(self._h):
                    raise e
                Logger.warning(f"connection failure ({e}); reconnecting")
                self._reconnect_locked()
            elif self._h == h0:
                # Generation moved but the handle did not change: the
                # reconnect predates our attempt, so our failure is
                # its own story — don't mask it with a retry.
                raise e
            if keys:
                self._reclaim_orphans(keys)
        # Bounded exponential backoff with jitter BETWEEN the reconnect
        # and the retry: a
        # restarting server greets a fleet of auto_reconnect clients
        # all at once, and the jitter de-synchronizes their replays.
        # Doubles per consecutive retry (streak reset on any success),
        # bounded at 2 s; retry_backoff_ms=0 restores immediate retry.
        self._telemetry.bump("retries")
        base_ms = getattr(self.config, "retry_backoff_ms", 0)
        if base_ms > 0:
            self._retry_streak = min(self._retry_streak + 1, 6)
            cap_ms = min(base_ms * (1 << (self._retry_streak - 1)), 2000)
            self._telemetry.bump("backoff_sleeps")
            time.sleep(random.uniform(0.5, 1.0) * cap_ms / 1000.0)

    def _retry_busy(self, attempt):
        """Run ``attempt(remaining_ms)`` retrying the read path's two
        RETRYABLE statuses with exponential backoff until
        ``config.timeout_ms`` elapses: BUSY (server-side backpressure —
        this connection has too many response bytes queued or lease
        bytes pinned) and OUT_OF_MEMORY (disk-tier promotion found no
        free pool blocks RIGHT NOW — documented retryable, never a data
        loss; under a saturated pool the background reclaimer / spill
        writer frees blocks within milliseconds, e.g. when a concurrent
        spill transiently claimed the space a bounce-swap expected).
        The remaining budget is handed to each attempt so native waits
        never extend the caller's total bound past the configured
        timeout. Delays double per attempt with jitter, bounded by
        ``config.retry_backoff_ms`` (the OP_PIN-on-disk-key BUSY path —
        the promotion worker adopts within a few ms, so the cap keeps
        the post-adoption retry prompt while the jitter keeps a fleet
        of pinners from re-arriving in lockstep). Returns the final
        status."""
        deadline = time.monotonic() + self.config.timeout_ms / 1000.0
        delay = 0.001
        cap = self._busy_retry_cap_s()
        retryable = (_native.BUSY, _native.OUT_OF_MEMORY)
        while True:
            remaining_ms = int(max(1, (deadline - time.monotonic()) * 1000))
            st = attempt(remaining_ms)
            if st not in retryable or time.monotonic() >= deadline:
                return st
            self._telemetry.bump("busy_retries")
            time.sleep(delay * random.uniform(0.5, 1.0))
            delay = min(delay * 2, cap)

    def _busy_retry_cap_s(self):
        """Max per-attempt delay (seconds) for the BUSY/OOM backoff
        loops — sync and async share this so the pacing contract lives
        in one place. ``retry_backoff_ms=0`` disables only the
        reconnect-side sleep; the busy loops keep the historical 50 ms
        cap (config.py contract)."""
        base_ms = getattr(self.config, "retry_backoff_ms", 50)
        return (base_ms if base_ms > 0 else 50) / 1000.0

    def _stamp_trace(self):
        """Stamp a fresh per-logical-op trace id onto the native
        connection (no-op unless ``config.trace``). Every wire frame
        sent until the next stamp carries this id — including a
        deferred lease-commit flush triggered by this op."""
        if not self.config.trace or not self._h:
            return 0
        if self._trace_pinned:
            # A caller spanning one logical op across connections (the
            # sharded client) owns the id; per-op stamping stands down.
            return self.last_trace_id
        self._trace_ctr += 1
        tid = (self._trace_base + self._trace_ctr) & ((1 << 64) - 1)
        if tid == 0:
            tid = 1
        self.last_trace_id = tid
        _log_tls.trace_id = tid  # log-line correlation (ISTPU_LOG_JSON)
        self._lib.ist_conn_set_trace(self._h, tid)
        return tid

    def _record_op(self, op, t0, tid=0):
        """Telemetry tail of a public op: one histogram record (and, in
        trace mode, one client span) covering the WHOLE client-visible
        call — retries, backoff sleeps and reconnects included, which
        is exactly the latency the caller experienced. ``t0`` is a
        ``time.perf_counter()`` stamp — CLOCK_MONOTONIC on Linux, the
        exact clock the native span rings read, in float seconds (the
        float math keeps the hot path under the 1.02 overhead gate;
        float64 µs precision is sub-µs for any realistic uptime)."""
        self._tel_record(
            op, t0 * 1e6, (time.perf_counter() - t0) * 1e6, tid
        )
        # The op is over: retire ITS id from the log-correlation slot
        # (ISTPU_LOG_JSON lines after this point must not claim a
        # finished op). Conditional — a nested op (put_cache's inner
        # allocate) or a newer stamp owns the slot by now and must not
        # be clobbered.
        if tid and getattr(_log_tls, "trace_id", 0) == tid:
            _log_tls.trace_id = 0

    def _harvest_pin_counts(self, h):
        """Fold a retiring handle's native pin-cache AND fabric
        tallies into the Python-side bases (the counters die with the
        handle — without this a reconnect would silently reset
        client_stats()'s fabric section while its neighbors keep
        history)."""
        hits = ct.c_uint64(0)
        misses = ct.c_uint64(0)
        self._lib.ist_conn_telemetry(h, ct.byref(hits), ct.byref(misses))
        self._pin_cache_base[0] += int(hits.value)
        self._pin_cache_base[1] += int(misses.value)
        posts = ct.c_uint64(0)
        bells = ct.c_uint64(0)
        falls = ct.c_uint64(0)
        modes = ct.c_int(0)
        self._lib.ist_conn_fabric_telemetry(
            h, ct.byref(posts), ct.byref(bells), ct.byref(falls),
            ct.byref(modes))
        self._fabric_base[0] += int(posts.value)
        self._fabric_base[1] += int(bells.value)
        self._fabric_base[2] += int(falls.value)
        det = ct.c_uint64(0)
        rea = ct.c_uint64(0)
        self._lib.ist_conn_fabric_ring_stats(
            h, ct.byref(det), ct.byref(rea))
        self._fabric_base[3] += int(det.value)
        self._fabric_base[4] += int(rea.value)

    def client_stats(self):
        """Client-side telemetry: per-op latency histograms (power-of-
        two buckets, the server's LatHist geometry) and the counters
        for everything the connection machinery does silently —
        retries, backoff sleeps, reconnects, BUSY-loop retries, lease
        flushes, pin-cache hits/misses (native, lease-mode SHM reads).
        Works on a closed connection (the final tallies: retired
        handles' pin-cache counts are harvested at close/reconnect)."""
        out = self._telemetry.stats()
        hits = ct.c_uint64(0)
        misses = ct.c_uint64(0)
        # Under _reconnect_lock: close() destroys handles under the
        # same lock, so the handle read here can never race into a
        # freed Connection*. Parked (already-harvested) handles are
        # skipped — their counts live in the base; reading them again
        # would double count.
        posts = ct.c_uint64(0)
        bells = ct.c_uint64(0)
        falls = ct.c_uint64(0)
        modes = ct.c_int(0)
        det = ct.c_uint64(0)
        rea = ct.c_uint64(0)
        with self._reconnect_lock:
            if self._h and self._h not in self._dead_handles:
                self._lib.ist_conn_telemetry(
                    self._h, ct.byref(hits), ct.byref(misses)
                )
                self._lib.ist_conn_fabric_telemetry(
                    self._h, ct.byref(posts), ct.byref(bells),
                    ct.byref(falls), ct.byref(modes),
                )
                self._lib.ist_conn_fabric_ring_stats(
                    self._h, ct.byref(det), ct.byref(rea)
                )
            out["counters"]["pin_cache_hits"] = (
                self._pin_cache_base[0] + int(hits.value)
            )
            out["counters"]["pin_cache_misses"] = (
                self._pin_cache_base[1] + int(misses.value)
            )
            # One-sided fabric plane (use_fabric): shm-ring commit
            # records posted, doorbell frames sent, ring-full TCP
            # fallbacks (retired handles' tallies folded in, same as
            # the pin-cache counters), and which fabric mode this
            # connection runs.
            out["fabric"] = {
                "ring_posts": self._fabric_base[0] + int(posts.value),
                "doorbells": self._fabric_base[1] + int(bells.value),
                "ring_fallbacks":
                    self._fabric_base[2] + int(falls.value),
                "ring_active": bool(modes.value & 1),
                "stream_active": bool(modes.value & 2),
                # Ring-pool lifecycle (ABI v18): server-initiated
                # detaches (LRU reclaim under ISTPU_FABRIC_RING_POOL
                # pressure) and successful re-attaches after one.
                "ring_detaches":
                    self._fabric_base[3] + int(det.value),
                "ring_reattaches":
                    self._fabric_base[4] + int(rea.value),
            }
            # Hash-first dedup probe verdicts (use_dedup, ABI v16):
            # HAVE = duplicate puts committed with zero payload bytes.
            have = ct.c_uint64(0)
            need = ct.c_uint64(0)
            if self._h and self._h not in self._dead_handles:
                self._lib.ist_conn_dedup_telemetry(
                    self._h, ct.byref(have), ct.byref(need)
                )
            out["dedup"] = {
                "have_verdicts": int(have.value),
                "need_verdicts": int(need.value),
            }
        return out

    def client_trace_events(self, pid=0, label="client"):
        """Chrome trace-event dicts for the client-side op spans (empty
        unless ``config.trace``); tools/istpu_trace.py merges them with
        the per-shard server /trace exports into one timeline."""
        return self._telemetry.trace_events(pid=pid, label=label)

    def client_trace_json(self):
        return json.dumps({
            "displayTimeUnit": "ms",
            "traceEvents": self.client_trace_events(),
        })

    def set_trace_id(self, trace_id):
        """Set (or clear, with 0) the trace id carried by outgoing
        frames — for callers that span one logical op across several
        connections (the sharded client fans one id out per shard).
        While set, per-op auto-stamping stands down; 0 re-enables it."""
        self._check()
        self._trace_pinned = trace_id != 0
        self.last_trace_id = trace_id
        _log_tls.trace_id = trace_id
        self._lib.ist_conn_set_trace(self._h, trace_id)

    def _reclaim_orphans(self, keys):
        # One batched rpc; the server erases only entries that are
        # uncommitted AND have no live inflight token (their writer died
        # before commit) — a concurrent writer's in-progress allocation
        # of the same key is never disturbed.
        blob = pack_keys(keys)
        n = ct.c_uint64(0)
        st = self._lib.ist_reclaim_orphans(
            self._h, blob, len(blob), len(keys), ct.byref(n)
        )
        if st == OK and n.value:
            Logger.warning(f"reclaimed {n.value} orphaned key(s) on retry")

    # ------------------------------------------------------------------
    # allocate
    # ------------------------------------------------------------------

    def allocate(self, keys, page_size_in_bytes):
        """Reserve uncommitted blocks for ``keys``; returns a numpy
        structured array of RemoteBlocks (status, pool_idx, token, offset).
        Duplicated keys come back with ``token == FAKE_TOKEN`` and are
        skipped on write (first-writer-wins dedup, reference
        infinistore.cpp:353-359)."""
        with self.in_use():
            self._check()
            tid = self._stamp_trace()
            t0 = time.perf_counter()
            try:
                return self._run_reconnecting(
                    lambda: self._allocate_once(keys, page_size_in_bytes),
                    keys=keys,
                )
            finally:
                self._record_op("allocate", t0, tid)

    def _allocate_once(self, keys, page_size_in_bytes):
        blob = pack_keys(keys)
        out = np.zeros(len(keys), dtype=REMOTE_BLOCK_DTYPE)
        st = self._lib.ist_allocate(
            self._h,
            blob,
            len(blob),
            len(keys),
            page_size_in_bytes,
            out.ctypes.data_as(ct.c_void_p),
        )
        if st != OK:
            raise InfiniStoreError(st, "allocate failed")
        if (out["status"] == _native.OUT_OF_MEMORY).any():
            # Roll back the successful part of the batch: leaving those
            # entries uncommitted would dedup-poison the keys (future
            # allocates return FAKE, writes silently skip, reads 404).
            ok_tokens = out["token"][out["status"] == OK]
            if len(ok_tokens):
                self.abort(ok_tokens)
            raise InfiniStoreError(_native.OUT_OF_MEMORY, "allocate failed")
        return out

    # Reference-compatible alias (lib.py:685-707).
    def allocate_rdma(self, keys, page_size_in_bytes):
        return self.allocate(keys, page_size_in_bytes)

    async def allocate_rdma_async(self, keys, page_size_in_bytes):
        """Native async allocate: the OP_ALLOCATE rpc rides the
        connection's IO thread and completes via callback onto the
        running loop — no thread-pool hop on the happy path (the
        reference's allocate is a native async op with a promise,
        libinfinistore.cpp:748-858). Connection failures get the same
        reconnect + orphan-reclaim + single-retry treatment as the sync
        path (that recovery runs off-loop — error path only)."""
        self._check()
        h0, gen = self._h, self._conn_gen
        try:
            out = await self._allocate_async_rpc(keys, page_size_in_bytes)
        except InfiniStoreError as e:
            await asyncio.get_running_loop().run_in_executor(
                None, self._reconnect_for_retry, e, h0, gen, keys
            )
            out = await self._allocate_async_rpc(keys, page_size_in_bytes)
        if (out["status"] == _native.OUT_OF_MEMORY).any():
            # Same batch rollback as the sync path (abort is a sync rpc,
            # so it must not run on the loop — error path only).
            ok_tokens = out["token"][out["status"] == OK]
            if len(ok_tokens):
                await asyncio.get_running_loop().run_in_executor(
                    None, self.abort, ok_tokens
                )
            raise InfiniStoreError(_native.OUT_OF_MEMORY, "allocate failed")
        return out

    async def _allocate_async_rpc(self, keys, page_size_in_bytes):
        blob = pack_keys(keys)
        out = np.zeros(len(keys), dtype=REMOTE_BLOCK_DTYPE)
        loop = asyncio.get_running_loop()
        future = loop.create_future()

        def cb(status):
            loop.call_soon_threadsafe(
                _finish_future, future, status, "allocate"
            )

        ka = self._keep(cb, (blob, out))
        st = self._lib.ist_allocate_async(
            self._h, blob, len(blob), len(keys), page_size_in_bytes,
            out.ctypes.data_as(ct.c_void_p), ka.c_cb, None,
        )
        if st != OK:
            self._drop_keep(ka.kid)
            raise InfiniStoreError(st, "allocate submit failed")
        try:
            # Bounded promise (reference: 5 s allocate timeout,
            # libinfinistore.cpp:760); we use the config timeout.
            await asyncio.wait_for(future, self.config.timeout_ms / 1000)
        except asyncio.TimeoutError:
            raise InfiniStoreError(
                TIMEOUT_ERR, "allocate timed out"
            ) from None
        return out

    allocate_async = allocate_rdma_async

    # ------------------------------------------------------------------
    # write
    # ------------------------------------------------------------------

    def _prep_write(self, cache, offsets, page_size, remote_blocks):
        arr = _as_src_array(cache)
        esize = arr.itemsize
        page_bytes = page_size * esize
        blocks = np.ascontiguousarray(remote_blocks, dtype=REMOTE_BLOCK_DTYPE)
        if len(offsets) != len(blocks):
            raise ValueError("offsets and remote_blocks length mismatch")
        real = blocks["token"] != FAKE_TOKEN
        if (blocks["size"][real] < page_bytes).any():
            raise ValueError(
                "page size exceeds the allocated block size for at least "
                "one key (allocate() and write_cache() sizes must agree)"
            )
        base = arr.ctypes.data
        nbytes = arr.nbytes
        # Vectorized address math: thousands of 4 KB pages per batch make
        # a per-block Python loop the hot path (it was ~40% of put time).
        byte_offs = np.asarray(offsets, dtype=np.int64) * esize
        if len(byte_offs) and (
            int(byte_offs.min()) < 0
            or int(byte_offs.max()) + page_bytes > nbytes
        ):
            raise ValueError("offset out of tensor bounds")
        srcs = (np.uint64(base) + byte_offs.astype(np.uint64))
        return arr, page_bytes, blocks, srcs, blocks["token"]

    def _write_async_native(self, cache, offsets, page_size, remote_blocks, cb):
        """Shared async write plumbing; picks SHM vs STREAM path."""
        arr, page_bytes, blocks, srcs, toks = self._prep_write(
            cache, offsets, page_size, remote_blocks
        )
        n = len(srcs)
        src_arr = np.ascontiguousarray(srcs, dtype=np.uint64)
        src_ptr = src_arr.ctypes.data_as(ct.POINTER(ct.c_void_p))
        ka = self._keep(cb, (arr, blocks, src_arr))
        if self.shm_connected:
            # The server may have auto-extended into pools we haven't
            # mapped yet; refresh before the native copy so it never sees
            # an unmapped pool_idx (it fails the op rather than committing
            # unwritten blocks if this races).
            if len(blocks) and int(blocks["pool_idx"].max()) >= int(
                self._lib.ist_pool_count(self._h)
            ):
                self.refresh_pools()
            st = self._lib.ist_shm_write_async(
                self._h, page_bytes, n,
                blocks.ctypes.data_as(ct.c_void_p), src_ptr, ka.c_cb, None,
            )
        else:
            # Streamed path: skip FAKE (dedup) blocks client-side
            # (reference skips fake blocks in the WR chain,
            # libinfinistore.cpp:905-910).
            real = np.asarray(toks) != FAKE_TOKEN
            if not real.any():
                self._drop_keep(ka.kid)
                cb(OK)
                return
            r_toks = np.ascontiguousarray(toks[real], dtype=np.uint64)
            r_srcs = np.ascontiguousarray(src_arr[real], dtype=np.uint64)
            rn = len(r_toks)
            ka.bufs = (arr, blocks, r_toks, r_srcs)
            st = self._lib.ist_write_async(
                self._h, page_bytes, rn,
                r_toks.ctypes.data_as(ct.POINTER(ct.c_uint64)),
                r_srcs.ctypes.data_as(ct.POINTER(ct.c_void_p)),
                ka.c_cb, None,
            )
        if st != OK:
            self._drop_keep(ka.kid)
            raise InfiniStoreError(st, "write submit failed")

    def write_cache(self, cache, offsets, page_size, remote_blocks):
        """Write ``len(offsets)`` pages of ``page_size`` elements from
        ``cache`` into previously allocated ``remote_blocks``.
        Offsets/page_size are in elements (scaled by the tensor element
        size, matching reference lib.py:460-472).

        Pipelined: submits the write and returns; call :meth:`sync` to
        barrier. Server-side failures raise from the next ``sync()``
        (reference parity: w_rdma posts WRs and returns,
        libinfinistore.cpp:860-864; completion errors surface through the
        sync barrier). Client-side validation (bad offsets, page larger
        than allocation) still raises here. Do not mutate ``cache``
        before ``sync()`` — the copy may not have happened yet (same
        contract as posting an RDMA WRITE from a user buffer)."""
        with self.in_use():
            self._check()
            self._write_async_native(
                cache, offsets, page_size, remote_blocks,
                self._record_status
            )
        return 0

    def _record_status(self, status):
        if status != OK:
            with self._async_errors_lock:
                self._async_errors.append(status)

    def rdma_write_cache(self, cache, offsets, page_size, remote_blocks):
        return self.write_cache(cache, offsets, page_size, remote_blocks)

    async def rdma_write_cache_async(self, cache, offsets, page_size,
                                     remote_blocks):
        self._check()
        loop = asyncio.get_running_loop()
        future = loop.create_future()

        def cb(status):
            loop.call_soon_threadsafe(_finish_future, future, status, "write")

        self._write_async_native(cache, offsets, page_size, remote_blocks, cb)
        return await future

    write_cache_async = rdma_write_cache_async

    def _put_async_native(self, cache, blocks, page_size, cb,
                          try_fabric=True, try_dedup=True):
        """One-call put of (key, offset) pairs.

        STREAM path: a single OP_PUT round trip (server allocates, scatters
        the payload into the pool and commits — the same 1-RTT shape as the
        reference's local rw_local, infinistore.cpp:702-804).
        SHM path: allocate rpc + one-sided memcpy + commit (2 RTTs but the
        bulk bytes never cross a socket)."""
        if try_dedup and self.config.use_dedup and blocks:
            # Hash-first two-phase put (docs/design.md
            # "Content-addressed dedup"): probe with content hashes,
            # then ship only the NEED subset on the paths below. Pages
            # the server already holds commit with zero payload bytes.
            blocks = self._dedup_filter_blocks(cache, blocks, page_size)
            if not blocks:
                cb(OK)
                return
        arr = _as_src_array(cache)
        esize = arr.itemsize
        page_bytes = page_size * esize
        keys = [k for k, _ in blocks]
        if self.shm_connected and self.config.use_lease:
            # Lease fast path: zero-RTT carve + one-sided copy; the
            # commit is DEFERRED into the connection's pending batch
            # (sync() barriers it; failures surface there, like
            # pipelined writes). PARTIAL means the lease machinery
            # cannot serve this shape (no ctl page, fragmented grant,
            # page larger than any lease) — fall through to the legacy
            # allocate+write+commit path below.
            if self._lease_put_native(arr, blocks, page_bytes, keys):
                cb(OK)
                return
        if try_fabric and self._fabric_stream:
            # Cross-host fabric put (OP_FABRIC_WRITE; gated on the
            # NEGOTIATED stream mode, so non-fabric servers never pay
            # the prep): one frame whose payload the server scatters
            # straight into lease-carved blocks — commit included, no
            # allocate round trip. The native call blocks until the
            # server's commit response; PARTIAL (fragmented grant,
            # oversized batch) falls through to the legacy put.
            if self._fabric_put_native(arr, blocks, page_bytes, keys):
                cb(OK)
                return
        if self.shm_connected:
            # allocate + one-sided memcpy + commit; _write_async_native
            # does the offset validation.
            remote_blocks = self.allocate(keys, page_bytes)
            offsets = [off for _, off in blocks]
            self._write_async_native(
                cache, offsets, page_size, remote_blocks, cb
            )
            return
        base = arr.ctypes.data
        nbytes = arr.nbytes
        srcs = []
        for _, off in blocks:
            byte_off = off * esize
            if byte_off < 0 or byte_off + page_bytes > nbytes:
                raise ValueError("offset out of tensor bounds")
            srcs.append(base + byte_off)
        n = len(srcs)
        blob = pack_keys(keys)
        src_arr = (ct.c_void_p * n)(*srcs)
        ka = self._keep(cb, (arr, blob, src_arr))
        st = self._lib.ist_put_async(
            self._h, page_bytes, blob, len(blob), n, src_arr, ka.c_cb, None
        )
        if st != OK:
            self._drop_keep(ka.kid)
            raise InfiniStoreError(st, "put submit failed")

    def _lease_put_native(self, arr, blocks, page_bytes, keys):
        """Blocking native leased put (carve + copy + deferred commit).
        Returns True when the lease path handled the batch, False when
        the caller should fall back to the legacy path."""
        esize = arr.itemsize
        base = arr.ctypes.data
        nbytes = arr.nbytes
        byte_offs = (
            np.asarray([off for _, off in blocks], dtype=np.int64) * esize
        )
        if len(byte_offs) and (
            int(byte_offs.min()) < 0
            or int(byte_offs.max()) + page_bytes > nbytes
        ):
            raise ValueError("offset out of tensor bounds")
        srcs = np.uint64(base) + byte_offs.astype(np.uint64)
        src_arr = np.ascontiguousarray(srcs, dtype=np.uint64)
        blob = pack_keys(keys)
        st = self._lib.ist_lease_put(
            self._h, page_bytes, blob, len(blob), len(keys),
            src_arr.ctypes.data_as(ct.POINTER(ct.c_void_p)),
        )
        if st == OK:
            return True
        if st == _native.PARTIAL:
            return False  # lease path unfit for this shape
        raise InfiniStoreError(st, "leased put failed")

    def _fabric_put_native(self, arr, blocks, page_bytes, keys):
        """Blocking cross-host one-sided put (OP_FABRIC_WRITE): the
        batch mirror-carves out of ONE lease client-side and the
        server scatters the single frame's payload straight into the
        carved pool blocks, committing at payload end. True = handled;
        False = fabric path unfit for this shape (fall back to the
        legacy put)."""
        esize = arr.itemsize
        base = arr.ctypes.data
        nbytes = arr.nbytes
        byte_offs = (
            np.asarray([off for _, off in blocks], dtype=np.int64) * esize
        )
        if len(byte_offs) and (
            int(byte_offs.min()) < 0
            or int(byte_offs.max()) + page_bytes > nbytes
        ):
            raise ValueError("offset out of tensor bounds")
        srcs = np.uint64(base) + byte_offs.astype(np.uint64)
        src_arr = np.ascontiguousarray(srcs, dtype=np.uint64)
        blob = pack_keys(keys)
        st = self._lib.ist_fabric_put(
            self._h, page_bytes, blob, len(blob), len(keys),
            src_arr.ctypes.data_as(ct.POINTER(ct.c_void_p)),
            self.config.timeout_ms,
        )
        if st == OK:
            self._telemetry.bump("fabric_puts")
            return True
        if st == _native.PARTIAL:
            return False
        raise InfiniStoreError(st, "fabric put failed")

    def _dedup_filter_blocks(self, cache, blocks, page_size):
        """Hash-first dedup probe (OP_PUT_HASH): hash every page with
        the wire-stable native content hash, send {key, h1, h2} per
        page, and return only the blocks the server answered NEED for.
        HAVE pages were committed server-side by pinning the existing
        bytes (zero payload transfer, zero pool growth); EXISTS pages
        are already present (first-writer-wins, the same outcome the
        payload path would report). A probe FAILURE returns the full
        batch — dedup is an optimization, never a reason to fail a
        put."""
        arr = _as_src_array(cache)
        esize = arr.itemsize
        page_bytes = page_size * esize
        base = arr.ctypes.data
        nbytes = arr.nbytes
        n = len(blocks)
        hashes = np.empty(2 * n, dtype=np.uint64)
        h1 = ct.c_uint64(0)
        h2 = ct.c_uint64(0)
        for i, (_, off) in enumerate(blocks):
            byte_off = off * esize
            if byte_off < 0 or byte_off + page_bytes > nbytes:
                raise ValueError("offset out of tensor bounds")
            self._lib.ist_content_hash(
                ct.c_void_p(base + byte_off), page_bytes,
                ct.byref(h1), ct.byref(h2),
            )
            hashes[2 * i] = h1.value
            hashes[2 * i + 1] = h2.value
        blob = pack_keys([k for k, _ in blocks])
        verdicts = ct.create_string_buffer(n)
        st = self._lib.ist_put_hash(
            self._h, blob, len(blob), n, page_bytes,
            hashes.ctypes.data_as(ct.POINTER(ct.c_uint64)), verdicts,
        )
        if st != OK:
            self._telemetry.bump("dedup_probe_errors")
            return blocks
        vb = verdicts.raw[:n]
        need = [blocks[i] for i in range(n) if vb[i] == 0]
        if len(need) < n:
            self._telemetry.bump("dedup_have_pages", n - len(need))
        return need

    def put_cache(self, cache, blocks, page_size):
        """Synchronous one-call put of (key, offset) pairs. In lease
        mode (``ClientConfig(use_lease=True)``, SHM path) the commit is
        deferred and batched: the data is visible to readers only after
        the next :meth:`sync` (or an internal watermark flush) — the
        same pipelined contract as :meth:`write_cache`. On a lease-mode
        error (e.g. OUT_OF_MEMORY mid-batch) a PREFIX of the batch may
        already be committed — like any watermark-flushed earlier
        batch; retrying the whole put is safe (committed keys dedup
        against identical content)."""
        self._check()
        tid = self._stamp_trace()
        t0 = time.perf_counter()
        try:
            return self._run_reconnecting(
                lambda: self._put_cache_once(cache, blocks, page_size),
                keys=[k for k, _ in blocks],
            )
        finally:
            self._record_op("put_cache", t0, tid)

    def _put_cache_once(self, cache, blocks, page_size):
        done = threading.Event()
        result = {}

        def cb(status):
            result["status"] = status
            done.set()

        self._put_async_native(cache, blocks, page_size, cb)
        if not done.wait(self.config.timeout_ms / 1000):
            raise InfiniStoreError(TIMEOUT_ERR, "put timed out")
        if result["status"] != OK:
            raise InfiniStoreError(result["status"], "put failed")
        return 0

    async def put_cache_async(self, cache, blocks, page_size):
        self._check()
        tid = self._stamp_trace()
        t0 = time.perf_counter()
        try:
            return await self._put_cache_async_inner(
                cache, blocks, page_size
            )
        finally:
            self._record_op("put_cache", t0, tid)

    async def _put_cache_async_inner(self, cache, blocks, page_size):
        if self.config.use_dedup and blocks:
            # Hash-first probe (blocking rpc) off the event loop; the
            # paths below then ship only the NEED subset, and
            # _put_async_native is told not to probe again.
            blocks = await asyncio.get_running_loop().run_in_executor(
                None, self._dedup_filter_blocks, cache, blocks, page_size
            )
            if not blocks:
                return 0
        if self.shm_connected and self.config.use_lease:
            # Lease fast path, same as the sync put_cache: the native
            # call blocks on carve+copy (and occasionally an OP_LEASE
            # rpc), so it runs off the event loop; the deferred commit
            # is barriered by sync_async like every pipelined write.
            arr = _as_src_array(cache)
            keys = [k for k, _ in blocks]
            handled = await asyncio.get_running_loop().run_in_executor(
                None, self._lease_put_native, arr, blocks,
                page_size * arr.itemsize, keys,
            )
            if handled:
                return 0
            # PARTIAL (lease path unfit): fall through to the legacy
            # allocate + one-sided write below.
        try_fabric = True
        if self._fabric_stream:
            # Cross-host fabric put: blocking native call (one frame,
            # commit included) — run it off the event loop. On PARTIAL
            # the legacy path below must NOT retry the fabric attempt
            # (it would repeat the lease churn synchronously ON the
            # loop).
            arr = _as_src_array(cache)
            keys = [k for k, _ in blocks]
            handled = await asyncio.get_running_loop().run_in_executor(
                None, self._fabric_put_native, arr, blocks,
                page_size * arr.itemsize, keys,
            )
            if handled:
                return 0
            try_fabric = False
        if self.shm_connected:
            # The SHM put needs a blocking allocate rpc first — run it off
            # the event loop, then the async one-sided write.
            keys = [k for k, _ in blocks]
            esize = _as_src_array(cache).itemsize
            remote_blocks = await self.allocate_async(keys, page_size * esize)
            offsets = [off for _, off in blocks]
            return await self.write_cache_async(
                cache, offsets, page_size, remote_blocks
            )
        loop = asyncio.get_running_loop()
        future = loop.create_future()

        def cb(status):
            loop.call_soon_threadsafe(_finish_future, future, status, "put")

        self._put_async_native(cache, blocks, page_size, cb,
                               try_fabric=try_fabric, try_dedup=False)
        return await future

    def local_gpu_write_cache(self, cache, blocks, page_size):
        """One-call write of (key, offset) pairs: allocate + write + the
        allocate-side dedup, mirroring the reference local path
        (lib.py:360-394 → server write_cache infinistore.cpp:702-804)."""
        self._check()
        return self.put_cache(cache, blocks, page_size)

    async def local_gpu_write_cache_async(self, cache, blocks, page_size):
        return await self.put_cache_async(cache, blocks, page_size)

    # ------------------------------------------------------------------
    # read
    # ------------------------------------------------------------------

    @staticmethod
    def _prep_read(cache, blocks, page_size):
        """Shared destination prep for the sync and async read paths:
        coerce to an array, bounds-check the element offsets, and build the
        packed key blob + per-block destination addresses."""
        arr = _as_dst_array(cache)
        esize = arr.itemsize
        page_bytes = page_size * esize
        byte_offs = (
            np.asarray([off for _, off in blocks], dtype=np.int64) * esize
        )
        if len(byte_offs) and (
            int(byte_offs.min()) < 0
            or int(byte_offs.max()) + page_bytes > arr.nbytes
        ):
            raise ValueError("offset out of tensor bounds")
        blob = pack_keys([k for k, _ in blocks])
        dst_np = np.uint64(arr.ctypes.data) + byte_offs.astype(np.uint64)
        return arr, page_bytes, blob, dst_np

    def _read_async_native(self, cache, blocks, page_size, cb):
        arr, page_bytes, blob, dst_np = self._prep_read(
            cache, blocks, page_size
        )
        n = len(dst_np)
        dst_arr = dst_np.ctypes.data_as(ct.POINTER(ct.c_void_p))
        ka = self._keep(cb, (arr, dst_np, blob))
        fn = (
            self._lib.ist_shm_read_async
            if self.shm_connected
            else self._lib.ist_read_async
        )
        st = fn(self._h, page_bytes, blob, len(blob), n, dst_arr, ka.c_cb, None)
        if st != OK:
            self._drop_keep(ka.kid)
            raise InfiniStoreError(st, "read submit failed")

    def read_cache(self, cache, blocks, page_size):
        """Read pages for (key, offset) pairs into ``cache`` (offsets in
        elements). Missing/uncommitted keys raise
        :class:`InfiniStoreKeyNotFound` (reference returns KEY_NOT_FOUND,
        infinistore.cpp:607)."""
        self._check()
        tid = self._stamp_trace()
        t0 = time.perf_counter()
        try:
            return self._run_reconnecting(
                lambda: self._read_cache_once(cache, blocks, page_size)
            )
        finally:
            self._record_op("read_cache", t0, tid)

    def _read_cache_once(self, cache, blocks, page_size):
        arr, page_bytes, blob, dst_np = self._prep_read(
            cache, blocks, page_size
        )
        # Blocking native call (GIL released): waits on a C cv instead of
        # bouncing a ctypes callback through Python and a threading.Event.
        # On a STREAM-path timeout the native layer tears the connection
        # down before returning, so no late payload can land in our
        # buffers. (SHM connections never need the teardown: bulk reads
        # copy on this thread with an abandoned PIN's lease released
        # natively, and small reads — which ride the socket for latency,
        # capi.cc hybrid dispatch — scatter into a callback-owned bounce
        # buffer.)
        # BUSY (429) is the server's read backpressure — this connection
        # has too many bytes queued/pinned — so retry with backoff until
        # the configured timeout instead of surfacing a hard error.
        st = self._retry_busy(
            lambda remaining_ms: self._lib.ist_read(
                self._h, page_bytes, blob, len(blob), len(dst_np),
                dst_np.ctypes.data_as(ct.POINTER(ct.c_void_p)),
                remaining_ms,
            )
        )
        if st == _native.BUSY:
            raise InfiniStoreError(st, "read rejected by backpressure")
        if st == TIMEOUT_ERR:
            raise InfiniStoreError(TIMEOUT_ERR, "read timed out")
        if st == KEY_NOT_FOUND:
            raise InfiniStoreKeyNotFound(st, "key not found")
        if st != OK:
            raise InfiniStoreError(st, "read failed")
        return 0

    async def read_cache_async(self, cache, blocks, page_size):
        self._check()
        tid = self._stamp_trace()
        t0 = time.perf_counter()
        try:
            return await self._read_cache_async_inner(
                cache, blocks, page_size
            )
        finally:
            self._record_op("read_cache", t0, tid)

    async def _read_cache_async_inner(self, cache, blocks, page_size):
        loop = asyncio.get_running_loop()
        # Deep pipelining is exactly how a healthy client can trip the
        # server's per-connection outq cap, so BUSY here is expected
        # steady-state behavior under load: back off and resubmit until
        # the timeout rather than failing the read. OUT_OF_MEMORY is the
        # read path's other retryable status (disk-tier promotion found
        # no free pool blocks right now — see _retry_busy).
        deadline = time.monotonic() + self.config.timeout_ms / 1000.0
        delay = 0.001
        cap = self._busy_retry_cap_s()  # same pacing as _retry_busy
        retryable = (_native.BUSY, _native.OUT_OF_MEMORY)
        while True:
            future = loop.create_future()

            def cb(status):
                loop.call_soon_threadsafe(
                    _finish_future, future, status, "read"
                )

            self._read_async_native(cache, blocks, page_size, cb)
            try:
                return await future
            except InfiniStoreError as e:
                if (e.status not in retryable
                        or time.monotonic() >= deadline):
                    raise
            self._telemetry.bump("busy_retries")
            await asyncio.sleep(delay * random.uniform(0.5, 1.0))
            delay = min(delay * 2, cap)

    # ------------------------------------------------------------------
    # control ops
    # ------------------------------------------------------------------

    def sync(self):
        """Barrier: wait until all async ops on this connection completed
        and are visible to every other connection (reference sync_rdma /
        sync_local; the visibility guarantee is stronger here — see
        native/src/server.h commit-race note). In lease mode this also
        flushes the pending deferred-commit batch first, so leased puts
        are committed and visible once sync returns."""
        with self.in_use():
            self._check()
            t0 = time.perf_counter()
            try:
                if self.config.use_lease:
                    self._telemetry.bump("lease_flushes")
                    self._lib.ist_lease_flush(self._h)
                st = self._lib.ist_sync(self._h, self.config.timeout_ms)
                if st != OK:
                    raise InfiniStoreError(st, "sync failed")
                self._raise_async_errors()
                return 0
            finally:
                self._record_op("sync", t0, self.last_trace_id)

    def _raise_async_errors(self):
        if self.config.use_lease:
            lerr = self._lib.ist_lease_take_error(self._h)
            if lerr:
                raise InfiniStoreError(
                    lerr, "deferred leased commit failed"
                )
        with self._async_errors_lock:
            errs, self._async_errors = self._async_errors, []
        if errs:
            raise InfiniStoreError(
                errs[0], f"{len(errs)} pipelined write(s) failed"
            )

    async def sync_async(self):
        """Native async barrier: completes when the connection's inflight
        count drains to zero, via callback onto the running loop (no
        executor hop)."""
        self._check()
        loop = asyncio.get_running_loop()
        if self.config.use_lease:
            self._telemetry.bump("lease_flushes")
            # Off-loop: the flush itself only enqueues the pending
            # commit batch, but it takes lease_mu_, which a concurrent
            # put_cache_async executor thread may hold across a whole
            # carve+copy (or a blocking OP_LEASE rpc) — waiting for
            # that on the event loop would freeze every coroutine.
            await loop.run_in_executor(
                None, self._lib.ist_lease_flush, self._h
            )
        future = loop.create_future()

        def cb(status):
            loop.call_soon_threadsafe(_finish_future, future, status, "sync")

        ka = self._keep(cb, ())
        st = self._lib.ist_sync_async(self._h, ka.c_cb, None)
        if st != OK:
            self._drop_keep(ka.kid)
            raise InfiniStoreError(st, "sync submit failed")
        try:
            await asyncio.wait_for(future, self.config.timeout_ms / 1000)
        except asyncio.TimeoutError:
            raise InfiniStoreError(TIMEOUT_ERR, "sync timed out") from None
        self._raise_async_errors()
        return 0

    def check_exist(self, key):
        self._check()

        def once():
            kb = key.encode()
            ret = self._lib.ist_check_exist(self._h, kb, len(kb))
            if ret < 0:
                raise InfiniStoreError(-ret, "check_exist failed")
            return ret == 1

        t0 = time.perf_counter()
        try:
            return self._run_reconnecting(once)
        finally:
            self._record_op("check_exist", t0, self.last_trace_id)

    def get_match_last_index(self, keys):
        """Longest cached prefix of the key list — THE prefix-cache-hit
        primitive for vLLM (reference infinistore.cpp:1092-1108). Raises
        if no key matches (reference lib.py:627-643)."""
        idx = self._match_last_index_raw(keys)
        if idx < 0:
            raise Exception("can't find a match")
        return idx

    def _match_last_index_raw(self, keys):
        """get_match_last_index returning -1 instead of raising when no
        key matches (the sharded client merges per-shard results and a
        miss on one shard is normal)."""
        self._check()

        def once():
            blob = pack_keys(keys)
            idx = ct.c_int32(-1)
            st = self._lib.ist_get_match_last_index(
                self._h, blob, len(blob), len(keys), ct.byref(idx)
            )
            if st != OK:
                raise InfiniStoreError(st, "get_match_last_index failed")
            return idx.value

        t0 = time.perf_counter()
        try:
            return self._run_reconnecting(once)
        finally:
            self._record_op("match", t0, self.last_trace_id)

    def register_mr(self, cache):
        """No-op for API compatibility (no MR registration on TCP/SHM)."""
        self._check()
        _as_src_array(cache)
        return 1

    def purge(self):
        self._check()
        count = ct.c_uint64(0)
        st = self._lib.ist_client_purge(self._h, ct.byref(count))
        if st != OK:
            raise InfiniStoreError(st, "purge failed")
        return count.value

    def delete_keys(self, keys):
        self._check()
        blob = pack_keys(keys)
        count = ct.c_uint64(0)
        t0 = time.perf_counter()
        try:
            st = self._lib.ist_delete_keys(
                self._h, blob, len(blob), len(keys), ct.byref(count)
            )
            if st != OK:
                raise InfiniStoreError(st, "delete failed")
            return count.value
        finally:
            self._record_op("delete", t0, self.last_trace_id)

    def stats(self):
        self._check()
        import json

        # Grow-on-truncation: the rpc returns the full JSON blob but
        # the C layer clips it to the caller's buffer (NUL-terminated),
        # so a value that exactly fills cap-1 bytes means truncation —
        # retry larger instead of handing json.loads a clipped blob as
        # workers x ops x histogram buckets grow.
        cap = 65536
        while True:
            buf = ct.create_string_buffer(cap)
            st = self._lib.ist_client_stats(self._h, buf, cap)
            if st != OK:
                raise InfiniStoreError(st, "stats failed")
            if len(buf.value) < cap - 1:
                return json.loads(buf.value.decode())
            cap *= 4

    # ------------------------------------------------------------------
    # zero-copy pool access (used by infinistore_tpu_torch.cuda)
    # ------------------------------------------------------------------

    def pool_view(self, pool_idx):
        """numpy uint8 view over a mapped SHM pool — lets cudaMemcpyAsync
        move bytes directly between the GPU and the server pool
        (the nv_peer_mem zero-copy analogue)."""
        self._check()
        if not self.shm_connected:
            raise Exception("pool_view requires the SHM path")
        size = ct.c_uint64(0)
        base = self._lib.ist_pool_base(self._h, pool_idx, ct.byref(size))
        if not base:
            raise IndexError(f"no pool {pool_idx}")
        buf = (ct.c_ubyte * size.value).from_address(base)
        return np.frombuffer(buf, dtype=np.uint8)

    def pin(self, keys):
        """Pin committed blocks; returns (lease_id, RemoteBlock array).
        BUSY (this connection holds too many pinned bytes) is retried
        with backoff until the configured timeout."""
        self._check()
        blob = pack_keys(keys)
        out = np.zeros(len(keys), dtype=REMOTE_BLOCK_DTYPE)
        lease = ct.c_uint64(0)
        t0 = time.perf_counter()
        try:
            st = self._retry_busy(
                lambda _remaining_ms: self._lib.ist_pin(
                    self._h, blob, len(blob), len(keys),
                    out.ctypes.data_as(ct.c_void_p), ct.byref(lease),
                )
            )
            if st == KEY_NOT_FOUND:
                raise InfiniStoreKeyNotFound(st, "pin: key not found")
            if st != OK:
                raise InfiniStoreError(st, "pin failed")
            return lease.value, out
        finally:
            self._record_op("pin", t0, self.last_trace_id)

    def release(self, lease_id):
        self._check()
        st = self._lib.ist_release(self._h, lease_id)
        if st != OK:
            raise InfiniStoreError(st, "release failed")

    def prefetch(self, keys, wait=False):
        """Kick server-side disk→pool promotion for ``keys``
        (OP_PREFETCH, the async read pipeline): by the time the pages
        are actually read they are pool-resident, and the reading
        worker never pays the tier IO. Advisory and fire-and-forget by
        default — returns ``None`` immediately; the server replies
        per-key but nothing waits on the promotion itself. With
        ``wait=True`` the (immediate) reply is collected and a
        ``{"resident", "queued", "missing", "skipped"}`` count dict
        returned — "skipped" keys are disk-resident but were not
        queued (pool at the reclaim watermark, or the server runs with
        promote disabled); reads still serve them straight from disk.
        A no-op (returns ``None``) when ``ClientConfig.prefetch`` is
        False."""
        self._check()
        if not self.config.prefetch or not keys:
            return None
        tid = self._stamp_trace()
        t0 = time.perf_counter()
        try:
            return self._prefetch_once(keys, wait)
        finally:
            self._record_op("prefetch", t0, tid)

    def _prefetch_once(self, keys, wait):
        blob = pack_keys(keys)
        if not wait:
            self._lib.ist_prefetch(
                self._h, blob, len(blob), len(keys), None, 0
            )
            return None
        counts = (ct.c_uint64 * 4)()
        st = self._lib.ist_prefetch(
            self._h, blob, len(blob), len(keys), counts, 1
        )
        if st != OK:
            raise InfiniStoreError(st, "prefetch failed")
        return {
            "resident": int(counts[0]),
            "queued": int(counts[1]),
            "missing": int(counts[2]),
            "skipped": int(counts[3]),
        }

    def commit(self, tokens):
        """Commit tokens after writing pool memory directly (zero-copy
        path). FAKE tokens are filtered natively."""
        self._check()
        toks = np.ascontiguousarray(tokens, dtype=np.uint64)
        st = self._lib.ist_commit(
            self._h,
            toks.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            len(toks),
        )
        if st != OK:
            raise InfiniStoreError(st, "commit failed")

    def abort(self, tokens):
        """Abort uncommitted allocation tokens so their keys become
        allocatable again (used to undo partially-failed batch allocates;
        the reference has no such undo and leaks uncommitted entries)."""
        with self.in_use():
            self._check()
            toks = np.ascontiguousarray(tokens, dtype=np.uint64)
            st = self._lib.ist_abort(
                self._h,
                toks.ctypes.data_as(ct.POINTER(ct.c_uint64)),
                len(toks),
            )
        if st != OK:
            raise InfiniStoreError(st, "abort failed")

    def refresh_pools(self):
        self._check()
        return self._lib.ist_refresh_pools(self._h)

    # ------------------------------------------------------------------
    # keepalive plumbing for async callbacks
    # ------------------------------------------------------------------

    class _Keep:
        __slots__ = ("c_cb", "bufs", "kid")

    def _keep(self, py_cb, bufs):
        ka = InfinityConnection._Keep()
        with self._keepalive_lock:
            self._keepalive_id += 1
            kid = self._keepalive_id
        ka.kid = kid
        ka.bufs = bufs

        def trampoline(status, _ud):
            try:
                py_cb(status)
            finally:
                self._drop_keep(kid)

        ka.c_cb = _native.CALLBACK(trampoline)
        with self._keepalive_lock:
            self._keepalive[kid] = ka
        return ka

    def _drop_keep(self, kid):
        with self._keepalive_lock:
            self._keepalive.pop(kid, None)


def _finish_future(future, status, what):
    if future.cancelled():
        return
    if status == OK:
        future.set_result(0)
    elif status == KEY_NOT_FOUND:
        future.set_exception(InfiniStoreKeyNotFound(status, f"{what} failed"))
    else:
        future.set_exception(InfiniStoreError(status, f"{what} failed"))

"""Configuration classes for infinistore-tpu.

Parity target: the reference's plain config structs mirrored through pybind
into kwargs-based Python classes with ``verify()`` validation
(reference infinistore/lib.py:21-128, src/config.h:13-32). The
RDMA-specific knobs (dev_name, ib_port, link_type) have no TPU-host
equivalent and are replaced by the transport knobs of the two TPU-native
paths: SHM (same-host shared memory, the CUDA-IPC analogue) and STREAM
(TCP/DCN, the RDMA analogue).
"""

import os

# Connection types (reference: TYPE_LOCAL_GPU / TYPE_RDMA, lib.py:13-15).
TYPE_SHM = "SHM"        # same-host one-sided shared-memory path
TYPE_STREAM = "STREAM"  # cross-host DCN/TCP streamed path
TYPE_AUTO = "AUTO"      # probe SHM, fall back to STREAM

_LOG_LEVELS = ("error", "debug", "info", "warning")


class ClientConfig:
    """Client-side connection configuration.

    Attributes:
        host_addr (str): server address.
        service_port (int): server data-plane port.
        connection_type (str): TYPE_SHM, TYPE_STREAM or TYPE_AUTO.
        window_bytes (int): flow-control cap on outstanding streamed-write
            payload (the analogue of the reference's MAX_RDMA_WRITE_WR=4096
            outstanding-WR budget, src/protocol.h:23-34).
        timeout_ms (int): sync/rpc timeout (reference: 10 s sync timeout,
            src/libinfinistore.cpp:276).
        log_level (str): error|warning|info|debug; the
            INFINISTORE_LOG_LEVEL env var overrides (reference lib.py:45-48).
    """

    def __init__(self, **kwargs):
        self.host_addr = kwargs.get("host_addr", "127.0.0.1")
        self.service_port = kwargs.get("service_port", 22345)
        self.connection_type = kwargs.get("connection_type", TYPE_AUTO)
        self.window_bytes = kwargs.get("window_bytes", 64 << 20)
        self.timeout_ms = kwargs.get("timeout_ms", 10000)
        # Reconnect once and retry key-addressed ops after a
        # connection-level failure (timeout teardown / broken socket).
        # Beyond reference parity: the reference has no client reconnect.
        self.auto_reconnect = kwargs.get("auto_reconnect", False)
        # Retry pacing. Base delay in ms for BOTH
        # client-side retry loops: (a) the auto_reconnect retry sleeps
        # a jittered, per-streak-doubled delay (bounded at 2 s) between
        # the reconnect and the replay — a fleet of clients hammering a
        # restarting server in lockstep is exactly the thundering herd
        # jitter exists to break; (b) the BUSY/OOM backoff loop
        # (server backpressure, OP_PIN-on-disk-key promotion retries)
        # uses it as its max per-attempt delay. 0 disables the
        # reconnect-side sleep and keeps the historical 50 ms busy cap.
        self.retry_backoff_ms = kwargs.get("retry_backoff_ms", 50)
        # Lease mode (SHM path only): put_cache carves destinations out
        # of a server-granted block lease with zero round trips, commits
        # ride one batched deferred OP_COMMIT_BATCH (flushed by sync(),
        # the flush_size watermark or lease pressure), and reads of
        # known locations skip the OP_PIN round trip via an
        # epoch-validated pin cache. The SHM analogue of the reference's
        # client-side MR cache. Off by default: leased put_cache is
        # pipelined (visible after sync()), not synchronous.
        self.use_lease = kwargs.get("use_lease", False)
        # One-sided fabric plane (requires use_lease; docs/design.md
        # "One-sided fabric engine"). Same host against an
        # engine=fabric server: deferred commit records post into a
        # per-connection shared-memory doorbell ring instead of TCP
        # frames, so leased puts touch the socket only for a rare kick
        # and the tiny responses. Cross host: puts ride one
        # OP_FABRIC_WRITE frame per batch, scattered server-side
        # straight into lease-carved blocks (commit included — no
        # allocate round trip). Servers/engines without fabric degrade
        # silently to the existing paths.
        self.use_fabric = kwargs.get("use_fabric", False)
        # Content-addressed dedup (docs/design.md "Content-addressed
        # dedup"): put_cache becomes TWO-PHASE — first OP_PUT_HASH
        # ships each page's 128-bit content hash (computed natively
        # with the wire-stable ist_content_hash), then only the pages
        # the server answered NEED for ride the normal payload path.
        # Pages the server already holds bytes for commit with ZERO
        # payload transfer and zero pool growth (refcounted block
        # sharing). Off by default: the probe costs one RTT per batch,
        # which only pays for itself on workloads with cross-key
        # duplication (multi-tenant shared prefixes).
        self.use_dedup = kwargs.get("use_dedup", False)
        # Pool blocks per OP_LEASE acquire (one RTT buys this many
        # future allocations) and the deferred-commit flush watermark.
        self.lease_blocks = kwargs.get("lease_blocks", 4096)
        self.flush_size = kwargs.get("flush_size", 16 << 20)  # bytes
        # Engine-issued prefetch (OP_PREFETCH, the async read
        # pipeline): when True (default), consumers that know future
        # reads — the serving engine's admission prefix probe — may
        # fire InfinityConnection.prefetch() so disk-resident pages are
        # pool-resident before the restore asks for them. False makes
        # prefetch() a no-op (the explicit opt-out for workloads whose
        # probes do NOT predict reads; the server-side pipeline itself
        # is governed by ServerConfig.promote).
        self.prefetch = kwargs.get("prefetch", True)
        # Request tracing: when True, each logical op (put_cache /
        # read_cache / allocate batch) stamps a fresh 8-byte trace id
        # onto its wire frames, so the server's span rings (/trace,
        # server-side --trace required) stitch one client call across
        # lease commits, sharded sub-calls and server-side sub-spans.
        # Off by default: one extra ctypes call per op when on, zero
        # cost when off. Old servers ignore the flagged frames.
        self.trace = kwargs.get("trace", False)
        if "INFINISTORE_LOG_LEVEL" in os.environ:
            self.log_level = os.environ["INFINISTORE_LOG_LEVEL"].lower()
        else:
            self.log_level = kwargs.get("log_level", "warning")

    def __repr__(self):
        return (
            f"ClientConfig(host_addr='{self.host_addr}', "
            f"service_port={self.service_port}, "
            f"connection_type='{self.connection_type}', "
            f"window_bytes={self.window_bytes}, "
            f"timeout_ms={self.timeout_ms}, log_level='{self.log_level}')"
        )

    def verify(self):
        if self.connection_type not in (TYPE_SHM, TYPE_STREAM, TYPE_AUTO):
            raise Exception("Invalid connection type")
        if not self.host_addr:
            raise Exception("Host address is empty")
        if not self.service_port:
            raise Exception("Service port is 0")
        if self.log_level not in _LOG_LEVELS:
            raise Exception("log level should be error, debug, info or warning")
        if self.window_bytes <= 0:
            raise Exception("window_bytes must be positive")
        if self.lease_blocks <= 0:
            raise Exception("lease_blocks must be positive")
        if self.flush_size <= 0:
            raise Exception("flush_size must be positive")
        if self.retry_backoff_ms < 0:
            raise Exception("retry_backoff_ms must be >= 0")
        if self.use_fabric and not self.use_lease:
            # The fabric plane carves every destination out of a block
            # lease; without one there is nothing to negotiate and the
            # flag would be a silent no-op.
            raise Exception("use_fabric requires use_lease")


class ServerConfig:
    """Server configuration.

    Attributes mirror the reference (lib.py:94-128): ``prealloc_size`` in
    GB, ``minimal_allocate_size`` in KB (the pool block granularity),
    ``auto_increase`` growth (reference grows 10 GB per extension,
    src/mempool.h:14-15 — here ``extend_size`` GB, default 1).
    """

    def __init__(self, **kwargs):
        self.host = kwargs.get("host", "0.0.0.0")
        self.service_port = kwargs.get("service_port", 22345)
        self.manage_port = kwargs.get("manage_port", 18080)
        self.log_level = kwargs.get("log_level", "warning")
        self.prealloc_size = kwargs.get("prealloc_size", 16)  # GB
        self.minimal_allocate_size = kwargs.get("minimal_allocate_size", 64)  # KB
        self.auto_increase = kwargs.get("auto_increase", False)
        self.extend_size = kwargs.get("extend_size", 1)  # GB per extension
        self.enable_shm = kwargs.get("enable_shm", True)
        self.shm_prefix = kwargs.get("shm_prefix", "")
        # LRU-evict cold committed entries instead of returning OOM
        # (beyond reference parity; off by default to match reference
        # first-writer-wins-forever semantics).
        self.enable_eviction = kwargs.get("enable_eviction", False)
        # Disk spill tier (the reference's aspirational SSD tier,
        # design.rst:36 — no code exists there). ssd_size in GB; 0 = off.
        # Cold entries spill to a file under ssd_path on pool pressure
        # and promote back on read. Without enable_eviction this is
        # spill-only: committed entries are never dropped. ssd_path must
        # be set explicitly (no default: /tmp is tmpfs on many distros,
        # which would silently spill into the RAM the tier exists to
        # relieve; the native layer also warns when the target is tmpfs).
        self.ssd_path = kwargs.get("ssd_path", "")
        self.ssd_size = kwargs.get("ssd_size", 0)  # GB
        # Server-side read backpressure: per-connection cap (MB) on bytes
        # queued for send (and hence pool blocks pinned) to a slow reader.
        # Reads past the cap fail with BUSY (retryable). The analogue of
        # the reference's bounded push window (signal/32, window 4096 WRs,
        # src/libinfinistore.cpp:898-987), denominated in bytes.
        self.max_outq_size = kwargs.get("max_outq_size", 64)  # MB
        # Data-plane worker loops (deviation from the reference's single
        # uvloop — see docs/design.md "Threading model"). 1 (default)
        # keeps the historical single-epoll behavior, byte-compatible
        # with every existing client and the right choice for
        # control-plane-only deployments. 0 = auto-size to
        # min(4, cores - 2). The ISTPU_SERVER_WORKERS env var overrides
        # either setting at server start.
        self.workers = kwargs.get("workers", 1)
        # Background reclaim watermarks (fractions of pool bytes; see
        # docs/design.md "Reclaim pipeline"). With eviction and/or the
        # disk tier enabled, a reclaimer thread wakes when occupancy
        # crosses reclaim_high and evicts/spills down to reclaim_low in
        # batches off the hot path; puts then normally find free blocks
        # without paying reclaim inline (the inline path survives as the
        # counted last resort — the "hard_stalls" stat). reclaim_high
        # >= 1.0 (or <= 0) disables the background reclaimer and keeps
        # the historical inline-only behavior.
        self.reclaim_high = kwargs.get("reclaim_high", 0.95)
        self.reclaim_low = kwargs.get("reclaim_low", 0.85)
        # Async read pipeline (--no-promote / ISTPU_PROMOTE=0 to
        # disable): with the disk tier and the background reclaimer
        # active, gets serve disk-resident keys straight from their
        # extents (first touch) and disk→pool promotion runs on a
        # dedicated worker thread — promote-on-second-touch, with
        # OP_PREFETCH/OP_PIN queueing immediately and admission bounded
        # by reclaim_high so promotion never fights the reclaimer.
        # False = the historical inline promotion on the reading
        # worker, under the stripe lock.
        self.promote = kwargs.get("promote", True)
        # Request tracing (--trace / ISTPU_TRACE=1 env override): native
        # per-worker span rings recording each op's lifecycle (parse,
        # stripe-lock wait, copy, disk IO, commit) plus reclaim/spill
        # tracks; drained as Perfetto-loadable Chrome trace JSON via
        # GET /trace. Compiled in but off by default — the rings record
        # nothing and allocate nothing when disabled.
        self.trace = kwargs.get("trace", False)
        # Transport engine for the worker IO loops (--engine /
        # ISTPU_ENGINE env override; docs/design.md "Transport
        # engine"): "epoll" = the portable readiness loop (historical
        # behavior), "uring" = io_uring completion loop — pool arenas
        # registered as fixed kernel buffers, zero-copy sends for
        # OP_READ responses, multishot recv for header traffic,
        # optional SQPOLL — failing loudly at start() on kernels
        # without io_uring; "fabric" = the one-sided data plane
        # (docs/design.md "One-sided fabric engine") — epoll control
        # loop plus per-connection shared-memory commit rings so a
        # leased same-host client's put path never touches the socket
        # (falls back to the auto selection LOUDLY when POSIX shm is
        # unavailable); "auto" (default) probes at startup and falls
        # back to epoll with one log line (the stats blob's "engine"
        # key reports what was selected).
        self.engine = kwargs.get("engine", "auto")
        # Anomaly watchdog + diagnostic bundles (docs/design.md "Flight
        # recorder & watchdog"; ISTPU_WATCHDOG=0/1 overrides). A native
        # thread samples worker/background heartbeats, queue gauges and
        # per-op latency histogram deltas each watchdog_interval_ms; a
        # verdict — stalled worker, p99-deadline violation, queue
        # growth without drain — emits a watchdog.* flight-recorder
        # event and, with bundle_dir set, captures a diagnostic bundle
        # (stats + events + trace + deep state + manifest) into a
        # keep-last-bundle_keep directory. bundle_dir also pre-opens
        # the crash fd the fatal-signal handler dumps the raw event
        # rings to (ISTPU_BUNDLE_DIR supplies a DEFAULT when unset — CI
        # points every test server at one dir and ships it as a
        # failure artifact; an explicit bundle_dir always wins). Thresholds ride
        # ISTPU_WATCHDOG_{INTERVAL_MS,STALL_US,P99_US,COOLDOWN_MS}.
        self.watchdog = kwargs.get("watchdog", True)
        self.bundle_dir = kwargs.get("bundle_dir", "")
        self.bundle_keep = kwargs.get("bundle_keep", 4)
        # Cluster tier (docs/design.md "Cluster tier"): this server's
        # shard identity in the replicated shard directory. -1 (the
        # default) = not a cluster member — GET /directory still
        # answers (epoch 0, no map) and every cluster endpoint stays
        # inert until a directory naming this shard is pushed. The id
        # itself is assigned by the operator/coordinator; it only has
        # to be unique within one directory.
        self.shard_id = kwargs.get("shard_id", -1)
        # Accepted for reference CLI compatibility; unused on TPU hosts.
        self.dev_name = kwargs.get("dev_name", "")
        self.link_type = kwargs.get("link_type", "")

    def __repr__(self):
        return (
            f"ServerConfig(host='{self.host}', "
            f"service_port={self.service_port}, manage_port={self.manage_port}, "
            f"log_level='{self.log_level}', prealloc_size={self.prealloc_size}, "
            f"minimal_allocate_size={self.minimal_allocate_size}, "
            f"auto_increase={self.auto_increase}, enable_shm={self.enable_shm})"
        )

    def verify(self):
        # service_port 0 = bind an ephemeral port (test-friendly; the bound
        # port is returned by InfiniStoreServer.start()).
        if self.service_port is None or self.service_port < 0:
            raise Exception("Service port invalid")
        # manage_port 0 = bind an ephemeral manage port (like
        # service_port 0) — multi-shard harnesses discover it through
        # --port-file; negative/None is still a config error.
        if self.manage_port is None or self.manage_port < 0:
            raise Exception("Manage port invalid")
        if self.log_level not in _LOG_LEVELS:
            raise Exception("log level should be error, debug, info or warning")
        # The reference floors block granularity at 16 KB (lib.py:127);
        # we allow down to 4 KB: vLLM-style content-addressed KV pages
        # are commonly 4 KB, and matching the block size to the page size
        # removes 4x pool waste AND makes batch allocations contiguous —
        # contiguous pages merge into single iovec runs (STREAM) and a
        # single zero-copy pool view (SHM/TPU restore). The bitmap
        # allocator is O(1) amortized per block either way.
        if self.minimal_allocate_size < 4:
            raise Exception("minimal allocate size should be at least 4 (KB)")
        if self.minimal_allocate_size & (self.minimal_allocate_size - 1):
            raise Exception("minimal allocate size must be a power of two (KB)")
        if self.prealloc_size <= 0:
            raise Exception("prealloc_size must be positive")
        if self.ssd_size < 0:
            raise Exception("ssd_size must be >= 0")
        if self.ssd_size > 0 and not self.ssd_path:
            raise Exception("ssd_path required when ssd_size > 0")
        if self.max_outq_size <= 0:
            raise Exception("max_outq_size must be positive (MB)")
        if self.workers < 0 or self.workers > 64:
            raise Exception("workers must be in [0, 64] (0 = auto)")
        if self.engine not in ("auto", "epoll", "uring", "fabric"):
            raise Exception("engine must be auto, epoll, uring or fabric")
        if self.bundle_keep < 1:
            raise Exception("bundle_keep must be >= 1")
        if 0.0 < self.reclaim_high < 1.0:
            if not (0.0 <= self.reclaim_low <= self.reclaim_high):
                raise Exception(
                    "reclaim_low must be in [0, reclaim_high]"
                )

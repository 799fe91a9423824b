"""Sharded multi-server store client (PyTorch port copy; beyond reference
parity).

BASELINE.json config 5 calls for "multi-server sharded store over DCN" —
Llama-70B-scale KV working sets exceed one host's DRAM. The reference is
strictly single-server; scale-out is this framework's extension
(SURVEY.md §7 step 7), done entirely client-side so the server stays the
simple single-pool process: keys are routed to shards by stable hash, and
every data-path call fans out per-shard with one connection each.

Concurrency: per-shard work runs CONCURRENTLY on a persistent thread pool
(one worker per shard). The native calls release the GIL (ctypes) and
block on socket RTTs, so N-shard batch ops cost ~one shard's latency, not
N of them. An asyncio surface (``*_async``) rides the same pool plus the
per-connection async APIs.

Semantics preserved across shards:
- allocate/write/read/sync: partitioned per shard; sync barriers all.
- check_exist: routed to the owning shard.
- get_match_last_index: ONE rpc per shard in parallel — each shard runs
  its server-side prefix search (infinistore.cpp:1092-1108) over the
  subsequence of keys it owns, and the client merges by taking the
  earliest global hole. Exact same result as probing, at ~1 RTT total
  instead of log2(n) sequential round trips.
- first-writer-wins dedup: per key, inherited from the owning shard.

Shard-failure degrade (the reference has no failover
of any kind — libinfinistore.cpp tears the whole client down): with
``degrade_on_failure=True`` (default) a connection-class failure on one
shard marks THAT shard down instead of failing the whole batched op, a
background thread keeps redialing it, and until it recovers its keys
behave as a CACHE would behave — absent:

- allocate: the dead shard's keys come back as inert blocks
  (``token == FAKE_TOKEN``, status 0) that every write path already
  skips silently (the first-writer-wins sentinel machinery).
- write/put: the dead shard's partition is dropped — an at-most-once
  cache write, exactly like the serving engine's store-less downgrade.
  Keys holding a real allocation count into
  ``health['lost_write_keys']``; keys whose allocate already degraded
  (inert FAKE_TOKEN blocks) were counted in ``skipped_alloc_keys`` and
  are not double-booked.
- read: healthy shards complete, then the call raises
  InfiniStoreKeyNotFound for the unreachable keys — the same exception
  an evicted key raises, so cache-style callers (CudaKVStore restore,
  the serving engine) treat it as a routine miss.
- check_exist → False; get_match_last_index: the dead shard's first
  owned key becomes the prefix hole (prefix reuse shrinks, never lies).
- sync: barriers the healthy shards only.

Consistency contract: the store is a CACHE — degrade trades durability
for availability. Writes routed to a down shard are lost (readers see
key-absent, never stale or partial bytes); keys on healthy shards are
unaffected; after the background reconnect succeeds the shard rejoins
empty-handed for the lost keys (they 404 until re-put). Callers that
need fail-stop semantics instead pass ``degrade_on_failure=False`` and
get the original throw-through behavior.

Cluster directory mode (docs/design.md "Cluster tier"): with
a ``directory`` (an epoch-numbered shard map from
``infinistore_tpu_torch.cluster``) — or the ``replication``/``vnodes``
shortcut, which synthesizes one over ``configs`` — routing moves from
``crc32 % n`` to the directory's virtual-node consistent-hash ring:

- **writes** (``put_cache`` / ``put_cache_async``) fan to every shard
  in the key's N-way replica set; a key counts LOST only when every
  targeted replica dropped it, so one shard death loses nothing that
  was committed while its replica peer lived. The low-level
  allocate/write_cache surface stays primary-routed (one block array
  cannot carry N replicas' tokens) — callers that need the replication
  guarantee use the fused puts. ``CudaKVStore`` (and so the serving
  engine over it) does not: like the JAX package's ``TpuKVStore``
  (``tpu.py:273-304``), it writes pages through ``allocate`` +
  ``write_cache``, so a page it puts lies on the key's primary shard
  only, whatever the replication.
- **reads** (``read_cache`` / ``check_exist`` / ``prefetch`` /
  ``get_match_last_index``) go to the LEAST-LOADED live replica and
  fail over along the replica set; the old degrade-to-absent answer
  is the last resort after every replica failed, not the first
  response — a dead replica keeps hot prefix chains servable.
- **epochs**: the client rides directory epochs the way the pin cache
  rides the ctl-page epoch. ``refresh_directory()`` adopts a newer
  map (adding connections for new shards); a read that misses every
  replica refreshes once and re-routes before answering absent, so a
  stale client observes a re-route or a miss — never silently reads
  a range that moved away ("WRONG_EPOCH, then the new map", the same
  contract the control plane's POST /directory gives stale pushers).
"""

import asyncio
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ._native import INTERNAL_ERROR, REMOTE_BLOCK_DTYPE, TIMEOUT_ERR
from .lib import InfinityConnection, InfiniStoreError, InfiniStoreKeyNotFound


def _shard_of(key, n):
    # Stable across processes/runs (Python's hash() is salted). crc32 over
    # blake2b: routing runs once per key per batched call, and the crypto
    # hash was ~40% of a 4096-key partition pass (3 ms vs 0.6 ms); crc32's
    # spread over content-hash keys is uniform (verified to <2% skew on
    # 40k uuids across 3 and 4 shards).
    return zlib.crc32(key.encode()) % n


def retry_has_untried(pairs, tried, replicas_of):
    """True while some pending key still has a replica its read ladder
    has not attempted (module-level for testability)."""
    return any(
        set(replicas_of(k)) - tried.get(k, set()) for k, _ in pairs
    )


class _ShardDown(Exception):
    """Internal marker: the shard was already known-down, no call made."""


def _is_conn_failure(exc):
    """Connection-class failures mark a shard down; definitive store
    answers (KEY_NOT_FOUND, OUT_OF_MEMORY, CONFLICT, BAD_REQUEST) and
    caller bugs (bad args) never do — a healthy server said no."""
    if isinstance(exc, _ShardDown):
        return True
    if isinstance(exc, InfiniStoreKeyNotFound):
        return False
    if isinstance(exc, InfiniStoreError):
        return exc.status in (TIMEOUT_ERR, INTERNAL_ERROR)
    if isinstance(exc, (ValueError, TypeError, KeyError, IndexError)):
        return False
    # "Not connected", socket errors, native-handle failures.
    return isinstance(exc, Exception)


class ShardedConnection:
    """Same call surface as InfinityConnection, fanned over N servers.

    ``configs``: list of ClientConfig, one per shard (order defines the
    shard map — all clients must use the same order).
    ``degrade_on_failure``: see the module docstring's contract.
    ``io_threads``: size of the client-side fan-out pool. The historical
    default pins ONE worker thread per shard, which cannot saturate a
    multi-worker server (native ``ServerConfig.workers > 1``): each
    shard's blocking reads serialize on a single client thread even
    though the server (and the SHM memcpys, which run on the CALLING
    thread) could take more. ``None`` = auto: one thread per shard,
    upgraded to ``2 x n_shards`` when a connected shard reports
    ``workers > 1`` in its stats AND the host has more cores than
    shards (widening on a core-starved box only oversubscribes the
    cores the servers need). With more threads than
    shards, batched blocking reads split each shard's partition into
    ``io_threads // n_shards`` concurrent sub-calls (the native
    connection is thread-safe; concurrent SHM reads parallelize the
    one-sided copies across client threads).
    """

    def __init__(self, configs, degrade_on_failure=True, io_threads=None,
                 recover_interval_s=0.5, directory=None,
                 directory_addrs=None, replication=None, vnodes=64):
        if not configs:
            raise ValueError("need at least one shard config")
        self.conns = [InfinityConnection(c) for c in configs]
        self.n = len(configs)
        self.io_threads = io_threads
        # Cluster directory mode (module docstring): an explicit
        # directory blob, or the replication/vnodes shortcut that
        # synthesizes one over `configs` (shard ids = config order).
        # Legacy static-hash routing (directory None, replication
        # None/1 default) is byte-identical to every prior release.
        self.directory = None
        self.directory_epoch = 0
        self.directory_addrs = list(directory_addrs or [])
        self.replication = 1
        # Miss-path refresh pacing (refresh_directory docstring).
        self.refresh_min_interval_s = 1.0
        self._last_refresh_t = -1e9
        # Serializes refresh_directory/apply_directory end to end
        # (RLock: refresh calls apply while holding it). Concurrent
        # miss-path refreshes from user threads would otherwise
        # double-install the same epoch — each dialing (and leaking)
        # its own connection for the same new shard.
        self._apply_lock = threading.RLock()
        self._ring = None
        self._sid_to_idx = {}
        self._dir_lock = threading.Lock()
        # Per-shard in-flight sub-call gauge (the read fan-out's
        # least-loaded replica choice). GIL-atomic int bumps — a
        # heuristic, not an invariant.
        self._load = [0] * self.n
        if directory is None and replication is not None:
            from .cluster import build_directory

            directory = build_directory(
                [{"id": i, "host": c.host_addr,
                  "service_port": c.service_port}
                 for i, c in enumerate(configs)],
                epoch=1, vnodes=vnodes, replication=replication,
            )
        if directory is not None:
            if len(directory["shards"]) != len(configs):
                raise ValueError(
                    "directory names "
                    f"{len(directory['shards'])} shards but "
                    f"{len(configs)} configs were given (order must "
                    "match shard-for-shard)")
            self._install_directory(directory)
        # Template for dialing shards a FUTURE directory epoch adds
        # (apply_directory): the first config's knobs with host/port
        # swapped in.
        self._config_template = configs[0]
        # Recovery prober cadence: base interval
        # between redial passes; a pass in which NO dead shard came
        # back doubles the wait up to 8x base (bounded backoff — a
        # long outage must not burn a core redialing), and any
        # successful rejoin resets it.
        self.recover_interval_s = max(float(recover_interval_s), 0.01)
        self._io = self.n  # resolved at connect()
        self.connected = False
        # CudaKVStore compatibility: the sharded surface always moves
        # bytes through read/write buffers (per-shard SHM is an
        # internal detail — a cross-shard zero-copy pool view cannot
        # exist), so accelerator-edge consumers take the staged path.
        self.shm_connected = False
        self.parallel = True
        self.degrade = degrade_on_failure
        self.degraded = [False] * self.n
        self.health = {
            "shard_failures": 0,      # down transitions observed
            "reconnects": 0,          # successful background redials
            "skipped_alloc_keys": 0,  # allocs answered with inert blocks
            "lost_write_keys": 0,     # writes dropped on a down shard
            "missed_read_keys": 0,    # reads 404'd for a down shard
            "failed_sync_shards": 0,  # barriers lost mid-flight: writes
            #                           accepted by a shard that died
            #                           before sync() — per-key counts
            #                           are unknowable once the shard
            #                           is unreachable
        }
        # Per-shard failure forensics (health["per_shard"]): which
        # shard keeps dying, and what its last failure looked like —
        # the aggregate counters above cannot distinguish one flapping
        # shard from N healthy ones each failing once.
        self.shard_health = [
            {"failures": 0, "reconnects": 0, "last_error": ""}
            for _ in range(self.n)
        ]
        # Directory-mode failover telemetry:
        # NOISY failover — every read served, but each one walking a
        # replica ladder first — is invisible in the health counters
        # above (nothing is lost) and in the per-conn native stats
        # (each sub-call looks like an ordinary read). These live on
        # the router, where the ladder runs; client_stats() exposes
        # them under "failover". GIL-atomic int bumps like _load.
        #   read_failovers    keys whose read left their first-choice
        #                     replica (per ladder pass; a key retried
        #                     twice counts twice — it is a RATE)
        #   refresh_on_miss   replica-exhausted misses that triggered
        #                     a directory refresh
        #   replica_reads     per-shard (conn-index-aligned) count of
        #                     read sub-calls ROUTED there — the
        #                     replica-read distribution; a dead shard's
        #                     share flowing to its peers is visible as
        #                     the distribution tilting
        self.failover_stats = {
            "read_failovers": 0,
            "refresh_on_miss": 0,
            "replica_reads": [0] * self.n,
        }
        self._health_lock = threading.Lock()
        self._reconnector = None
        # Wakes the prober out of its backoff sleep: close() must not
        # block behind an 8x-base wait (the join below would stall up
        # to recover_interval_s*8 on an uninterruptible time.sleep).
        self._recover_wake = threading.Event()
        self._pool = None
        # Request tracing: ONE id per logical sharded op, pinned onto
        # every shard connection so the per-shard sub-calls stitch to a
        # single track group in each server's /trace export. Enabled
        # when any shard's ClientConfig sets trace=True.
        self._trace = any(getattr(c, "trace", False) for c in configs)
        self._trace_base = int.from_bytes(os.urandom(8), "little")
        self._trace_ctr = 0
        self.last_trace_id = 0

    def connect(self):
        """Connect every shard. In degrade mode a shard that is down at
        STARTUP is marked degraded like a runtime death — the background
        redial picks it up when it returns — so a fleet restart is never
        hostage to one dead server (the same death
        one second after connect already degraded gracefully; refusing
        at boot was an operability cliff, not a safety property). If
        EVERY shard is unreachable the store can serve nothing and
        connect raises even in degrade mode. ``degrade_on_failure=False``
        keeps the strict fail-stop behavior."""
        if self.connected:
            # Guard BEFORE any teardown path: per-shard connect() raises
            # "Already connected", which degrade mode would misread as
            # every shard being down — and the failure cleanup would
            # then close a perfectly healthy store.
            raise RuntimeError("already connected")
        self._recover_wake.clear()  # re-arm the prober's backoff sleep
        self._pool = ThreadPoolExecutor(
            max_workers=self.n, thread_name_prefix="istpu-shard"
        )
        self.connected = True  # _reconnect_loop and _mark_dead key off it
        dead = []
        try:
            for s, c in enumerate(self.conns):
                try:
                    c.connect()
                except Exception as e:
                    if not (self.degrade and _is_conn_failure(e)):
                        raise
                    dead.append((s, e))
            if len(dead) == self.n:
                raise InfiniStoreError(
                    INTERNAL_ERROR, "all shards unreachable at startup"
                )
        except BaseException:
            self.connected = False
            for c in self.conns:
                if c.connected:
                    c.close()
            self._pool.shutdown(wait=True)
            self._pool = None
            raise
        for s, e in dead:
            self._mark_dead(s, e)
        # Resolve the fan-out pool size. Explicit io_threads wins; the
        # auto path asks the first healthy shard how many data-plane
        # workers its server runs (stats 'workers', native stats_json)
        # and doubles the per-shard thread budget when the server side
        # can actually absorb concurrent calls.
        io = self.io_threads
        if io is None:
            io = self.n
            # Only widen when the extra client threads have somewhere to
            # run: on a host with <= n_shards cores, 2x threads just
            # oversubscribe the cores the servers need (measured ~40%
            # sharded-agg LOSS at 8 threads on a 2-core box).
            if (os.cpu_count() or 1) > self.n:
                for s, c in enumerate(self.conns):
                    if self.degraded[s] or not c.connected:
                        continue
                    try:
                        if int(c.stats().get("workers", 1)) > 1:
                            io = 2 * self.n
                    except Exception:
                        pass
                    break
        io = max(1, int(io))
        if io != self.n:
            self._pool.shutdown(wait=True)
            self._pool = ThreadPoolExecutor(
                max_workers=io, thread_name_prefix="istpu-shard"
            )
        self._io = io
        # Parallel fan-out pays off when per-shard calls spend their time
        # WAITING (network RTTs to remote STREAM shards) or when there
        # are cores to run SHM memcpys side by side. All-SHM shards on a
        # single core are pure CPU work: threads only add GIL convoying
        # (measured ~2.5x slower than sequential on the 1-core CI host),
        # so the fan-out falls back to in-order calls there. Override via
        # this attribute if the heuristic misjudges a deployment.
        self.parallel = (os.cpu_count() or 1) > 1 or any(
            not c.shm_connected for c in self.conns
        )
        return 0

    def close(self):
        self.connected = False  # stops the reconnector loop
        self._recover_wake.set()  # ...and wakes it out of a backoff sleep
        # Join the reconnector BEFORE closing connections: a redial
        # in flight while close() destroys the native handles would be
        # a use-after-free (lib.py's handle-lifetime contract), and one
        # completing after close() would leak a live connection.
        rec = self._reconnector
        if rec is not None and rec.is_alive():
            rec.join(timeout=30)
        for c in self.conns:
            c.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def shard_of(self, key):
        """The shard index a key's writes route to first: the legacy
        static hash, or — directory mode — the key's primary replica
        on the ring."""
        return self._primary(key)

    # -- cluster directory plumbing ------------------------------------

    @classmethod
    def from_directory(cls, directory, config_template=None, **kw):
        """Build a sharded client FROM a directory blob (fetched via
        ``cluster.fetch_directory`` or built by the coordinator): one
        ClientConfig per directory shard, knobs copied from
        ``config_template`` with host/service_port swapped in.
        ``directory_addrs`` defaults to every shard's manage address
        so epoch refresh works out of the box."""
        import copy

        from .config import ClientConfig

        configs = []
        addrs = kw.pop("directory_addrs", None)
        if addrs is None:
            addrs = [
                f"{s.get('host', '127.0.0.1')}:{s['manage_port']}"
                for s in directory["shards"] if "manage_port" in s
            ]
        for s in directory["shards"]:
            c = (copy.copy(config_template) if config_template is not None
                 else ClientConfig())
            c.host_addr = s.get("host", "127.0.0.1")
            c.service_port = s["service_port"]
            configs.append(c)
        return cls(configs, directory=directory, directory_addrs=addrs,
                   **kw)

    def _install_directory(self, directory):
        """Adopt a directory blob: ring + id→conn-index map + epoch.
        Caller ensures conns[] already covers every shard id (order
        for the constructor, apply_directory for later epochs)."""
        from .cluster import directory_ring

        ring = directory_ring(directory)
        with self._dir_lock:
            self.directory = directory
            self.directory_epoch = directory["epoch"]
            self.replication = max(1, directory.get("replication", 1))
            self._sid_to_idx = {
                s["id"]: i for i, s in enumerate(directory["shards"])
            }
            self._ring = ring

    def apply_directory(self, directory):
        """Adopt a NEWER directory epoch at runtime: new shards get
        connections dialed from the config template (a dial failure
        degrades like any shard death — the prober keeps redialing);
        shards no longer in the map keep their connections open but
        stop receiving routes (their pool entries were evicted by the
        migration commit). Returns True when the epoch advanced."""
        with self._apply_lock:
            return self._apply_directory_locked(directory)

    def _apply_directory_locked(self, directory):
        if directory["epoch"] <= self.directory_epoch:
            return False
        import copy

        known = {s["id"] for s in (self.directory or {}).get("shards", [])}
        # Conn indices of surviving shards stay STABLE: the loop below
        # only EXTENDS conns/health arrays for unknown ids, never
        # reorders — health/forensics arrays are index-aligned.
        old_index = dict(self._sid_to_idx)
        for s in directory["shards"]:
            if s["id"] in known:
                continue
            c = copy.copy(self._config_template)
            c.host_addr = s.get("host", "127.0.0.1")
            c.service_port = s["service_port"]
            conn = InfinityConnection(c)
            self.conns.append(conn)
            self.degraded.append(False)
            self.shard_health.append(
                {"failures": 0, "reconnects": 0, "last_error": ""})
            self._load.append(0)
            self.failover_stats["replica_reads"].append(0)
            idx = len(self.conns) - 1
            old_index[s["id"]] = idx
            if self.connected:
                try:
                    conn.connect()
                except Exception as e:  # noqa: BLE001 — degrade ladder
                    if not (self.degrade and _is_conn_failure(e)):
                        raise
                    self._mark_dead(idx, e)
            if "manage_port" in s:
                addr = f"{s.get('host', '127.0.0.1')}:{s['manage_port']}"
                if addr not in self.directory_addrs:
                    self.directory_addrs.append(addr)
        from .cluster import directory_ring

        ring = directory_ring(directory)
        with self._dir_lock:
            self.directory = directory
            self.directory_epoch = directory["epoch"]
            self.replication = max(1, directory.get("replication", 1))
            self._sid_to_idx = {
                s["id"]: old_index[s["id"]] for s in directory["shards"]
            }
            self._ring = ring
            self.n = len(self.conns)
        return True

    def refresh_directory(self, force=False):
        """Poll the manage planes for a newer directory epoch (the
        ctl-page-epoch idiom at cluster scale); adopts and returns True
        when one shard answers with epoch > ours. Quietly False when no
        address answers — routing keeps the map it has.

        Rate-limited (``refresh_min_interval_s``, default 1 s) unless
        ``force``: the read ladder calls this on replica-exhausted
        misses, and an ordinary miss-heavy workload — where every miss
        is just a miss — must not turn each one into a blocking
        control-plane HTTP probe."""
        if not self.directory_addrs:
            return False
        from .cluster import fetch_directory

        with self._apply_lock:
            # Stamp + fetch + apply all under the lock: a second
            # thread blocked here re-checks the stamp and skips
            # instead of re-fetching the epoch the winner installed.
            now = time.monotonic()
            if not force and now - self._last_refresh_t < \
                    self.refresh_min_interval_s:
                return False
            self._last_refresh_t = now
            for addr in self.directory_addrs:
                try:
                    blob = fetch_directory(addr, timeout=5.0)
                except Exception:  # noqa: BLE001 — next address
                    continue
                d = blob.get("directory")
                if d and d.get("epoch", 0) > self.directory_epoch:
                    return self.apply_directory(d)
        return False

    def _primary(self, key):
        if self._ring is None:
            return _shard_of(key, self.n)
        return self._replicas(key)[0]

    def _replicas(self, key):
        """Conn indices of the key's replica set (ring order); length 1
        in legacy mode."""
        if self._ring is None:
            return [_shard_of(key, self.n)]
        with self._dir_lock:
            ring, m = self._ring, self._sid_to_idx
        return [m[sid] for sid in ring.replica_set(key) if sid in m]

    def _choose_read_shard(self, key, tried=()):
        """The read fan-out's replica choice: among the key's replicas
        not yet tried, prefer live (non-degraded) ones and the lowest
        in-flight load; fall back to a degraded one (it may have
        rejoined) only when no live candidate remains. None = every
        replica tried."""
        reps = [s for s in self._replicas(key) if s not in tried]
        if not reps:
            return None
        live = [s for s in reps
                if not (self.degrade and self.degraded[s])]
        pool = live or reps
        return min(pool, key=lambda s: (self._load[s], s))

    def set_trace_id(self, trace_id):
        """Pin ``trace_id`` onto every healthy shard connection (0
        clears and re-enables per-connection auto-stamping)."""
        self.last_trace_id = trace_id
        for s, c in enumerate(self.conns):
            if c.connected and not self.degraded[s]:
                try:
                    c.set_trace_id(trace_id)
                except Exception:
                    pass  # a dying shard must not fail the fan-out
        return trace_id

    def _stamp_trace(self):
        if not self._trace:
            return 0
        self._trace_ctr += 1
        tid = (self._trace_base + self._trace_ctr) & ((1 << 64) - 1)
        return self.set_trace_id(tid or 1)

    # -- failure handling ----------------------------------------------

    def _mark_dead(self, shard, exc=None):
        with self._health_lock:
            if exc is not None:
                # Recorded even for an already-degraded shard: the
                # newest failure string is the one worth reading.
                self.shard_health[shard]["last_error"] = repr(exc)[:200]
            if self.degraded[shard]:
                return
            self.degraded[shard] = True
            self.health["shard_failures"] += 1
            self.shard_health[shard]["failures"] += 1
            if self._reconnector is None or not self._reconnector.is_alive():
                self._reconnector = threading.Thread(
                    target=self._reconnect_loop, daemon=True,
                    name="istpu-shard-reconnect",
                )
                self._reconnector.start()

    def _reconnect_loop(self):
        """Background redial of down shards every ~recover_interval_s
        until all are back (or the client closes); a pass that recovers
        nothing doubles the wait, bounded at 8x base, and any rejoin
        resets it. On success the shard rejoins with its surviving
        keys; keys written while it was down are simply absent (the
        documented cache contract)."""
        delay = self.recover_interval_s
        while self.connected:
            dead = [i for i in range(self.n) if self.degraded[i]]
            if not dead:
                return
            recovered = False
            for i in dead:
                if not self.connected:
                    return
                try:
                    self.conns[i].reconnect()
                except Exception as e:
                    with self._health_lock:
                        self.shard_health[i]["last_error"] = repr(e)[:200]
                    continue
                recovered = True
                with self._health_lock:
                    self.degraded[i] = False
                    self.health["reconnects"] += 1
                    self.shard_health[i]["reconnects"] += 1
            # Sleep the CURRENT cadence, then adjust for the next pass:
            # the first retry after a failed pass waits 1x base (the
            # documented cadence), consecutive failures 2x, 4x, 8x.
            # Event.wait, not time.sleep: close() sets the event so
            # shutdown never blocks behind a backoff window.
            if recovered:
                delay = self.recover_interval_s
            if self._recover_wake.wait(delay):
                return
            if not recovered:
                delay = min(delay * 2, self.recover_interval_s * 8)

    # -- fan-out plumbing ----------------------------------------------

    def _run_shard_calls(self, calls, tolerate=()):
        """Run [(shard, fn, args)] concurrently on the shard pool;
        returns [(ok, value_or_exc)] in call order. Known-down shards
        are skipped up front; a connection-class failure marks its
        shard down (degrade mode) and comes back as (False, exc) for
        the caller to apply op semantics; anything else re-raises after
        every in-flight call has been collected (never orphan a native
        call). ``tolerate``: exception types additionally returned as
        (False, exc) WITHOUT marking the shard down or re-raising —
        the read ladder passes InfiniStoreKeyNotFound so a key absent
        on one replica (written while it was down, or moved by a
        migration) retries the next replica instead of failing the op."""
        out = [None] * len(calls)
        live = []
        for j, (s, fn, args) in enumerate(calls):
            if self.degrade and self.degraded[s]:
                out[j] = (False, _ShardDown(s))
            else:
                live.append((j, s, fn, args))
        # In-flight gauge around each sub-call: the least-loaded
        # replica choice reads it. GIL-atomic += on ints; the finally
        # keeps it balanced on every exception path.
        def run(s, fn, args):
            self._load[s] += 1
            try:
                return fn(*args)
            finally:
                self._load[s] -= 1

        if len(live) <= 1 or self._pool is None or not self.parallel:
            results = []
            for j, s, fn, args in live:
                try:
                    results.append((j, s, True, run(s, fn, args)))
                except BaseException as e:  # noqa: BLE001 — sorted below
                    results.append((j, s, False, e))
        else:
            futs = [
                (j, s, self._pool.submit(run, s, fn, args))
                for j, s, fn, args in live
            ]
            results = []
            for j, s, f in futs:
                try:
                    results.append((j, s, True, f.result()))
                except BaseException as e:  # noqa: BLE001 — sorted below
                    results.append((j, s, False, e))
        first_err = None
        for j, s, ok, v in results:
            if not ok:
                if self.degrade and _is_conn_failure(v):
                    self._mark_dead(s, v)
                elif tolerate and isinstance(v, tolerate):
                    pass  # caller applies replica-retry semantics
                elif first_err is None:
                    first_err = v
            out[j] = (ok, v)
        if first_err is not None:
            raise first_err
        return out

    def _fanout(self, calls):
        """Legacy all-shards helper for ops with identical semantics per
        shard ([(fn, args)] in shard order, results in call order);
        down shards contribute None."""
        tagged = [(s, fn, args) for s, (fn, args) in enumerate(calls)]
        return [
            v if ok else None for ok, v in self._run_shard_calls(tagged)
        ]

    async def _fanout_async(self, coros):
        return await asyncio.gather(*coros)

    # -- partitioned data path -----------------------------------------

    def _partition(self, keys):
        """→ per-shard (indices, keys) preserving input order per
        shard; routes by the primary replica in directory mode."""
        parts = {}
        for i, k in enumerate(keys):
            s = self._primary(k)
            if s not in parts:
                parts[s] = ([], [])
            parts[s][0].append(i)
            parts[s][1].append(k)
        return parts

    def _allocate_parts(self, parts, nkeys, page_size_in_bytes):
        out = np.zeros(nkeys, dtype=REMOTE_BLOCK_DTYPE)
        results = self._run_shard_calls(
            [(s, self.conns[s].allocate, (ks, page_size_in_bytes))
             for s, (_idxs, ks) in parts]
        )
        for (_s, (idxs, ks)), (ok, blocks) in zip(parts, results):
            if ok:
                out[np.asarray(idxs)] = blocks
            else:
                # Inert rows: token == FAKE_TOKEN (0) — every write path
                # skips them silently, so the put degrades to a no-op
                # for exactly the unreachable keys.
                with self._health_lock:
                    self.health["skipped_alloc_keys"] += len(ks)
        return out

    def _write_parts(self, cache, offsets, page_size, remote_blocks, parts):
        blocks = np.ascontiguousarray(remote_blocks, dtype=REMOTE_BLOCK_DTYPE)
        calls = []
        for shard, (idxs, _ks) in parts:
            sel = np.asarray(idxs)
            calls.append(
                (shard, self.conns[shard].write_cache,
                 (cache, [offsets[i] for i in idxs], page_size, blocks[sel]))
            )
        results = self._run_shard_calls(calls)
        from ._native import FAKE_TOKEN

        for (_s, (idxs, _ks)), (ok, v) in zip(parts, results):
            if ok:
                continue
            # lost_write_keys counts exactly the keys that had a REAL
            # allocation (token != FAKE_TOKEN) whose write was then
            # dropped — whether the shard died mid-call or was marked
            # down by an intervening op (_ShardDown). FAKE_TOKEN rows
            # carry nothing to lose: they are either dedup sentinels
            # (the bytes already exist under that key) or down-shard
            # inert blocks already counted in skipped_alloc_keys at
            # allocate time — counting those again would double-book
            # the same keys across the two counters (the token test
            # also keeps an allocate-then-marked-down write from
            # vanishing from every counter).
            sel = np.asarray(idxs)
            n_real = int(np.count_nonzero(blocks[sel]["token"] != FAKE_TOKEN))
            if n_real:
                with self._health_lock:
                    self.health["lost_write_keys"] += n_real

    def allocate(self, keys, page_size_in_bytes):
        """Batch allocate across shards (concurrent). Returns
        RemoteBlocks in input order; use with this class's write_cache
        (which re-partitions identically)."""
        return self._allocate_parts(
            list(self._partition(keys).items()), len(keys),
            page_size_in_bytes
        )

    def write_cache(self, cache, offsets, page_size, remote_blocks, keys):
        """Write pages to their owning shards (concurrent). ``keys`` must
        be the same list passed to allocate (defines the routing)."""
        self._write_parts(cache, offsets, page_size, remote_blocks,
                          list(self._partition(keys).items()))
        return 0

    def put(self, cache, blocks, page_size):
        """One-call sharded put of (key, offset) pairs (allocate + write).
        Partitions once for both halves."""
        keys = [k for k, _ in blocks]
        offsets = [o for _, o in blocks]
        esize = cache.itemsize if hasattr(cache, "itemsize") else 1
        parts = list(self._partition(keys).items())
        rb = self._allocate_parts(parts, len(keys), page_size * esize)
        self._write_parts(cache, offsets, page_size, rb, parts)
        return rb

    def put_cache(self, cache, blocks, page_size):
        """InfinityConnection-compatible name: sharded put + barrier.

        When a shard's ClientConfig enables ``use_lease``, that shard's
        partition rides its connection's zero-RTT leased put (each
        per-shard connection holds and REUSES its own block lease and
        pin cache across batches); the final sync() fans out and flushes
        every shard's deferred commit batch. Lease-less shards take the
        classic allocate+write path unchanged."""
        self._stamp_trace()
        if self._ring is not None and self.replication > 1:
            return self._put_cache_replicated(cache, blocks, page_size)
        if any(c.config.use_lease for c in self.conns):
            parts = {}
            for k, off in blocks:
                parts.setdefault(self._primary(k), []).append((k, off))
            parts = list(parts.items())
            results = self._run_shard_calls(
                [(s, self.conns[s].put_cache, (cache, pairs, page_size))
                 for s, pairs in parts]
            )
            # A down shard drops its whole partition into
            # lost_write_keys — the fused-put convention put_cache_async
            # already documents (allocate and write fuse inside the
            # per-shard call, so the sync path's skipped-alloc/
            # lost-write split does not apply here either).
            dropped = sum(
                len(pairs) for (_s, pairs), (ok, _v) in zip(parts, results)
                if not ok
            )
            if dropped:
                with self._health_lock:
                    self.health["lost_write_keys"] += dropped
            self.sync()
            return 0
        self.put(cache, blocks, page_size)
        self.sync()
        return 0

    def _replica_write_parts(self, blocks):
        """Partition (key, offset) pairs so every key lands on EVERY
        shard of its replica set — the N-way write fan."""
        parts = {}
        for k, off in blocks:
            for s in self._replicas(k):
                parts.setdefault(s, []).append((k, off))
        return list(parts.items())

    def _count_replica_losses(self, parts, ok_flags):
        """A key is LOST only when every replica that was supposed to
        hold it failed — one surviving copy keeps it readable through
        the fan-out ladder. Failed-but-survived keys are the replica
        repair debt the rejoining shard carries (absent there until
        re-put), which the health counters do not double-book."""
        acked, attempted = set(), set()
        for (s, pairs), ok in zip(parts, ok_flags):
            for k, _off in pairs:
                attempted.add(k)
                if ok:
                    acked.add(k)
        lost = len(attempted - acked)
        if lost:
            with self._health_lock:
                self.health["lost_write_keys"] += lost
        return lost

    def _put_cache_replicated(self, cache, blocks, page_size):
        """Directory-mode put: each key's batch rides every replica's
        per-shard put_cache (lease-mode shards keep their zero-RTT
        path — replication costs R× bytes, never a protocol change),
        then one sync barriers the fan. Committed = acked by every
        replica that was LIVE at put time; with R >= 2 a single shard
        death therefore never loses a committed key, the chaos
        acceptance tests/test_cluster.py pins."""
        parts = self._replica_write_parts(blocks)
        results = self._run_shard_calls(
            [(s, self.conns[s].put_cache, (cache, pairs, page_size))
             for s, pairs in parts]
        )
        self._count_replica_losses(parts, [ok for ok, _v in results])
        self.sync()
        return 0

    async def put_cache_async(self, cache, blocks, page_size):
        """Async sharded put: per-shard put_cache_async concurrently.
        Down shards drop their whole partition, counted entirely in
        ``lost_write_keys`` — allocate+write fuse inside the per-shard
        call here, so the sync path's skipped-alloc/lost-write split
        does not apply (no separate allocate ever ran for these keys).
        Directory mode fans each key to its whole replica set and
        counts a key lost only when EVERY replica dropped it (the
        same contract as the sync path)."""
        replicated = self._ring is not None and self.replication > 1
        if replicated:
            parts = dict(self._replica_write_parts(blocks))
        else:
            parts = {}
            for k, off in blocks:
                parts.setdefault(self._primary(k), []).append((k, off))
        live = {s: p for s, p in parts.items()
                if not (self.degrade and self.degraded[s])}
        results = await asyncio.gather(
            *[self.conns[s].put_cache_async(cache, pairs, page_size)
              for s, pairs in live.items()],
            return_exceptions=True,
        )
        ok_by_shard = {s: False for s in parts}
        for (s, pairs), r in zip(live.items(), results):
            if isinstance(r, BaseException):
                if self.degrade and _is_conn_failure(r):
                    self._mark_dead(s, r)
                else:
                    raise r
            else:
                ok_by_shard[s] = True
        if replicated:
            self._count_replica_losses(
                list(parts.items()),
                [ok_by_shard[s] for s in parts])
        else:
            dropped = sum(
                len(p) for s, p in parts.items() if not ok_by_shard[s])
            if dropped:
                with self._health_lock:
                    self.health["lost_write_keys"] += dropped
        return 0

    def reconnect(self):
        """Reconnect every shard (see InfinityConnection.reconnect),
        INCLUDING degraded ones (this is the manual redial — it must
        not skip them); clears degraded state on success."""
        for c in self.conns:
            c.reconnect()
        with self._health_lock:
            self.degraded = [False] * self.n
        return 0

    def _read_parts(self, blocks, tried=None):
        """Partition read pairs by target shard. Legacy: the static
        hash. Directory mode: the least-loaded live replica not yet in
        ``tried[key]`` (the failover ladder's chooser); pairs whose
        every replica has been tried land under the ``None`` bucket —
        exhausted, degrade-to-absent is all that is left for them."""
        parts = {}
        if self._ring is None:
            for k, off in blocks:
                parts.setdefault(_shard_of(k, self.n), []).append((k, off))
            return parts
        for k, off in blocks:
            s = self._choose_read_shard(
                k, tried.get(k, ()) if tried else ())
            parts.setdefault(s, []).append((k, off))
        return parts

    def _read_chunks(self, pairs):
        """Split one shard's read partition into up to io_threads//n
        concurrent sub-calls (identity when io_threads == n_shards, the
        historical one-thread-per-shard shape). Tiny partitions stay
        whole — a sub-call per page would pay rpc overhead for nothing."""
        per = self._io // self.n
        if per <= 1 or len(pairs) < 2 * per:
            return [pairs]
        size = (len(pairs) + per - 1) // per
        return [pairs[i:i + size] for i in range(0, len(pairs), size)]

    def _raise_missed(self, missed):
        with self._health_lock:
            self.health["missed_read_keys"] += len(missed)
        raise InfiniStoreKeyNotFound(
            404, "keys unavailable (shard down) or absent on every "
            f"replica: {missed[:4]}"
            + ("..." if len(missed) > 4 else "")
        )

    def _replica_read_call(self, conn, cache, chunk, page_size):
        """One replicated-read sub-call, with the cluster.replica_read
        chaos gate in front: an armed failpoint simulates the replica
        dying exactly at read time (the fan-out must fail over), which
        is how tests kill a replica mid-read deterministically."""
        from .cluster import eval_failpoint

        rc = eval_failpoint("cluster.replica_read")
        if rc:
            raise InfiniStoreError(
                INTERNAL_ERROR,
                f"injected replica read failure (errno {rc})")
        return conn.read_cache(cache, chunk, page_size)

    def _read_pass(self, cache, pairs, page_size, tried, isolate):
        """One fan-out attempt over ``pairs``: route each key to its
        chosen replica, run the sub-calls, record the attempt in
        ``tried`` and return the pairs that still need another replica
        (plus the pairs whose replica set is exhausted). ``isolate``
        accumulates keys from chunks that failed with a DEFINITIVE
        KeyNotFound: batch reads are all-or-nothing server-side, so
        one genuinely absent key fails its whole chunk — retrying
        those pairs as single-pair chunks confines the miss to the
        missing key instead of re-reading the chunk against every
        replica (the miss-amplification fix)."""
        parts = list(self._read_parts(pairs, tried=tried).items())
        exhausted = []
        calls, tags = [], []
        for s, chunk_pairs in parts:
            if s is None:
                exhausted.extend(chunk_pairs)
                continue
            # Replica-read distribution (failover telemetry): keys
            # ROUTED to this shard for this pass, counted where the
            # choice is made.
            self.failover_stats["replica_reads"][s] += len(chunk_pairs)
            for k, _ in chunk_pairs:
                tried.setdefault(k, set()).add(s)
            grouped = [p for p in chunk_pairs if p[0] not in isolate]
            chunks = self._read_chunks(grouped) if grouped else []
            chunks += [[p] for p in chunk_pairs if p[0] in isolate]
            for chunk in chunks:
                fn = (self.conns[s].read_cache if self._ring is None
                      else self._replica_read_call)
                args = ((cache, chunk, page_size) if self._ring is None
                        else (self.conns[s], cache, chunk, page_size))
                calls.append((s, fn, args))
                tags.append(chunk)
        results = self._run_shard_calls(
            calls,
            tolerate=(InfiniStoreKeyNotFound,)
            if self._ring is not None else (),
        )
        retry = []
        for chunk, (ok, v) in zip(tags, results):
            if ok:
                continue
            if isinstance(v, InfiniStoreKeyNotFound):
                isolate.update(k for k, _ in chunk)
            retry.extend(chunk)
        return retry, exhausted

    def read_cache(self, cache, blocks, page_size):
        """Read (key, offset) pairs from their owning shards
        (concurrent). Directory mode reads the least-loaded live
        replica and FAILS OVER along each key's replica set (a replica
        death mid-read retries the survivors; a key absent on one
        replica — written while that replica was down — is found on
        its peer). Only when every replica of a key has failed (and,
        with directory_addrs, a directory refresh brought no newer
        epoch to re-route under) does the call raise
        InfiniStoreKeyNotFound for the leftovers — the same
        degrade-to-absent the static-hash client answered FIRST, now
        demoted to the last resort. Healthy keys' pages land in
        ``cache`` regardless."""
        self._stamp_trace()
        tried = {}
        isolate = set()
        pending = list(blocks)
        missed = []
        refreshed = False
        # Budget: a full ladder over the CURRENT map, and — after the
        # one refresh — a full ladder over the new map too (the tried
        # reset restarts the replica walk; the refreshed flag bounds
        # the loop).
        max_passes = (1 if self._ring is None
                      else 2 * (max(self.replication, 1) + 1))
        for _ in range(max_passes):
            if not pending:
                break
            retry, exhausted = self._read_pass(
                cache, pending, page_size, tried, isolate)
            missed.extend(exhausted)
            pending = retry
            if retry:
                # Failover rate: keys whose read is leaving a failed
                # replica for the next one (counted per pass — a key
                # that walks two dead replicas counts twice).
                self.failover_stats["read_failovers"] += len(retry)
            if pending and not retry_has_untried(pending, tried,
                                                 self._replicas):
                # Every replica of every pending key has failed. The
                # pin-cache-epoch move: ONE directory refresh — a
                # migration may have re-homed the range — then one
                # more ladder under the new map.
                if not refreshed and self.directory_addrs:
                    # Counted per ATTEMPT (the control-plane probe is
                    # the cost worth watching), fired or rate-limited.
                    self.failover_stats["refresh_on_miss"] += 1
                    if self.refresh_directory():
                        refreshed = True
                        tried = {}
                        continue
                break
        missed.extend(pending)
        if missed:
            self._raise_missed([k for k, _ in missed])
        return 0

    async def read_cache_async(self, cache, blocks, page_size):
        """Async sharded read; same degrade contract as read_cache.
        Directory mode routes each key to its preferred live replica
        (one attempt — the async surface trades the failover ladder
        for latency; callers that need the ladder use the sync path)."""
        routed = self._read_parts(blocks)
        # Directory mode's None bucket: every replica degraded —
        # nothing to dial, straight to the miss answer.
        missed = [k for k, _ in routed.pop(None, [])]
        parts = list(routed.items())
        live = [(s, p) for s, p in parts
                if not (self.degrade and self.degraded[s])]
        missed += [k for s, p in parts
                   if self.degrade and self.degraded[s] for k, _ in p]
        results = await asyncio.gather(
            *[self.conns[s].read_cache_async(cache, pairs, page_size)
              for s, pairs in live],
            return_exceptions=True,
        )
        for (s, pairs), r in zip(live, results):
            if isinstance(r, BaseException):
                if self.degrade and _is_conn_failure(r):
                    self._mark_dead(s, r)
                    missed.extend(k for k, _ in pairs)
                else:
                    raise r
        if missed:
            self._raise_missed(missed)
        return 0

    def abort_for_keys(self, keys, blocks):
        """Abort uncommitted allocations by (key, token) pairs — tokens
        alone cannot route, so this is the sharded analogue of
        InfinityConnection.abort (CudaKVStore's write-failure rollback
        uses it; best-effort like the single-server path)."""
        from ._native import FAKE_TOKEN, OK as _OK

        parts = {}
        for k, b in zip(keys, blocks):
            if b["status"] == _OK and b["token"] != FAKE_TOKEN:
                # Route by the same shard allocate() used (ring primary
                # in directory mode): tokens are per-shard numbers, so
                # a mis-routed abort could cancel an UNRELATED in-flight
                # allocation that happens to hold the same token id.
                parts.setdefault(self._primary(k), []).append(
                    int(b["token"])
                )
        self._run_shard_calls(
            [(s, self.conns[s].abort,
              (np.asarray(toks, dtype=np.uint64),))
             for s, toks in parts.items()]
        )
        return 0

    def sync(self):
        """Barrier the healthy shards. A shard that dies BETWEEN
        accepting writes and this barrier takes those in-flight writes
        with it — counted as health['failed_sync_shards'] (per-key
        attribution is impossible once the shard is unreachable); a
        shard already known down was skipped at write time and counted
        in lost_write_keys. Waiting on a dead shard would turn degrade
        into hang, so the barrier covers exactly the reachable set."""
        results = self._run_shard_calls(
            [(s, c.sync, ()) for s, c in enumerate(self.conns)]
        )
        failed = sum(
            1 for ok, v in results
            if not ok and not isinstance(v, _ShardDown)
        )
        if failed:
            with self._health_lock:
                self.health["failed_sync_shards"] += failed
        return 0

    async def sync_async(self):
        # Snapshot (shard, conn) pairs BEFORE the await: the background
        # reconnector mutates self.degraded concurrently, and
        # recomputing the index list afterwards could pair a failure
        # with the wrong shard.
        live = [(s, c) for s, c in enumerate(self.conns)
                if not (self.degrade and self.degraded[s])]
        results = await asyncio.gather(
            *[c.sync_async() for _s, c in live], return_exceptions=True
        )
        for (s, _c), r in zip(live, results):
            if isinstance(r, BaseException):
                if self.degrade and _is_conn_failure(r):
                    self._mark_dead(s, r)
                else:
                    raise r
        return 0

    # -- control plane -------------------------------------------------

    def check_exist(self, key):
        """Routed to the owning shard; a down shard's keys are absent
        (False), matching the read contract. Directory mode walks the
        replica set (a key written while one replica was down exists
        only on its peers) before answering False."""
        tried = set()
        for _ in range(max(1, self.replication)):
            s = self._choose_read_shard(key, tried)
            if s is None:
                return False
            tried.add(s)
            [(ok, v)] = self._run_shard_calls(
                [(s, self.conns[s].check_exist, (key,))]
            )
            if ok and v:
                return v
            if ok and self._ring is None:
                return v  # definitive single-owner answer
        return False

    def _merge_match(self, keys, parts, shard_matches):
        """Merge per-shard prefix-search results into the global longest
        prefix: each shard reports the last present element of ITS
        subsequence; the element after it is that shard's earliest
        global hole, and the global answer is the earliest hole across
        shards, minus one."""
        first_hole = len(keys)
        for (_s, (idxs, _ks)), m in zip(parts, shard_matches):
            hole = idxs[m + 1] if m + 1 < len(idxs) else len(keys)
            first_hole = min(first_hole, hole)
        return first_hole - 1

    def get_match_last_index(self, keys):
        """Longest cached prefix across shards: one CONCURRENT rpc per
        shard (server-side search over that shard's subsequence,
        infinistore.cpp:1092-1108) + client-side merge — ~1 RTT total,
        replacing log2(n) sequential check_exist probes. Raises if no
        key matches (same contract as
        InfinityConnection.get_match_last_index).

        Note: like the reference, the server-side search counts
        uncommitted entries (SURVEY.md §3.5 quirk) — a probe via
        check_exist would be stricter (committed-only)."""
        idx = self._match_last_index_raw(keys)
        if idx < 0:
            raise Exception("can't find a match")
        return idx

    def _match_last_index_raw(self, keys):
        """get_match_last_index returning -1 instead of raising on a
        clean miss — same contract as the InfinityConnection raw
        variant (CudaKVStore.cached_prefix_len depends on it). A down
        shard reports -1 for its subsequence, so its first owned key
        becomes the hole: prefix reuse SHRINKS under failure, it never
        claims unreachable pages. Directory mode probes each key's
        preferred LIVE replica instead of a fixed owner, so a replica
        death does not shrink the reusable prefix while its peer still
        holds the chain — the hot-prefix availability property."""
        attempts = 1 if self._ring is None else max(self.replication, 1)
        for attempt in range(attempts):
            parts = list(self._match_partition(keys).items())
            results = self._run_shard_calls(
                [(s, self.conns[s]._match_last_index_raw, (ks,))
                 for s, (_idxs, ks) in parts]
            )
            if all(ok for ok, _v in results) or attempt + 1 == attempts:
                break
            # Directory mode: a sub-call just DISCOVERED a dead replica
            # (marked degraded above). Re-partition — the chooser now
            # routes those keys to live peers — instead of letting the
            # first failure after a death shrink the reusable prefix.
        matches = [v if ok else -1 for ok, v in results]
        return self._merge_match(keys, parts, matches)

    def _match_partition(self, keys):
        """Prefix-probe partition: like _partition, but in directory
        mode each key routes to its preferred LIVE replica (the
        chooser the read ladder uses) rather than a fixed owner."""
        if self._ring is None:
            return self._partition(keys)
        parts = {}
        for i, k in enumerate(keys):
            s = self._choose_read_shard(k)
            if s is None:  # cannot happen with an empty tried set
                s = self._primary(k)
            if s not in parts:
                parts[s] = ([], [])
            parts[s][0].append(i)
            parts[s][1].append(k)
        return parts

    async def get_match_last_index_async(self, keys):
        # Default executor, NOT self._pool: the sync raw variant fans
        # out on self._pool internally, and nesting the outer call into
        # the same n-worker pool could deadlock it against its own
        # per-shard submissions.
        loop = asyncio.get_running_loop()
        idx = await loop.run_in_executor(
            None, self._match_last_index_raw, keys
        )
        if idx < 0:
            raise Exception("can't find a match")
        return idx

    def prefetch(self, keys, wait=False):
        """Sharded OP_PREFETCH: each shard's owned keys ride one rpc to
        that shard (concurrent fan-out). Advisory like the single-server
        call — a down shard's partition is silently skipped (its keys
        would miss on read anyway, the documented degrade contract).
        ``wait=True`` merges the per-shard count dicts.

        Directory mode routes each key to the same preferred live
        replica the read fan-out would pick — warming a replica the
        reads will not touch would spend tier bandwidth for nothing."""
        self._stamp_trace()
        parts = list(self._match_partition(keys).items())
        results = self._run_shard_calls(
            [(s, self.conns[s].prefetch, (ks, wait))
             for s, (_idxs, ks) in parts]
        )
        if not wait:
            return None
        merged = {"resident": 0, "queued": 0, "missing": 0, "skipped": 0}
        for (_s, (_idxs, ks)), (ok, v) in zip(parts, results):
            if ok and isinstance(v, dict):
                for k in merged:
                    merged[k] += v.get(k, 0)
            elif ok:
                # ClientConfig.prefetch=False on that conn: the call
                # succeeded but was an advisory no-op (v is None). The
                # keys are NOT missing — the shard is healthy and reads
                # will serve them — they were simply not queued. The
                # dead-shard chaos test surfaced this miscount: a fully
                # healthy store used to report every key "missing"
                # whenever client-side prefetch was disabled, lying to
                # callers that use `missing` as a re-put signal.
                merged["skipped"] += len(ks)
            else:
                # Down shard: its keys are unreachable/unqueued on the
                # chosen replica, never resident.
                merged["missing"] += len(ks)
        return merged

    def purge(self):
        return sum(
            r for r in self._fanout([(c.purge, ()) for c in self.conns])
            if r is not None
        )

    def delete_keys(self, keys):
        """Delete from the owning shard — or, directory mode, from
        EVERY replica (a delete that skipped a replica would resurrect
        the key through the read ladder). Returns keys deleted on at
        least one shard in directory mode, the summed count otherwise."""
        if self._ring is None or self.replication <= 1:
            parts = list(self._partition(keys).items())
            results = self._run_shard_calls(
                [(s, self.conns[s].delete_keys, (ks,))
                 for s, (_idxs, ks) in parts]
            )
            return sum(v for ok, v in results if ok)
        # One call set per REPLICA RANK (rank 0 = primaries): replica
        # copies must all go, but summing their per-shard counts would
        # over-report, so only the primary rank's counts are returned —
        # the primary holds exactly the committed keys.
        calls, rank0 = [], []
        for rank in range(self.replication):
            parts = {}
            for k in keys:
                reps = self._replicas(k)
                if rank < len(reps):
                    parts.setdefault(reps[rank], []).append(k)
            for s, ks in parts.items():
                calls.append((s, self.conns[s].delete_keys, (ks,)))
                rank0.append(rank == 0)
        results = self._run_shard_calls(calls)
        return sum(v for primary, (ok, v) in zip(rank0, results)
                   if primary and ok)

    def client_stats(self):
        """Client-side telemetry aggregated across shards:
        ``per_shard`` carries each connection's
        :meth:`InfinityConnection.client_stats` verbatim, and the top
        level merges them — counters summed, per-op histograms added
        bucket-wise (same power-of-two geometry, so addition is exact)
        with the percentiles recomputed over the merged buckets. Local
        — never touches the wire, safe with shards down."""
        from .lib import _hist_percentile_us

        per = [c.client_stats() for c in self.conns]
        ops = {}
        counters = {}
        for ps in per:
            for op, s in ps.get("ops", {}).items():
                m = ops.get(op)
                if m is None:
                    m = ops[op] = {
                        "count": 0, "total_us": 0,
                        "hist": [0] * len(s.get("hist", [])),
                    }
                m["count"] += s.get("count", 0)
                m["total_us"] += s.get("total_us", 0)
                h = s.get("hist", [])
                if len(h) > len(m["hist"]):
                    m["hist"] += [0] * (len(h) - len(m["hist"]))
                for b, n in enumerate(h):
                    m["hist"][b] += n
            for k, v in ps.get("counters", {}).items():
                counters[k] = counters.get(k, 0) + v
        for s in ops.values():
            s["p50_us"] = _hist_percentile_us(s["hist"], 0.50)
            s["p99_us"] = _hist_percentile_us(s["hist"], 0.99)
        # One-sided fabric telemetry, merged: see
        # lib.merge_fabric_stats for the AND/OR semantics of the mode
        # flags.
        from .lib import merge_fabric_stats

        fabric = merge_fabric_stats(per)
        # Directory-mode failover telemetry: the
        # ladder counters live on the router (see __init__), the
        # replica-read distribution is conn-index-aligned like the
        # other per-shard arrays. Zeros in legacy static-hash mode —
        # the section is always present so dashboards need no probe.
        reads = list(self.failover_stats["replica_reads"])
        total_reads = sum(reads)
        failover = {
            "read_failovers": self.failover_stats["read_failovers"],
            "refresh_on_miss": self.failover_stats["refresh_on_miss"],
            "replica_reads": reads,
            # Normalized distribution (milli-fractions): the tilt a
            # dead replica leaves on its peers, readable at a glance.
            "replica_read_share_milli": [
                int(1000 * r / total_reads) if total_reads else 0
                for r in reads
            ],
            "directory_epoch": self.directory_epoch,
        }
        return {
            "enabled": any(ps.get("enabled") for ps in per),
            "ops": ops,
            "counters": counters,
            "fabric": fabric,
            "failover": failover,
            "per_shard": per,
        }

    def client_trace_events(self):
        """Client-side spans from every shard connection, one Chrome
        thread track per shard (pid 0 = the client process), for
        tools/istpu_trace.py's merged timeline."""
        evts = []
        for s, c in enumerate(self.conns):
            for e in c.client_trace_events(pid=0,
                                           label=f"client shard{s}"):
                e = dict(e)
                e["tid"] = s
                evts.append(e)
        return evts

    def client_trace_json(self):
        import json as _json

        return _json.dumps({
            "displayTimeUnit": "ms",
            "traceEvents": self.client_trace_events(),
        })

    def stats(self):
        """Per-shard native stats (down shards report {'shard_down':
        True}) plus a 'sharded_health' summary entry with the degrade
        counters."""
        per = [
            v if ok else {"shard_down": True}
            for ok, v in self._run_shard_calls(
                [(s, c.stats, ()) for s, c in enumerate(self.conns)]
            )
        ]
        with self._health_lock:
            summary = dict(self.health)
            summary["degraded_shards"] = [
                i for i in range(self.n) if self.degraded[i]
            ]
            # Per-shard forensics: which shard is flapping, and its
            # most recent failure (repr-clipped), plus the prober
            # cadence in force.
            summary["per_shard"] = [
                dict(h, shard=i, degraded=self.degraded[i])
                for i, h in enumerate(self.shard_health)
            ]
            summary["recover_interval_s"] = self.recover_interval_s
            # Cluster directory mode: the epoch routing runs under and
            # the replica factor — what an operator needs next to the
            # per-shard forensics to judge "is this client stale".
            summary["directory_epoch"] = self.directory_epoch
            summary["replication"] = self.replication
        return per + [{"sharded_health": summary}]


__all__ = ["ShardedConnection"]

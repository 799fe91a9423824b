"""Cluster robustness tier: shard directory, replica placement and live
key-range rebalance.

The earlier scale-out story was ``ShardedConnection``'s static
``crc32 % n`` hash with per-shard degrade: a dead shard's keys simply
vanished, and adding capacity meant restarting every client with a new
config list. This module supplies the three pieces that turn the static
fan-out into an elastic cluster:

- **Directory** (:func:`build_directory`, :class:`HashRing`): an
  epoch-numbered shard map — a consistent-hash ring of virtual nodes
  with N-way replica sets — pushed to every shard's control plane
  (``POST /directory``) and served back (``GET /directory``). Clients
  ride directory epochs the way the pin cache rides the ctl-page epoch:
  a stale push answers ``WRONG_EPOCH`` plus the current map, and a
  stale client discovers re-routing through an explicit refresh or a
  read miss, never through silent misroute. The ring coordinate is
  ``zlib.crc32`` — byte-identical to the native ``KVIndex::ring_hash``,
  which is what makes server-side range export/evict and client-side
  routing agree on every key's position.

- **Replica placement**: a key's replica set is the first
  ``replication`` DISTINCT shards clockwise from its ring point. Writes
  fan to the whole set; reads prefer the least-loaded live replica and
  fail over along the set, so a replica death keeps hot prefix chains
  servable (``sharded.py`` implements the data path; this module only
  answers "which shards").

- **Live rebalance** (:class:`ClusterCoordinator`): key-range migration
  riding machinery the store already trusts — the source spills the
  moving range through the snapshot extent codec
  (``ist_server_snapshot_range``), the target adopts via the restore
  path, commit is a directory epoch bump pushed to every shard, and
  only then does the source evict the moved range
  (``ist_server_delete_range``). The zero-loss argument is the
  ordering: a committed key is always present on (a) its old owner
  until the evict step, and (b) its new owner from the adopt step, and
  the epoch bump between them re-routes readers — there is no instant
  at which neither holds the bytes. A migration that stalls (an export
  or adopt call exceeding its deadline) fires exactly one
  ``watchdog.migration`` verdict on the stalled shard, whose diagnostic
  bundle carries ``cluster.json`` — the directory AND the range cursor
  it died holding. The ``cluster.*`` failpoints (armed like any other:
  ``POST /fault`` / ``ISTPU_FAILPOINTS``) kill a source mid-range,
  crash a target mid-adopt, or refuse a directory push, which is the
  chaos harness ``tests/test_cluster.py`` drives.

Deployment note: export/adopt move bytes through spool files, so the
coordinator assumes the source and target can reach a shared spool
path (same host, NFS, or an object-store fuse mount). A streaming
cross-host hop is the natural follow-on once the fabric engine grows a
server-to-server channel.
"""

import json
import threading
import time
import urllib.error
import urllib.request
import zlib

RING_SPAN = 1 << 32

# Migration phases mirrored into the native cluster state (stats
# "cluster.migration_phase", cluster.migration_phase events, bundles).
PHASE_IDLE = -1
PHASE_EXPORT = 1
PHASE_ADOPT = 2
PHASE_EVICT = 3


def eval_failpoint(name, kill_exit=137):
    """Evaluate one ``cluster.*`` failpoint against the process-global
    native registry (armed via POST /fault, ``ISTPU_FAILPOINTS`` or
    ``ist_fault_arm``). Returns 0 (pass; delay policies have already
    slept) or a positive errno the caller should fail with. A ``kill``
    action exits THIS process on the spot — the chaos semantics for a
    migration source/target dying mid-range (the arming side chooses
    which process dies by choosing which process's registry it arms).
    """
    from . import _native

    rc = int(_native.get_lib().ist_cluster_failpoint(name.encode()))
    if rc == -2:
        import os

        os._exit(kill_exit)
    if rc == -1:
        raise ValueError(f"unknown cluster failpoint {name!r}")
    return rc


def ring_hash(key):
    """The shared ring coordinate: zlib.crc32, byte-identical to the
    native ``KVIndex::ring_hash`` (both sides MUST agree or a range
    migration would move the wrong keys)."""
    return zlib.crc32(key.encode() if isinstance(key, str) else key)


def in_range(h, lo, hi):
    """h in [lo, hi) with wrap-around (lo > hi spans the ring origin)."""
    if lo <= hi:
        return lo <= h < hi
    return h >= lo or h < hi


class HashRing:
    """Consistent-hash ring over a directory's shard list.

    Each shard contributes ``vnodes`` points (crc32 of
    ``"shard:<id>#<i>"`` — stable across processes); a key belongs to
    the first point clockwise from its own hash, and its replica set is
    the first ``replication`` DISTINCT shards continuing clockwise.
    Virtual nodes keep per-shard load within a few percent of uniform
    at 64 points/shard and — the property rebalance relies on — make an
    added shard take many SMALL ranges from all existing shards instead
    of one giant range from one victim.
    """

    def __init__(self, shard_ids, vnodes=64, replication=1):
        if not shard_ids:
            raise ValueError("ring needs at least one shard")
        self.shard_ids = list(shard_ids)
        self.vnodes = int(vnodes)
        self.replication = max(1, int(replication))
        points = []
        for sid in self.shard_ids:
            for i in range(self.vnodes):
                points.append((ring_hash(f"shard:{sid}#{i}"), sid))
        # Ties (two vnodes hashing identically) resolve by shard id so
        # every party sorts the ring identically.
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    def _successor_idx(self, h):
        """Index of the first ring point with hash > h (wrapping)."""
        import bisect

        i = bisect.bisect_right(self._hashes, h)
        return i % len(self._points)

    def replica_set(self, key):
        return self.replica_set_at(ring_hash(key))

    def replica_set_at(self, h):
        """First ``replication`` distinct shards clockwise from ring
        coordinate ``h`` (all shards when the ring is smaller)."""
        want = min(self.replication, len(self.shard_ids))
        out = []
        i = self._successor_idx(h)
        for _ in range(len(self._points)):
            sid = self._points[i][1]
            if sid not in out:
                out.append(sid)
                if len(out) == want:
                    break
            i = (i + 1) % len(self._points)
        return out

    def boundaries(self):
        """Every ring point hash, sorted (segment edges)."""
        return sorted(set(self._hashes))


def build_directory(shards, epoch=1, vnodes=64, replication=1):
    """Assemble a directory blob. ``shards``: iterable of dicts with
    ``id`` plus whatever the clients need to dial them (``host``,
    ``service_port``, ``manage_port``). The blob is what ``POST
    /directory`` pushes and ``GET /directory`` serves."""
    out = {
        "epoch": int(epoch),
        "vnodes": int(vnodes),
        "replication": int(replication),
        "shards": [dict(s) for s in shards],
    }
    ids = [s["id"] for s in out["shards"]]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate shard ids in directory: {ids}")
    return out


def directory_ring(directory):
    return HashRing(
        [s["id"] for s in directory["shards"]],
        vnodes=directory.get("vnodes", 64),
        replication=directory.get("replication", 1),
    )


def compute_moves(old_dir, new_dir):
    """Diff two directories into range moves and evictions.

    Returns ``(moves, evictions)`` where moves are
    ``{"lo", "hi", "src", "dst"}`` (copy the range from shard src to
    shard dst, a NEW member of that range's replica set) and evictions
    are ``{"lo", "hi", "shard"}`` (shard left the range's replica set;
    drop its copy after the epoch commit). Each joiner is paired with
    EVERY old member of the range, not just the old primary: a key
    committed while one old replica was down lives only on its peers
    (the documented replica repair debt), so exporting from a single
    member could hand the joiner an incomplete range — and the
    post-commit evict of an ousted peer would then delete the only
    surviving copy. Adopts are first-writer-wins, so the duplicate
    exports dedup on the target at the cost of R× export IO. Segments
    are delimited by the union of both rings' vnode points — within a
    segment every key has the same old and new replica sets — and
    adjacent segments with identical actions merge.
    """
    old_ring = directory_ring(old_dir)
    new_ring = directory_ring(new_dir)
    bounds = sorted(set(old_ring.boundaries() + new_ring.boundaries()))
    if not bounds:
        return [], []
    moves, evictions = [], []
    n = len(bounds)
    for i in range(n):
        lo = bounds[i]
        hi = bounds[(i + 1) % n] if i + 1 < n else bounds[0]
        # The final segment wraps from the last boundary through the
        # ring origin to the first; in_range/native both honor lo > hi.
        if lo == hi:  # single-boundary degenerate ring
            hi = (lo + RING_SPAN - 1) % RING_SPAN
        old_set = old_ring.replica_set_at(lo)
        new_set = new_ring.replica_set_at(lo)
        if old_set == new_set:
            continue
        for dst in new_set:
            if dst not in old_set:
                for src in old_set:
                    moves.append(
                        {"lo": lo, "hi": hi, "src": src, "dst": dst}
                    )
        for sid in old_set:
            if sid not in new_set:
                evictions.append({"lo": lo, "hi": hi, "shard": sid})

    def merge(items, keyfields):
        """Adjacent segments (hi == next lo) with identical actors
        merge into one range — vnode granularity would otherwise issue
        hundreds of tiny exports."""
        out = []
        for it in sorted(items, key=lambda x: x["lo"]):
            if out and out[-1]["hi"] == it["lo"] and all(
                out[-1][f] == it[f] for f in keyfields
            ):
                out[-1]["hi"] = it["hi"]
            else:
                out.append(dict(it))
        return out

    return merge(moves, ("src", "dst")), merge(evictions, ("shard",))


# -- control-plane HTTP helpers --------------------------------------------


def _http_json(method, url, body=None, timeout=10.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read().decode() or "{}")
        except ValueError:
            payload = {}
        return e.code, payload


def fetch_directory(manage_addr, timeout=10.0):
    """GET /directory from ``host:port`` → the directory response
    (``{"epoch", "directory", "shard_id", ...}``)."""
    st, body = _http_json("GET", f"http://{manage_addr}/directory",
                          timeout=timeout)
    if st != 200:
        raise RuntimeError(f"GET /directory on {manage_addr}: HTTP {st}")
    return body


class WrongEpoch(RuntimeError):
    """A directory push was stale; ``current`` carries the shard's
    newer map (the caller should adopt it and retry from there)."""

    def __init__(self, addr, current):
        super().__init__(f"WRONG_EPOCH from {addr}")
        self.current = current


def push_directory(directory, manage_addrs, timeout=10.0):
    """POST the directory to every shard's control plane. Raises
    :class:`WrongEpoch` when a shard already holds a NEWER epoch
    (returning that map), and RuntimeError listing unreachable/refusing
    shards otherwise — partial propagation is surfaced, never silent
    (stale shards would misroute reads they still receive).

    The blob is stamped with ``pushed_at_unix_us`` (the pusher's wall
    clock) before the first POST: every shard records its own adoption
    wall-clock stamp natively, and the fleet aggregator's epoch-
    propagation-lag gauge is the per-shard ``adopt - pushed`` delta —
    wall clocks, because monotonic clocks never compare across
    processes."""
    directory = dict(directory)
    directory.setdefault("pushed_at_unix_us", int(time.time() * 1e6))
    failed = []
    for addr in manage_addrs:
        try:
            st, body = _http_json("POST", f"http://{addr}/directory",
                                  body=directory, timeout=timeout)
        except OSError as e:
            failed.append((addr, repr(e)))
            continue
        if st == 409 and body.get("error") == "WRONG_EPOCH":
            raise WrongEpoch(addr, body.get("directory"))
        if st != 200:
            failed.append((addr, body.get("error", f"HTTP {st}")))
    if failed:
        raise RuntimeError(f"directory push failed on {failed}")
    return directory["epoch"]


class MigrationStalled(RuntimeError):
    """A range move stopped advancing; the verdict (one
    ``watchdog.migration`` trip + bundle) has already been fired on the
    stalled shard before this raises."""


class ClusterCoordinator:
    """Drives live key-range rebalance over the shards' control planes.

    ``manage_addr(shard)``: shards are the directory's shard dicts; the
    default reads ``host``/``manage_port``. ``spool_dir`` must be
    reachable by source and target (see the module docstring).

    The coordinator is deliberately stateless between calls: every bit
    of migration state that matters for forensics (phase, cursor,
    directory epoch) lives in the SHARDS' native cluster mirror, so a
    coordinator crash mid-migration leaves self-describing servers —
    the old epoch still routes, sources still hold their ranges, and a
    re-run converges (exports overwrite their spool files, adopts are
    first-writer-wins, evicts are idempotent).
    """

    def __init__(self, spool_dir, chunks=4, chunk_timeout_s=30.0,
                 http_timeout_s=None):
        self.spool_dir = spool_dir
        self.chunks = max(1, int(chunks))
        self.chunk_timeout_s = float(chunk_timeout_s)
        # Per-request cap; chunk_timeout_s is the stall DEADLINE (a
        # request past it is a stalled migration, not a slow one).
        self.http_timeout_s = (
            float(http_timeout_s)
            if http_timeout_s is not None
            else self.chunk_timeout_s
        )

    @staticmethod
    def manage_addr(shard):
        return f"{shard.get('host', '127.0.0.1')}:{shard['manage_port']}"

    def _migrate(self, addr, body, timeout=None):
        return _http_json(
            "POST", f"http://{addr}/migrate", body=body,
            timeout=timeout if timeout is not None else self.http_timeout_s,
        )

    def _fire_stall(self, addr, detail, phase, cursor):
        try:
            self._migrate(addr, {
                "action": "verdict", "detail": detail,
                "a0": int(phase), "a1": int(cursor),
            }, timeout=self.http_timeout_s)
        except OSError:
            pass  # a dead shard cannot bundle; the raise below still tells

    @staticmethod
    def _split(lo, hi, chunks):
        """[lo, hi) (wrapping) into up to `chunks` contiguous subranges."""
        span = (hi - lo) % RING_SPAN
        if span == 0:
            span = RING_SPAN
        chunks = min(chunks, span) or 1
        step = span // chunks
        edges = [(lo + i * step) % RING_SPAN for i in range(chunks)]
        edges.append(hi % RING_SPAN)
        return [(edges[i], edges[i + 1]) for i in range(chunks)]

    def move_range(self, src_shard, dst_shard, lo, hi, tag=""):
        """Copy [lo, hi) from src to dst: chunked export on the source
        (each chunk advances the source's migration cursor), then adopt
        on the target. Stalls fire the verdict on the stalled shard and
        raise. Returns (exported, adopted) entry counts."""
        src_addr = self.manage_addr(src_shard)
        dst_addr = self.manage_addr(dst_shard)
        subranges = self._split(lo, hi, self.chunks)
        files, exported = [], 0
        for i, (clo, chi) in enumerate(subranges):
            path = (f"{self.spool_dir}/migrate-{src_shard['id']}-"
                    f"{dst_shard['id']}-{tag}{i}.snap")
            t0 = time.monotonic()
            try:
                st, body = self._migrate(src_addr, {
                    "action": "export", "lo": clo, "hi": chi,
                    "path": path, "cursor": i + 1,
                    "total": len(subranges),
                }, timeout=self.chunk_timeout_s)
            except OSError as e:
                # Timeout or a source death mid-range. Fire the verdict
                # (best-effort — a killed source cannot answer) so the
                # stall self-diagnoses with the cursor it died holding.
                self._fire_stall(
                    src_addr,
                    f"range export [{clo:#x},{chi:#x}) chunk {i + 1}/"
                    f"{len(subranges)} stalled after "
                    f"{time.monotonic() - t0:.1f}s: {e!r}",
                    PHASE_EXPORT, i + 1)
                raise MigrationStalled(
                    f"export chunk {i + 1} on {src_addr}: {e!r}") from e
            if st != 200:
                raise RuntimeError(
                    f"export chunk {i + 1} on {src_addr}: "
                    f"{body.get('error', f'HTTP {st}')}")
            exported += int(body.get("exported", 0))
            files.append(path)
        adopted = 0
        try:
            st, body = self._migrate(dst_addr, {
                "action": "import", "paths": files,
                "total": len(files),
            }, timeout=self.chunk_timeout_s)
        except OSError as e:
            self._fire_stall(
                src_addr,
                f"target {dst_addr} adopt of [{lo:#x},{hi:#x}) stalled/"
                f"died: {e!r}", PHASE_ADOPT, len(files))
            raise MigrationStalled(
                f"adopt on {dst_addr}: {e!r}") from e
        if st != 200:
            raise RuntimeError(
                f"adopt on {dst_addr}: {body.get('error', f'HTTP {st}')}")
        adopted = int(body.get("adopted", 0))
        return exported, adopted

    def rebalance(self, old_dir, new_dir, extra_addrs=()):
        """The full live-rebalance protocol: copy every changed range,
        COMMIT via the epoch bump push, then evict ousted copies.
        ``extra_addrs``: manage addresses beyond the union of both
        directories (decommissioned shards that should still learn the
        new map). Returns a summary dict."""
        if new_dir["epoch"] <= old_dir["epoch"]:
            raise ValueError("new directory must bump the epoch")
        shards = {s["id"]: s for s in old_dir["shards"]}
        shards.update({s["id"]: s for s in new_dir["shards"]})
        moves, evictions = compute_moves(old_dir, new_dir)
        exported = adopted = evicted = 0
        for i, mv in enumerate(moves):
            e, a = self.move_range(shards[mv["src"]], shards[mv["dst"]],
                                   mv["lo"], mv["hi"], tag=f"m{i}-")
            exported += e
            adopted += a
        # COMMIT: the epoch bump. From here readers route by the new
        # map; sources still hold their old copies, so a straggler
        # client on the old epoch keeps reading correct bytes until the
        # evict below — and discovers the bump on its next refresh.
        addrs = [self.manage_addr(s) for s in shards.values()]
        addrs += [a for a in extra_addrs if a not in addrs]
        push_directory(new_dir, addrs, timeout=self.http_timeout_s)
        for ev in evictions:
            addr = self.manage_addr(shards[ev["shard"]])
            st, body = self._migrate(addr, {
                "action": "evict", "lo": ev["lo"], "hi": ev["hi"],
            })
            if st == 200:
                evicted += int(body.get("evicted", 0))
        return {
            "epoch": new_dir["epoch"],
            "moves": len(moves),
            "exported": exported,
            "adopted": adopted,
            "evicted": evicted,
        }

    def add_shard(self, old_dir, new_shard, extra_addrs=()):
        """Grow the cluster by one shard: derive the next directory
        (epoch + 1), migrate the ranges the ring hands it, commit,
        evict. Returns (new_dir, summary)."""
        new_dir = build_directory(
            old_dir["shards"] + [new_shard],
            epoch=old_dir["epoch"] + 1,
            vnodes=old_dir.get("vnodes", 64),
            replication=old_dir.get("replication", 1),
        )
        return new_dir, self.rebalance(old_dir, new_dir,
                                       extra_addrs=extra_addrs)


def divergence_ranges(directory):
    """The ring split into the minimal set of ``(lo, hi, replica_ids)``
    segments over which every key has the SAME replica set, adjacent
    same-set segments merged (vnode granularity would otherwise hand
    the digest pass hundreds of micro-ranges). Single-replica segments
    are skipped — one copy cannot diverge from itself."""
    if not directory.get("shards") or \
            directory.get("replication", 1) <= 1:
        return []
    ring = directory_ring(directory)
    bounds = ring.boundaries()
    n = len(bounds)
    segs = []
    for i in range(n):
        lo = bounds[i]
        hi = bounds[(i + 1) % n] if i + 1 < n else bounds[0]
        if lo == hi:  # single-boundary degenerate ring
            hi = (lo + RING_SPAN - 1) % RING_SPAN
        reps = tuple(ring.replica_set_at(lo))
        if len(reps) < 2:
            continue
        if segs and segs[-1][1] == lo and segs[-1][2] == reps:
            segs[-1] = (segs[-1][0], hi, reps)
        else:
            segs.append((lo, hi, reps))
    # The last segment wraps to the first boundary; merge across the
    # origin when the sets match so the wrap seam is one range too.
    if len(segs) > 1 and segs[-1][1] == segs[0][0] \
            and segs[-1][2] == segs[0][2]:
        segs[0] = (segs[-1][0], segs[0][1], segs[0][2])
        segs.pop()
    return segs


class FleetAggregator:
    """Fleet-wide observability over the shard directory.

    One aggregator scrapes every shard's control plane (``/stats``,
    ``/slo``, ``/history``, ``POST /digest``) and serves three merged
    views through whichever shard's control plane hosts it:

    - ``GET /cluster/status`` (:meth:`status`): per-shard gauges +
      health, occupancy/key skew, epoch-propagation lag per shard
      (push→adopt wall-clock delta + WRONG_EPOCH rejection counts),
      live migration progress (cursor rate → ETA, keys/bytes adopted
      by the target since the migration began) and the replica-
      divergence table.
    - ``GET /cluster/slo`` (:meth:`slo`): bucket-summed burn-rate
      windows across shards plus the QUORUM availability semantics the
      replicated data path promises — a key-range counts DOWN only when
      every replica of it is down, so one dead shard under
      replication=2 burns nothing (mirroring "a key is lost only when
      EVERY targeted replica dropped it").
    - ``GET /cluster/history`` (:meth:`history`): the shards' metrics-
      history rings merged sample-by-sample (aligned from the TAIL —
      all shards sample at the same cadence but their monotonic clocks
      never compare), counters and latency-histogram deltas summed
      BUCKET-WISE in the shared LatHist geometry so merged percentiles
      stay exact.

    Verdicts (:meth:`poll_once`, or the :meth:`start` thread): a
    divergent range persisting ``divergence_streak`` digest passes
    fires ``watchdog.replica_divergence`` on the LOCAL server; a shard
    serving an epoch behind the fleet maximum for longer than
    ``epoch_lag_trip_s`` fires ``watchdog.epoch_lag``. Both ride the
    native verdict machinery (event + trip counter + diagnostic
    bundle, per-kind cooldown), and after a trip the aggregator drops
    ``fleet.json`` — the full :meth:`status` snapshot of EVERY shard —
    into the freshly captured bundle so ``istpu_top --bundle`` renders
    the whole fleet, not just the shard that happened to host the
    aggregator.

    Divergence digests are the expensive scrape half (each range costs
    the shard one committed-key walk), so they run every
    ``digest_every``-th scrape, batched as ONE ``POST /digest`` per
    shard carrying that shard's whole range list.
    """

    def __init__(self, server=None, directory=None, seed_addrs=(),
                 scrape_interval_s=1.0, digest_every=5,
                 divergence_streak=2, epoch_lag_trip_s=30.0,
                 http_timeout_s=2.0):
        self.server = server
        self._directory = directory
        self.seed_addrs = list(seed_addrs)
        self.scrape_interval_s = max(float(scrape_interval_s), 0.05)
        self.digest_every = max(1, int(digest_every))
        self.divergence_streak = max(1, int(divergence_streak))
        self.epoch_lag_trip_s = float(epoch_lag_trip_s)
        self.http_timeout_s = float(http_timeout_s)
        self.trips = {"replica_divergence": 0, "epoch_lag": 0}
        self._lock = threading.Lock()
        # Serializes whole scrape passes: control-plane handler
        # threads (TTL-expired /cluster/* pulls) and the poll thread
        # all funnel here, and the divergence STREAK counters must
        # advance at most once per real pass — two back-to-back
        # passes racing a write fan-out would otherwise reach the
        # verdict streak inside one write window.
        self._scrape_lock = threading.Lock()
        self._status = None          # last scrape result
        self._status_t = 0.0         # monotonic stamp (TTL cache)
        self._scrapes = 0
        self._divergent = {}         # range key -> consecutive passes
        self._lag_since = {}         # shard id -> monotonic first-seen
        self._mig_base = {}          # shard id -> (kvmap, used) baseline
        self._mig_prev = {}          # shard id -> (cursor, monotonic t)
        self._stop = threading.Event()
        self._thread = None

    # -- directory discovery -------------------------------------------

    def directory(self):
        """The directory the aggregator scrapes by: the freshest of
        the explicit blob, the local server's native mirror, and
        whatever the seed addresses answer."""
        best = self._directory

        def better(d):
            # >= on purpose: at EQUAL epochs the shard-held copy wins —
            # push_directory stamps pushed_at_unix_us into the pushed
            # blob only, and the lag math needs the stamped one.
            return d and d.get("epoch", 0) >= (best or {}).get("epoch", 0)

        if self.server is not None:
            try:
                d = self.server.cluster().get("directory")
                if better(d):
                    best = d
            except Exception:  # noqa: BLE001 — keep the held map
                pass
        if best is None:
            for addr in self.seed_addrs:
                try:
                    d = fetch_directory(
                        addr, timeout=self.http_timeout_s
                    ).get("directory")
                except Exception:  # noqa: BLE001 — next seed
                    continue
                if better(d):
                    best = d
        self._directory = best
        return best

    @staticmethod
    def _addr(shard):
        return f"{shard.get('host', '127.0.0.1')}:{shard['manage_port']}"

    def _get(self, addr, path):
        st, body = _http_json("GET", f"http://{addr}{path}",
                              timeout=self.http_timeout_s)
        if st != 200:
            raise RuntimeError(f"GET {path} on {addr}: HTTP {st}")
        return body

    # -- scrape --------------------------------------------------------

    def scrape(self):
        """One scrape pass over every directory shard; returns (and
        caches) the /cluster/status blob. Down shards are marked, not
        raised — a fleet view with holes beats no view. Whole passes
        serialize on ``_scrape_lock``; a caller that blocked behind a
        concurrent pass adopts that pass's result instead of running
        its own back-to-back (verdict streaks count REAL passes)."""
        t0 = time.monotonic()
        with self._scrape_lock:
            with self._lock:
                cached, tc = self._status, self._status_t
            if cached is not None and tc >= t0:
                return cached  # a concurrent pass finished while we waited
            return self._scrape_locked()

    def _scrape_locked(self):
        directory = self.directory()
        now_unix = int(time.time() * 1e6)
        shards = []
        per_stats = {}
        for s in (directory or {}).get("shards", []):
            if "manage_port" not in s:
                continue
            addr = self._addr(s)
            row = {"id": s["id"], "addr": addr, "up": False}
            try:
                st = self._get(addr, "/stats")
            except Exception as e:  # noqa: BLE001 — down shard
                row["error"] = repr(e)[:120]
                shards.append(row)
                continue
            per_stats[s["id"]] = st
            cl = st.get("cluster", {})
            wd = st.get("watchdog", {})
            # Aggregate p99 across ops from the shared power-of-two
            # buckets (exact merge, same geometry everywhere).
            hist = []
            for op in st.get("op_stats", {}).values():
                for b, v in enumerate(op.get("hist") or []):
                    if b >= len(hist):
                        hist.append(v)
                    else:
                        hist[b] += v
            row.update({
                "up": True,
                "epoch": cl.get("epoch", 0),
                "adopt_unix_us": cl.get("adopt_unix_us", 0),
                "wrong_epoch_rejections":
                    cl.get("wrong_epoch_rejections", 0),
                "migration_phase": cl.get("migration_phase", -1),
                "migration_cursor": cl.get("migration_cursor", 0),
                "migration_total": cl.get("migration_total", 0),
                "used_bytes": st.get("used_bytes", 0),
                "pool_bytes": st.get("pool_bytes", 0),
                "occupancy": (st.get("used_bytes", 0)
                              / st.get("pool_bytes", 1)
                              if st.get("pool_bytes") else 0.0),
                "kvmap_len": st.get("kvmap_len", 0),
                "ops": st.get("ops", 0),
                "connections": st.get("connections", 0),
                "workers_dead": st.get("workers_dead", 0),
                "tier_breaker_open": st.get("tier_breaker_open", 0),
                "spill_queue_depth": st.get("spill_queue_depth", 0),
                "promote_queue_depth": st.get("promote_queue_depth", 0),
                "p99_us": _hist_p99(hist or []),
                "watchdog_stalled": wd.get("stalled", 0),
                "watchdog_trips": wd.get("trips", 0),
            })
            shards.append(row)
        # Epoch riding, aggregator-side: any shard reporting a NEWER
        # epoch than the held map (visible for free in the /stats
        # cluster section) triggers one /directory fetch from it, so a
        # standalone aggregator follows rebalances instead of freezing
        # on the epoch it bootstrapped with — skew math, divergence
        # ranges and quorum spans must all run over current placement.
        held = (directory or {}).get("epoch", 0)
        ahead = [r for r in shards if r.get("up")
                 and r.get("epoch", 0) > held]
        if ahead:
            try:
                d = fetch_directory(
                    max(ahead, key=lambda r: r["epoch"])["addr"],
                    timeout=self.http_timeout_s).get("directory")
            except Exception:  # noqa: BLE001 — next scrape retries
                d = None
            if d and d.get("epoch", 0) > held:
                self._directory = directory = d
        self._scrapes += 1
        status = {
            "epoch": max([r.get("epoch", 0) for r in shards] + [0]),
            "directory": directory,
            "scraped_at_unix_us": now_unix,
            "scrapes": self._scrapes,
            "shards": shards,
            "down_shards": [r["id"] for r in shards if not r["up"]],
        }
        status["skew"] = self._skew(shards)
        status["epoch_lag"] = self._epoch_lag(directory, shards,
                                              now_unix)
        status["migration"] = self._migration(shards)
        run_digests = (self._scrapes % self.digest_every) == 0 \
            or self._status is None
        if run_digests:
            status["divergence"] = self._divergence(directory, shards)
        else:
            status["divergence"] = (self._status or {}).get(
                "divergence",
                {"checked_ranges": 0, "divergent": [], "gauge": 0,
                 "pass": 0})
        with self._lock:
            self._status = status
            self._status_t = time.monotonic()
        return status

    @staticmethod
    def _skew(shards):
        """Load-imbalance facts across UP shards: occupancy spread and
        the key-count imbalance (max/mean — 1.0 is perfect)."""
        up = [r for r in shards if r["up"]]
        if not up:
            return {"up_shards": 0}
        occ = [r["occupancy"] for r in up]
        keys = [r["kvmap_len"] for r in up]
        mean_keys = sum(keys) / len(keys)
        return {
            "up_shards": len(up),
            "occupancy_max": round(max(occ), 4),
            "occupancy_min": round(min(occ), 4),
            "occupancy_spread": round(max(occ) - min(occ), 4),
            "keys_max": max(keys),
            "keys_imbalance": (round(max(keys) / mean_keys, 3)
                               if mean_keys else 1.0),
            "epoch_skew": max(r["epoch"] for r in up)
            - min(r["epoch"] for r in up),
        }

    def _epoch_lag(self, directory, shards, now_unix):
        """Per-shard directory-epoch propagation lag. A shard AT the
        fleet-max epoch reports its achieved push→adopt delta; a shard
        BEHIND it reports a still-growing lag from the newest push
        stamp (the blob carries pushed_at_unix_us)."""
        pushed = (directory or {}).get("pushed_at_unix_us", 0)
        fleet_max = max([r.get("epoch", 0) for r in shards] + [0])
        per = {}
        for r in shards:
            if not r["up"]:
                per[str(r["id"])] = -1
                continue
            if r.get("epoch", 0) < fleet_max:
                per[str(r["id"])] = (max(0, now_unix - pushed)
                                    if pushed else -1)
            elif pushed and r.get("adopt_unix_us", 0) >= pushed:
                per[str(r["id"])] = r["adopt_unix_us"] - pushed
            else:
                per[str(r["id"])] = 0
        lags = [v for v in per.values() if v >= 0]
        return {
            "pushed_at_unix_us": pushed,
            "per_shard_us": per,
            "max_lag_us": max(lags) if lags else 0,
            "behind_shards": [r["id"] for r in shards
                              if r["up"] and r.get("epoch", 0) < fleet_max],
            "wrong_epoch_rejections": sum(
                r.get("wrong_epoch_rejections", 0) for r in shards
                if r["up"]),
        }

    def _migration(self, shards):
        """Live migration progress: the cursor the shards mirror
        natively, its rate across scrapes (→ ETA), and the keys/bytes
        the migrating shard gained/lost since the phase left idle."""
        active = [r for r in shards
                  if r["up"] and r.get("migration_phase", -1) >= 0
                  and r.get("migration_phase") != PHASE_IDLE]
        out = {"active": bool(active), "shards": []}
        seen = set()
        for r in active:
            sid = r["id"]
            seen.add(sid)
            cursor = r.get("migration_cursor", 0)
            total = r.get("migration_total", 0)
            now = time.monotonic()
            base = self._mig_base.setdefault(
                sid, (r["kvmap_len"], r["used_bytes"]))
            prev = self._mig_prev.get(sid)
            rate = 0.0
            if prev is not None and now > prev[1]:
                rate = max(0.0, (cursor - prev[0]) / (now - prev[1]))
            self._mig_prev[sid] = (cursor, now)
            eta = ((total - cursor) / rate
                   if rate > 0 and total > cursor else -1.0)
            out["shards"].append({
                "id": sid,
                "phase": r.get("migration_phase"),
                "cursor": cursor,
                "total": total,
                "rate_chunks_per_s": round(rate, 3),
                "eta_s": round(eta, 1) if eta >= 0 else -1,
                "keys_delta": r["kvmap_len"] - base[0],
                "bytes_delta": r["used_bytes"] - base[1],
            })
        # Idle shards drop their baselines — the next migration gets a
        # fresh zero, not last month's deltas.
        for sid in list(self._mig_base):
            if sid not in seen:
                self._mig_base.pop(sid, None)
                self._mig_prev.pop(sid, None)
        return out

    def _divergence(self, directory, shards):
        """One digest pass: every multi-replica range's digest compared
        across its replica set (one batched POST /digest per shard).
        Persistent divergence (``divergence_streak`` passes) is what
        the verdict loop trips on — a write mid-fan-out diverges for
        one pass by design."""
        up = {r["id"]: r for r in shards if r["up"]}
        segs = divergence_ranges(directory or {})
        by_shard = {}
        for lo, hi, reps in segs:
            for sid in reps:
                if sid in up:
                    by_shard.setdefault(sid, []).append((lo, hi))
        digests = {}  # (sid, lo, hi) -> {digest, count, bytes}
        for sid, ranges in by_shard.items():
            try:
                st, body = _http_json(
                    "POST", f"http://{up[sid]['addr']}/digest",
                    body={"ranges": [[lo, hi] for lo, hi in ranges]},
                    timeout=self.http_timeout_s)
            except OSError:
                continue
            if st != 200:
                continue
            for d in body.get("digests", []):
                digests[(sid, d["lo"], d["hi"])] = d
        divergent = []
        fresh = set()
        for lo, hi, reps in segs:
            got = [(sid, digests.get((sid, lo, hi))) for sid in reps
                   if sid in up]
            got = [(sid, d) for sid, d in got if d is not None]
            if len(got) < 2:
                continue  # 0/1 reachable replicas: nothing to compare
            if len({d["digest"] for _sid, d in got}) > 1:
                key = f"{lo:08x}-{hi:08x}"
                fresh.add(key)
                self._divergent[key] = self._divergent.get(key, 0) + 1
                divergent.append({
                    "range": key, "lo": lo, "hi": hi,
                    "passes": self._divergent[key],
                    "replicas": [
                        {"id": sid, "digest": d["digest"],
                         "count": d["count"], "bytes": d["bytes"]}
                        for sid, d in got
                    ],
                })
        for key in list(self._divergent):
            if key not in fresh:
                del self._divergent[key]  # converged (anti-entropy ran)
        return {
            "checked_ranges": len(segs),
            "divergent": divergent,
            "gauge": len(divergent),
            "pass": self._scrapes,
        }

    # -- merged views --------------------------------------------------

    def status(self, max_age_s=None):
        """The /cluster/status blob; re-scrapes when the cache is older
        than ``max_age_s`` (default: the scrape interval)."""
        ttl = self.scrape_interval_s if max_age_s is None else max_age_s
        with self._lock:
            cached, t = self._status, self._status_t
        if cached is not None and time.monotonic() - t < ttl:
            return cached
        return self.scrape()

    def cached_status(self):
        """The last scrape without touching the network (the /metrics
        renderer uses this — a metrics pull must never fan out HTTP
        probes of its own). None before the first scrape."""
        with self._lock:
            return self._status

    def slo(self):
        """The /cluster/slo blob: per-shard burn windows SUMMED (ops /
        bad / errors — counts, so addition is exact; burn rates
        recomputed from the sums) + the quorum availability objective:
        a key-range is DOWN only when EVERY replica of it is down."""
        status = self.status()
        directory = status.get("directory")
        up_ids = {r["id"] for r in status["shards"] if r["up"]}
        per_slo = {}
        for r in status["shards"]:
            if not r["up"]:
                continue
            try:
                per_slo[r["id"]] = self._get(r["addr"], "/slo")
            except Exception:  # noqa: BLE001 — scrape hole
                continue
        merged = {}
        objectives = {}
        burn_threshold = 2.0
        for blob in per_slo.values():
            objectives = {
                "latency": blob.get("latency", {}),
                "availability": blob.get("availability", {}),
            }
            burn_threshold = blob.get("burn_threshold", 2.0)
            for win in ("short", "long"):
                w = blob.get(win, {})
                m = merged.setdefault(win, {
                    "window_s": w.get("window_s", 0),
                    "ops": 0, "bad": 0, "errors": 0})
                m["ops"] += w.get("ops", 0)
                m["bad"] += w.get("bad", 0)
                m["errors"] += w.get("errors", 0)
        lat_obj = (objectives.get("latency", {}) or {}).get(
            "objective", 0.999)
        avail_obj = (objectives.get("availability", {}) or {}).get(
            "objective", 0.999)
        for w in merged.values():
            total = w["ops"]
            w["latency_burn_rate"] = round(
                (w["bad"] / total) / (1.0 - lat_obj) if total else 0.0,
                3)
            w["availability_burn_rate"] = round(
                (w["errors"] / total) / (1.0 - avail_obj)
                if total else 0.0, 3)
        merged.setdefault("short", {
            "window_s": 0, "ops": 0, "bad": 0, "errors": 0,
            "latency_burn_rate": 0.0, "availability_burn_rate": 0.0})
        merged.setdefault("long", dict(merged["short"]))
        # Quorum availability over the RING: span covered by >= 1 live
        # replica / total span. One dead shard at replication=2 leaves
        # every range covered — availability 1.0, nothing burning —
        # which is exactly the replicated data-path promise ("lost only if
        # EVERY replica dropped it") restated for the SLO plane.
        covered = down_span = 0
        ranges_down = []
        if directory:
            ring = directory_ring(directory)
            bounds = ring.boundaries()
            n = len(bounds)
            for i in range(n):
                lo = bounds[i]
                hi = bounds[(i + 1) % n] if i + 1 < n else bounds[0]
                span = (hi - lo) % RING_SPAN or RING_SPAN
                reps = ring.replica_set_at(lo)
                if any(sid in up_ids for sid in reps):
                    covered += span
                else:
                    down_span += span
                    if len(ranges_down) < 16:
                        ranges_down.append(f"{lo:08x}-{hi:08x}")
        total_span = covered + down_span
        quorum_avail = covered / total_span if total_span else 1.0
        quorum_burn = round(
            (1.0 - quorum_avail) / (1.0 - avail_obj), 3)
        lat_burning = all(
            merged[w]["latency_burn_rate"] >= burn_threshold
            for w in ("short", "long")) and merged["short"]["ops"] > 0
        avail_burning = all(
            merged[w]["availability_burn_rate"] >= burn_threshold
            for w in ("short", "long")) and merged["short"]["ops"] > 0
        quorum_burning = quorum_burn >= burn_threshold
        return {
            "enabled": bool(per_slo),
            "shards_reporting": len(per_slo),
            "down_shards": status["down_shards"],
            "latency": objectives.get("latency", {}),
            "availability": objectives.get("availability", {}),
            "burn_threshold": burn_threshold,
            "short": merged["short"],
            "long": merged["long"],
            "quorum": {
                "availability": round(quorum_avail, 6),
                "burn_rate": quorum_burn,
                "ranges_down": ranges_down,
                "down_span_frac": round(
                    down_span / total_span if total_span else 0.0, 6),
            },
            "latency_burning": lat_burning,
            "availability_burning": avail_burning,
            "quorum_burning": quorum_burning,
            "burning": lat_burning or avail_burning or quorum_burning,
        }

    def history(self):
        """The /cluster/history blob: the shards' rings merged sample-
        by-sample. Alignment is from the TAIL (newest sample of each
        shard merges together) because every shard samples at the same
        native cadence while their monotonic t_us values share no
        origin; merged t_us counts back from the aggregator's clock at
        the shared interval. Deltas and lat_delta sum bucket-wise — the
        LatHist geometry is identical everywhere, so merged percentile
        math stays exact."""
        status = self.status()
        rings = {}
        interval_ms = 1000
        buckets = 0
        for r in status["shards"]:
            if not r["up"]:
                continue
            try:
                h = self._get(r["addr"], "/history")
            except Exception:  # noqa: BLE001 — scrape hole
                continue
            rings[r["id"]] = h.get("history", [])
            interval_ms = h.get("interval_ms", interval_ms) or 1000
            buckets = max(buckets, h.get("buckets", 0))
        depth = max((len(v) for v in rings.values()), default=0)
        now_us = int(time.monotonic() * 1e6)
        merged = []
        sum_keys = (
            "used_bytes", "pool_bytes", "kvmap_len", "connections",
            "spill_queue_depth", "promote_queue_depth", "ops_delta",
            "bytes_in_delta", "bytes_out_delta", "reads_busy_delta",
            "disk_io_errors_delta", "hard_stalls_delta",
            "evictions_delta", "spills_delta", "promotes_delta",
            "premature_evictions_delta", "thrash_cycles_delta",
            "wss_bytes", "workers_dead",
        )
        for back in range(depth, 0, -1):
            out = {k: 0 for k in sum_keys}
            out["t_us"] = now_us - back * interval_ms * 1000
            out["lat_delta"] = [0] * buckets
            out["shards_reporting"] = 0
            epochs = []
            for samples in rings.values():
                if back > len(samples):
                    continue
                s = samples[-back]
                out["shards_reporting"] += 1
                for k in sum_keys:
                    out[k] += s.get(k, 0)
                for b, v in enumerate(s.get("lat_delta", [])):
                    if b < buckets:
                        out["lat_delta"][b] += v
                epochs.append(s.get("cluster_epoch", 0))
            # min epoch across shards AT this sample: the lag-visible
            # view (a merged max would hide a straggler).
            out["cluster_epoch"] = min(epochs) if epochs else 0
            out["cluster_epoch_max"] = max(epochs) if epochs else 0
            merged.append(out)
        return {
            "enabled": 1 if rings else 0,
            "merged_from": sorted(rings),
            "interval_ms": interval_ms,
            "buckets": buckets,
            "now_us": now_us,
            "history": merged,
        }

    # -- verdict loop --------------------------------------------------

    def poll_once(self):
        """One verdict pass: scrape, then fire the cluster-aware
        watchdog verdicts on the local server when their conditions
        hold. Returns the status blob."""
        status = self.scrape()
        if self.server is None:
            return status
        # replica_divergence: a range divergent for >= streak passes.
        ripe = [d for d in status["divergence"]["divergent"]
                if d["passes"] >= self.divergence_streak]
        if ripe:
            d0 = ripe[0]
            detail = (
                f"{len(ripe)} range(s) with divergent replica digests, "
                f"first {d0['range']} across shards "
                f"{[r['id'] for r in d0['replicas']]} "
                f"(persisted {d0['passes']} digest passes)"
            )
            if self._trip(0, detail, d0["lo"], len(ripe)):
                self.trips["replica_divergence"] += 1
        # epoch_lag: a shard behind the fleet-max epoch for too long.
        behind = set(status["epoch_lag"]["behind_shards"])
        now = time.monotonic()
        for sid in behind:
            self._lag_since.setdefault(sid, now)
        for sid in list(self._lag_since):
            if sid not in behind:
                del self._lag_since[sid]
        ripe_lag = [sid for sid, t0 in self._lag_since.items()
                    if now - t0 >= self.epoch_lag_trip_s]
        if ripe_lag:
            sid = ripe_lag[0]
            lag_us = status["epoch_lag"]["per_shard_us"].get(
                str(sid), -1)
            detail = (
                f"shard {sid} still behind fleet epoch "
                f"{status['epoch']} after "
                f"{now - self._lag_since[sid]:.1f}s "
                f"(propagation lag {lag_us} us)"
            )
            if self._trip(1, detail, int(sid), max(0, int(lag_us))):
                self.trips["epoch_lag"] += 1
        return status

    def _trip(self, kind, detail, a0, a1):
        """Fire a cluster verdict on the local server; on success drop
        fleet.json (the full fleet snapshot) into the bundle the native
        side just captured."""
        try:
            fired = self.server.cluster_trip(kind, detail, a0, a1)
        except Exception:  # noqa: BLE001 — verdict is best-effort
            return False
        if fired:
            self._write_fleet_snapshot(
                "replica_divergence" if kind == 0 else "epoch_lag")
        return fired

    def _write_fleet_snapshot(self, kind):
        """Append fleet.json to the newest bundle of `kind`: the native
        capture carries only the LOCAL shard's files; the aggregator is
        the one party holding every shard's snapshot."""
        import os

        bundle_dir = getattr(self.server.config, "bundle_dir", "")
        if not bundle_dir:
            bundle_dir = os.environ.get("ISTPU_BUNDLE_DIR", "")
        if not bundle_dir or not os.path.isdir(bundle_dir):
            return
        suffix = f"-{kind}"
        bundles = sorted(
            d for d in os.listdir(bundle_dir)
            if d.startswith("bundle-") and d.endswith(suffix)
        )
        if not bundles:
            return
        path = os.path.join(bundle_dir, bundles[-1], "fleet.json")
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(self.cached_status() or {}, f)
        except OSError:
            pass  # forensics are best-effort; the bundle itself stands

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="istpu-fleet-agg"
        )
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.scrape_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — keep scraping
                pass

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


def _hist_p99(hist):
    """Midpoint p99 over one power-of-two latency histogram (the
    LatHist convention every surface shares)."""
    total = sum(hist)
    if total == 0:
        return 0
    rank = int(0.99 * (total - 1)) + 1
    seen = 0
    for b, n in enumerate(hist):
        seen += n
        if seen >= rank:
            return (1 << b) + (1 << b) // 2
    return 0


__all__ = [
    "RING_SPAN", "PHASE_IDLE", "PHASE_EXPORT", "PHASE_ADOPT",
    "PHASE_EVICT", "ring_hash", "in_range", "HashRing",
    "build_directory", "directory_ring", "compute_moves",
    "fetch_directory", "push_directory", "WrongEpoch",
    "MigrationStalled", "ClusterCoordinator", "divergence_ranges",
    "FleetAggregator",
]

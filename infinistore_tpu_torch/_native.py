"""ctypes bindings to the store's native library — the port's own copy.

Same C ABI and declarations as the JAX package's binding. The library is
built from ``native/`` on first use into ``infinistore_tpu_torch/_build``,
and again whenever its sources change (see :func:`build_native`);
``INFINISTORE_TPU_TORCH_NATIVE_LIB`` names another build to load instead.

Parity target: the reference's pybind11 module ``_infinistore``
(reference src/pybind.cpp). The native core exports a C ABI and this
module is the binding layer. ctypes releases the GIL around every foreign
call, matching the reference's ``py::call_guard<py::gil_scoped_release>``
behavior (pybind.cpp:49-187), and allocate/pin results land in
caller-provided buffers viewed zero-copy as numpy structured arrays.
"""

import contextlib
import ctypes as ct
import fcntl
import glob
import hashlib
import os
import re
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
# Everything the port builds (the store library, its objects, the CUDA
# kernels) lands here, never next to the sources.
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# The port's own override: the JAX package's INFINISTORE_TPU_NATIVE_LIB
# is never read, so tests of both packages can share one process.
_LIB_ENV = "INFINISTORE_TPU_TORCH_NATIVE_LIB"
DEFAULT_LIB_PATH = os.path.join(BUILD_DIR, "libinfinistore_tpu.so")
_LIB_PATH = os.environ.get(_LIB_ENV, DEFAULT_LIB_PATH)
_NATIVE_DIR = os.path.abspath(os.path.join(_PKG_DIR, "..", "native"))
_SYS_URING_H = "/usr/include/linux/io_uring.h"

# numpy view of istpu::RemoteBlock (native/src/common.h).
REMOTE_BLOCK_DTYPE = np.dtype(
    [
        ("status", "<u4"),
        ("pool_idx", "<u4"),
        ("token", "<u8"),
        ("offset", "<u8"),
        ("size", "<u8"),
    ]
)

# Status codes (native/src/common.h).
OK = 200
PARTIAL = 206
BAD_REQUEST = 400
KEY_NOT_FOUND = 404
TIMEOUT_ERR = 408
CONFLICT = 409
UNCOMMITTED = 425
BUSY = 429
INTERNAL_ERROR = 500
OUT_OF_MEMORY = 507

FAKE_TOKEN = 0

CALLBACK = ct.CFUNCTYPE(None, ct.c_uint32, ct.c_void_p)

_build_lock = threading.Lock()
_lib = None


@contextlib.contextmanager
def build_lock(name):
    """Cross-process lock for one build into BUILD_DIR: pytest-xdist
    workers (and a script beside them) import the port concurrently,
    and only one of them may compile a given target at a time. Distinct
    targets (the store library, the CUDA kernels) build side by side."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".lock-{name}"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_parallel(cmds):
    """Run compiler commands side by side; raise with the output of the
    first that fails."""
    def one(cmd):
        return cmd, subprocess.run(cmd, capture_output=True, text=True)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        results = list(ex.map(one, cmds))
    for cmd, r in results:
        if r.returncode != 0:
            raise RuntimeError(
                f"build failed: {' '.join(cmd)}\n{r.stdout}{r.stderr}"
            )


def fingerprint(paths, *settings):
    """A digest of the files' contents and the build settings. A library
    is rebuilt whenever its digest changes (see :func:`is_current`)."""
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(os.path.basename(p).encode() + b"\0")
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(repr(settings).encode())
    return h.hexdigest()


def is_current(lib_path, digest):
    """Whether ``lib_path`` exists and was built with this digest."""
    try:
        with open(lib_path + ".stamp") as f:
            return f.read() == digest and os.path.exists(lib_path)
    except FileNotFoundError:
        return False


def install(tmp_path, lib_path, digest):
    """Move a fresh build into place, then record its digest."""
    os.replace(tmp_path, lib_path)
    with open(lib_path + ".stamp", "w") as f:
        f.write(digest)


def makefile_vars():
    """SRC, CXXFLAGS and LDFLAGS as native/Makefile defines them: the
    Makefile alone decides which sources make up the store library and
    how they compile. Continuation lines are joined and ``$(VAR)``
    references expanded; the first definition of a name wins, as with
    ``?=`` and no overrides."""
    path = os.path.join(_NATIVE_DIR, "Makefile")
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    defs = {}
    for line in text.splitlines():
        m = re.match(r"([A-Za-z_]+)\s*[:?]?=(.*)", line)
        if m:
            defs.setdefault(m.group(1), m.group(2).split("#")[0])

    def expand(s):
        return re.sub(r"\$\((\w+)\)",
                      lambda m: expand(defs.get(m.group(1), "")), s)

    out = {k: expand(defs.get(k, "")).split()
           for k in ("SRC", "CXXFLAGS", "LDFLAGS")}
    if not out["SRC"] or not out["CXXFLAGS"]:
        raise RuntimeError(f"{path}: no SRC or CXXFLAGS definition found")
    return out


def _uring_shim_header():
    """The machine's linux/io_uring.h with the flexible ``ops[]`` of
    struct io_uring_probe rewritten to ``ops[0]``. engine_uring.cc
    embeds io_uring_probe ahead of another member, which newer kernel
    headers (flexible array member) make a hard error under g++; a
    zero-length array keeps the layout and compiles. Where the header
    already says ops[0], the copy is identical."""
    with open(_SYS_URING_H) as f:
        text = f.read()
    return re.sub(r"struct\s+io_uring_probe_op\s+ops\[\s*\];",
                  "struct io_uring_probe_op ops[0];", text)


def build_native():
    """Build the store library into BUILD_DIR from native/ with the
    Makefile's sources and flags, plus an include dir holding the shimmed
    io_uring.h (objects in BUILD_DIR/obj). Rebuilds whenever a source, a
    header, the flags or the shimmed header change; returns the path."""
    mk = makefile_vars()
    cxx = os.environ.get("CXX", "g++")
    srcs = [os.path.join(_NATIVE_DIR, s) for s in mk["SRC"]]
    headers = glob.glob(os.path.join(_NATIVE_DIR, "src", "*.h"))
    shim_text = _uring_shim_header()
    digest = fingerprint(srcs + headers, cxx, mk, shim_text)
    with build_lock("native"):
        if is_current(DEFAULT_LIB_PATH, digest):
            return DEFAULT_LIB_PATH
        shim = os.path.join(BUILD_DIR, "include")
        os.makedirs(os.path.join(shim, "linux"), exist_ok=True)
        with open(os.path.join(shim, "linux", "io_uring.h"), "w") as f:
            f.write(shim_text)
        obj_dir = os.path.join(BUILD_DIR, "obj")
        os.makedirs(obj_dir, exist_ok=True)
        objs = [os.path.join(obj_dir, os.path.basename(s)[:-3] + ".o")
                for s in srcs]
        run_parallel([[cxx, *mk["CXXFLAGS"], "-I", shim, "-c", s, "-o", o]
                      for s, o in zip(srcs, objs)])
        tmp = DEFAULT_LIB_PATH + ".tmp"
        run_parallel([[cxx, *objs, *mk["LDFLAGS"], "-o", tmp]])
        install(tmp, DEFAULT_LIB_PATH, digest)
    return DEFAULT_LIB_PATH


def _decls(lib):
    c = ct
    decl = [
        ("ist_abi_version", c.c_uint32, []),
        ("ist_set_log_level", None, [c.c_int]),
        ("ist_log_msg", None, [c.c_int, c.c_char_p]),
        # server
        (
            "ist_server_create",
            c.c_void_p,
            [c.c_char_p, c.c_uint16, c.c_uint64, c.c_uint64, c.c_int,
             c.c_uint64, c.c_int, c.c_char_p, c.c_int, c.c_char_p,
             c.c_uint64, c.c_uint64, c.c_uint32, c.c_double, c.c_double,
             c.c_int, c.c_int, c.c_char_p, c.c_int, c.c_char_p,
             c.c_uint32],
        ),
        ("ist_server_start", c.c_int, [c.c_void_p]),
        ("ist_server_stop", None, [c.c_void_p]),
        ("ist_server_destroy", None, [c.c_void_p]),
        ("ist_server_kvmap_len", c.c_uint64, [c.c_void_p]),
        ("ist_server_purge", c.c_uint64, [c.c_void_p]),
        ("ist_server_stats", c.c_int, [c.c_void_p, c.c_char_p, c.c_int]),
        (
            "ist_server_trace",
            c.c_longlong,
            [c.c_void_p, c.c_char_p, c.c_longlong],
        ),
        # flight recorder + deep-state introspection (ABI v10)
        (
            "ist_server_events",
            c.c_longlong,
            [c.c_void_p, c.c_uint64, c.c_char_p, c.c_longlong],
        ),
        (
            "ist_server_debug_state",
            c.c_longlong,
            [c.c_void_p, c.c_char_p, c.c_longlong],
        ),
        # metrics-history ring + SLO burn verdict + client telemetry
        # (ABI v11)
        (
            "ist_server_history",
            c.c_longlong,
            [c.c_void_p, c.c_char_p, c.c_longlong],
        ),
        # workload observability plane (ABI v13)
        (
            "ist_server_workload",
            c.c_longlong,
            [c.c_void_p, c.c_char_p, c.c_longlong],
        ),
        (
            "ist_server_slo_trip",
            c.c_int,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint64],
        ),
        (
            "ist_conn_telemetry",
            None,
            [c.c_void_p, c.POINTER(c.c_uint64), c.POINTER(c.c_uint64)],
        ),
        ("ist_server_snapshot", c.c_longlong, [c.c_void_p, c.c_char_p]),
        ("ist_server_restore", c.c_longlong, [c.c_void_p, c.c_char_p]),
        # cluster robustness tier (ABI v14): range migration over the
        # snapshot codec, the shard-directory mirror, the migration
        # verdict, and the control-plane/client-side chaos eval.
        (
            "ist_server_snapshot_range",
            c.c_longlong,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint64],
        ),
        (
            "ist_server_delete_range",
            c.c_longlong,
            [c.c_void_p, c.c_uint64, c.c_uint64],
        ),
        (
            "ist_server_cluster_set",
            c.c_int,
            [c.c_void_p, c.c_uint64, c.c_char_p, c.c_longlong,
             c.c_uint64, c.c_uint64],
        ),
        (
            "ist_server_cluster",
            c.c_longlong,
            [c.c_void_p, c.c_char_p, c.c_longlong],
        ),
        (
            "ist_server_migration_trip",
            c.c_int,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint64],
        ),
        # cluster observability plane (ABI v15): replica-divergence
        # digest + the aggregator-fired cluster verdicts.
        (
            "ist_server_digest_range",
            c.c_int,
            [c.c_void_p, c.c_uint64, c.c_uint64, c.POINTER(c.c_uint64),
             c.POINTER(c.c_uint64), c.POINTER(c.c_uint64)],
        ),
        (
            "ist_server_cluster_trip",
            c.c_int,
            [c.c_void_p, c.c_int, c.c_char_p, c.c_uint64, c.c_uint64],
        ),
        ("ist_cluster_failpoint", c.c_int, [c.c_char_p]),
        ("ist_fault_arm", c.c_int, [c.c_char_p, c.c_char_p, c.c_int]),
        ("ist_server_shm_prefix", c.c_int, [c.c_void_p, c.c_char_p, c.c_int]),
        # fault injection (failpoint subsystem, ABI v8)
        (
            "ist_server_fault",
            c.c_int,
            [c.c_void_p, c.c_char_p, c.c_char_p, c.c_int],
        ),
        (
            "ist_server_fault_list",
            c.c_longlong,
            [c.c_void_p, c.c_char_p, c.c_longlong],
        ),
        # client
        (
            "ist_conn_create",
            c.c_void_p,
            [c.c_char_p, c.c_uint16, c.c_int, c.c_uint64, c.c_int,
             c.c_int, c.c_uint32, c.c_uint64, c.c_int, c.c_int],
        ),
        ("ist_conn_connect", c.c_int, [c.c_void_p]),
        ("ist_conn_close", None, [c.c_void_p]),
        ("ist_conn_destroy", None, [c.c_void_p]),
        ("ist_conn_shm_active", c.c_int, [c.c_void_p]),
        ("ist_conn_set_trace", None, [c.c_void_p, c.c_uint64]),
        ("ist_conn_broken", c.c_int, [c.c_void_p]),
        (
            "ist_reclaim_orphans",
            c.c_uint32,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_uint64)],
        ),
        ("ist_conn_block_size", c.c_uint32, [c.c_void_p]),
        ("ist_conn_inflight", c.c_uint64, [c.c_void_p]),
        (
            "ist_allocate",
            c.c_uint32,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint32, c.c_uint32,
             c.c_void_p],
        ),
        (
            "ist_allocate_async",
            c.c_uint32,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint32, c.c_uint32,
             c.c_void_p, CALLBACK, c.c_void_p],
        ),
        ("ist_sync_async", c.c_uint32, [c.c_void_p, CALLBACK, c.c_void_p]),
        (
            "ist_write_async",
            c.c_uint32,
            [c.c_void_p, c.c_uint32, c.c_uint32, c.POINTER(c.c_uint64),
             c.POINTER(c.c_void_p), CALLBACK, c.c_void_p],
        ),
        (
            "ist_put_async",
            c.c_uint32,
            [c.c_void_p, c.c_uint32, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_void_p), CALLBACK, c.c_void_p],
        ),
        (
            "ist_read_async",
            c.c_uint32,
            [c.c_void_p, c.c_uint32, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_void_p), CALLBACK, c.c_void_p],
        ),
        (
            "ist_shm_write_async",
            c.c_uint32,
            [c.c_void_p, c.c_uint32, c.c_uint32, c.c_void_p,
             c.POINTER(c.c_void_p), CALLBACK, c.c_void_p],
        ),
        (
            "ist_shm_read_async",
            c.c_uint32,
            [c.c_void_p, c.c_uint32, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_void_p), CALLBACK, c.c_void_p],
        ),
        (
            "ist_read",
            c.c_uint32,
            [c.c_void_p, c.c_uint32, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_void_p), c.c_int],
        ),
        ("ist_sync", c.c_uint32, [c.c_void_p, c.c_int]),
        # lease fast path (zero-RTT puts, deferred batched commit)
        (
            "ist_lease_put",
            c.c_uint32,
            [c.c_void_p, c.c_uint32, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_void_p)],
        ),
        ("ist_lease_flush", c.c_uint32, [c.c_void_p]),
        ("ist_lease_take_error", c.c_uint32, [c.c_void_p]),
        # one-sided fabric plane (ABI v12)
        (
            "ist_fabric_put",
            c.c_uint32,
            [c.c_void_p, c.c_uint32, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_void_p), c.c_int],
        ),
        (
            "ist_conn_fabric_telemetry",
            None,
            [c.c_void_p, c.POINTER(c.c_uint64), c.POINTER(c.c_uint64),
             c.POINTER(c.c_uint64), c.POINTER(c.c_int)],
        ),
        # ring-pool lifecycle (ABI v18): detaches / re-attaches
        (
            "ist_conn_fabric_ring_stats",
            None,
            [c.c_void_p, c.POINTER(c.c_uint64), c.POINTER(c.c_uint64)],
        ),
        # content-addressed dedup (ABI v16): hash-first two-phase put
        (
            "ist_put_hash",
            c.c_uint32,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint32, c.c_uint32,
             c.POINTER(c.c_uint64), c.c_char_p],
        ),
        (
            "ist_content_hash",
            None,
            [c.c_void_p, c.c_uint64, c.POINTER(c.c_uint64),
             c.POINTER(c.c_uint64)],
        ),
        (
            "ist_conn_dedup_telemetry",
            None,
            [c.c_void_p, c.POINTER(c.c_uint64), c.POINTER(c.c_uint64)],
        ),
        ("ist_commit", c.c_uint32, [c.c_void_p, c.POINTER(c.c_uint64), c.c_uint32]),
        (
            "ist_pin",
            c.c_uint32,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint32, c.c_void_p,
             c.POINTER(c.c_uint64)],
        ),
        ("ist_release", c.c_uint32, [c.c_void_p, c.c_uint64]),
        (
            "ist_prefetch",
            c.c_uint32,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_uint64), c.c_int],
        ),
        ("ist_abort", c.c_uint32, [c.c_void_p, c.POINTER(c.c_uint64), c.c_uint32]),
        ("ist_check_exist", c.c_int, [c.c_void_p, c.c_char_p, c.c_uint32]),
        (
            "ist_get_match_last_index",
            c.c_uint32,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_int32)],
        ),
        ("ist_client_purge", c.c_uint32, [c.c_void_p, c.POINTER(c.c_uint64)]),
        (
            "ist_delete_keys",
            c.c_uint32,
            [c.c_void_p, c.c_char_p, c.c_uint64, c.c_uint32,
             c.POINTER(c.c_uint64)],
        ),
        ("ist_client_stats", c.c_uint32, [c.c_void_p, c.c_char_p, c.c_int]),
        ("ist_sync_rpc", c.c_uint32, [c.c_void_p]),
        ("ist_pool_count", c.c_uint64, [c.c_void_p]),
        ("ist_pool_base", c.c_void_p, [c.c_void_p, c.c_uint32, c.POINTER(c.c_uint64)]),
        ("ist_refresh_pools", c.c_int, [c.c_void_p]),
        # allocator test hooks
        ("ist_mm_create", c.c_void_p, [c.c_uint64, c.c_uint64, c.c_int, c.c_uint64]),
        ("ist_mm_destroy", None, [c.c_void_p]),
        (
            "ist_mm_allocate",
            c.c_int,
            [c.c_void_p, c.c_uint64, c.POINTER(c.c_uint32), c.POINTER(c.c_uint64)],
        ),
        (
            "ist_mm_deallocate",
            c.c_int,
            [c.c_void_p, c.c_uint32, c.c_uint64, c.c_uint64],
        ),
        ("ist_mm_used_bytes", c.c_uint64, [c.c_void_p]),
        ("ist_mm_total_bytes", c.c_uint64, [c.c_void_p]),
        ("ist_mm_num_pools", c.c_uint64, [c.c_void_p]),
    ]
    # ABI probe FIRST: a stale prebuilt library would lack the v18
    # ring-pool entry point (ist_conn_fabric_ring_stats), lack the v16
    # dedup entry points (ist_put_hash / ist_content_hash /
    # ist_conn_dedup_telemetry), misparse the v16 ist_conn_create
    # trailing use_dedup flag, lack the v15
    # cluster-observability entry points (ist_server_digest_range /
    # ist_server_cluster_trip), lack the v14
    # cluster entry points (ist_server_cluster_set / ist_server_cluster
    # / ist_server_snapshot_range / ist_server_delete_range /
    # ist_server_migration_trip / ist_cluster_failpoint /
    # ist_fault_arm), lack the v13
    # workload entry point (ist_server_workload), lack the v12
    # fabric entry points (ist_fabric_put / ist_conn_fabric_telemetry),
    # misparse the v12 ist_conn_create trailing use_fabric flag, lack
    # the v11 observability entry points (ist_server_history /
    # ist_server_slo_trip / ist_conn_telemetry), misparse the v10
    # ist_server_create argument list (trailing watchdog/
    # bundle_dir/bundle_keep), lack the v10 flight-recorder entry
    # points (ist_server_events / ist_server_debug_state), misparse
    # the v9 trailing engine string, lack
    # the v8 fault entry points (ist_server_fault /
    # ist_server_fault_list), misparse the v7 promote flag, the v6
    # trace flag, the v5 reclaim watermarks, the v4 multi-worker knob
    # or the v3 ist_conn_create lease knobs, or lack the newer entry
    # points (ist_prefetch, ist_server_trace, ist_conn_set_trace)
    # entirely. A missing or old-version symbol fails loudly here
    # instead.
    try:
        lib.ist_abi_version.restype = ct.c_uint32
        lib.ist_abi_version.argtypes = []
        ver = int(lib.ist_abi_version())
    except AttributeError:
        ver = 1
    if ver < 18:
        raise RuntimeError(
            f"stale native library at {_LIB_PATH} (ABI v{ver} < v18): "
            "delete it to let the first use rebuild it"
        )
    for name, restype, argtypes in decl:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def get_lib():
    """Load (building on first use) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        if _LIB_ENV not in os.environ:
            build_native()
        elif not os.path.exists(_LIB_PATH):
            # An explicit override names a specific build variant;
            # auto-building would produce the DEFAULT library.
            raise RuntimeError(
                f"{_LIB_ENV} points at {_LIB_PATH}, which does not exist"
            )
        lib = ct.CDLL(_LIB_PATH)
        _decls(lib)
        _lib = lib
    return _lib


_NUL_MARKER = b"\xff\xff\xff\xff"


def pack_keys(keys):
    """Serialize a key list for the C ABI.

    Fast path: ONE ``str.join`` builds a NUL-separated blob tagged with
    a 0xFFFFFFFF marker (a length no wire-form first key can have); the
    C side expands it to the wire's [u32 len][bytes]* form in one
    memchr pass (capi.cc expand_keys). Measured 35 us vs 720 us for
    4096 keys — the per-key to_bytes/append loop was the largest
    Python cost in the batched read/allocate paths. Keys that embed a
    NUL (or bytes keys) fall back to the wire form, detected by a
    single C-level ``count`` over the joined blob."""
    if not isinstance(keys, (list, tuple)):
        keys = list(keys)  # generators/iterators: len + two passes
    n = len(keys)
    if n:
        try:
            blob = "\x00".join(keys).encode()
        except TypeError:
            blob = None  # bytes (or mixed) keys: wire form below
        if blob is not None and blob.count(b"\x00") == n - 1:
            return (_NUL_MARKER + n.to_bytes(4, "little") + blob)
    out = bytearray()
    for k in keys:
        kb = k.encode() if isinstance(k, str) else bytes(k)
        out += len(kb).to_bytes(4, "little")
        out += kb
    return bytes(out)


def status_name(code):
    return {
        OK: "OK",
        PARTIAL: "PARTIAL",
        BAD_REQUEST: "BAD_REQUEST",
        KEY_NOT_FOUND: "KEY_NOT_FOUND",
        TIMEOUT_ERR: "TIMEOUT",
        CONFLICT: "CONFLICT",
        UNCOMMITTED: "UNCOMMITTED",
        BUSY: "BUSY",
        INTERNAL_ERROR: "INTERNAL_ERROR",
        OUT_OF_MEMORY: "OUT_OF_MEMORY",
    }.get(code, f"STATUS_{code}")

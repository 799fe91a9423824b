"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``_build/libistpu_kernels.so``, a shared library with a plain C interface
that is loaded with ctypes (no PyTorch headers: the build takes seconds,
not minutes). Nothing happens at import: the build runs the first time a
CUDA tensor reaches a kernel, and again whenever a source, a header, the
flags or the compiler change, under a file lock of its own (so it builds
side by side with the store library), one ``nvcc`` per source side by
side.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""

import ctypes as ct
import glob
import os
import threading

from .. import _native

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
LIB_PATH = os.path.join(_native.BUILD_DIR, "libistpu_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None

_P = ct.c_void_p
_I = ct.c_int
_F = ct.c_float
# name -> argtypes of the C entry points (csrc/*.cu). D is the tensors'
# own head dim and scale the softmax scale (D ** -0.5).
_DECLS = {
    # q, k, v, out, lse (or null), is_bf16, B, Sq, Skv, H, KV, D, scale,
    # causal, window, stream
    "istpu_flash_prefill": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _F, _I, _I, _P],
    # q, k, v, dout, lse, dvec, dq, is_bf16, B, Sq, Skv, H, KV, D, scale,
    # causal, window, stream
    "istpu_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _F, _I, _I, _P],
    # q, k, v, dout, lse, dvec, dk, dv, partial (or null), splits,
    # is_bf16, B, Sq, Skv, H, KV, D, scale, causal, window, stream
    "istpu_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # q, k_pages, v_pages, page_table, seq_lens, out, ws_ml, ws_acc,
    # is_bf16, B, H, KV, D, scale, N, P, max_pages, window, row_tile,
    # n_splits, pages_per_split, stream
    "istpu_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _F, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_q, k_s, v_q, v_s, page_table, seq_lens, out, ws_ml, ws_acc,
    # is_bf16, B, H, KV, D, scale, N, P, max_pages, window, row_tile,
    # n_splits, pages_per_split, stream
    "istpu_paged_decode_q": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                             _I, _P],
    # q, k_pages, v_pages, page_table, seq_lens, out, ws_ml, ws_acc,
    # is_bf16, B, m, H, KV, D, scale, N, P, max_pages, window, row_tile,
    # n_splits, pages_per_split, stream
    "istpu_paged_verify": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build():
    """Compile csrc/*.cu into LIB_PATH unless the library there was built
    from the same sources, headers, flags and compiler; returns it."""
    nvcc = _nvcc()
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = glob.glob(os.path.join(CSRC, "*.cuh"))
    digest = _native.fingerprint(srcs + headers, nvcc, NVCC_FLAGS)
    with _native.build_lock("kernels"):
        if _native.is_current(LIB_PATH, digest):
            return LIB_PATH
        obj_dir = os.path.join(_native.BUILD_DIR, "cuda_obj")
        os.makedirs(obj_dir, exist_ok=True)
        objs = [os.path.join(obj_dir, os.path.basename(s)[:-3] + ".o")
                for s in srcs]
        _native.run_parallel([
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", s, "-o", o]
            for s, o in zip(srcs, objs)
        ])
        tmp = LIB_PATH + ".tmp"
        _native.run_parallel([[nvcc, *NVCC_FLAGS, "-shared", *objs,
                               "-o", tmp]])
        _native.install(tmp, LIB_PATH, digest)
    return LIB_PATH


def load(path):
    """Open a kernel library and declare its C entry points."""
    handle = ct.CDLL(path)
    for name, argtypes in _DECLS.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ct.c_int
    handle.istpu_error_string.argtypes = [ct.c_int]
    handle.istpu_error_string.restype = ct.c_char_p
    return handle


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


# Head dims the kernels are instantiated for: each is a compile-time
# capacity, and a kernel takes any head dim up to it (common.cuh's
# head_dim_capacity; the softmax scale comes from the wrapper).
HEAD_DIMS = (32, 64, 128, 256)


def kernel_head_dim(hd):
    """The instantiation that serves head dim ``hd``: the least of
    HEAD_DIMS at or above it."""
    return next(d for d in HEAD_DIMS if d >= hd)


def check_head_shape(hd, n_heads, n_kv, kernel):
    """The shape rule of every kernel wrapper: a head dim that is a
    multiple of 8 from 8 to 256 (a row is then whole 16-byte vectors, as
    TMA's strides and the kernels' vector loads need) and any GQA group
    (n_heads a positive multiple of n_kv). Raises ValueError."""
    if n_kv < 1 or n_heads < n_kv or n_heads % n_kv:
        raise ValueError(f"{kernel}: n_heads {n_heads} is not a positive "
                         f"multiple of n_kv {n_kv}")
    if not (8 <= hd <= HEAD_DIMS[-1] and hd % 8 == 0):
        raise ValueError(
            f"{kernel}: head_dim {hd} is not a multiple of 8 from 8 to "
            f"{HEAD_DIMS[-1]}, the head dims the CUDA kernels take (fault "
            "F1's remainder, a limit of the port)")


def softmax_scale(hd):
    """The softmax scale every kernel is given: hd ** -0.5 of the real
    head dim, as the JAX package's kernels take it."""
    return float(hd) ** -0.5


_sm_counts = {}


def sm_count(device):
    """The number of SMs of a CUDA device (a host-side property, cached;
    no device sync)."""
    count = _sm_counts.get(device)
    if count is None:
        import torch

        count = _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return count


def check(err, what):
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = lib().istpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_handle(device):
    """PyTorch's current stream on ``device`` as a ctypes pointer."""
    import torch

    return ct.c_void_p(torch.cuda.current_stream(device).cuda_stream)

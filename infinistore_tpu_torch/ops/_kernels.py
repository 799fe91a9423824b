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
# name -> argtypes of the C entry points (csrc/*.cu).
_DECLS = {
    # q, k, v, out, is_bf16, B, Sq, Skv, H, KV, D, causal, window, stream
    "istpu_flash_prefill": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P],
    # q, k_pages, v_pages, page_table, seq_lens, out, is_bf16,
    # B, H, KV, D, N, P, max_pages, window, stream
    "istpu_paged_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _P],
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


def check(err, what):
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = lib().istpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_handle(device):
    """PyTorch's current stream on ``device`` as a ctypes pointer."""
    import torch

    return ct.c_void_p(torch.cuda.current_stream(device).cuda_stream)

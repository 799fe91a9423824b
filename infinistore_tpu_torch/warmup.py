"""Warmup: prime connections and data paths with a verify round-trip
(the port of ``infinistore_tpu/warmup.py``).

Parity target: reference ``infinistore/warmup.py`` — a per-CUDA-device
local write/read/verify loop that pre-opens CUDA IPC handles and primes
CUDA contexts (warmup.py:7-49). The lazy costs here are (a) the client's
SHM pool mapping and page faults, primed by a host round trip, and (b)
the first CUDA copy between the card and the pool (the CUDA context, the
pool's ``cudaHostRegister``), primed with ``--prime-cuda`` by one
``CudaKVStore`` put/get on the card, checked byte-equal. ``--prime-cuda``
without a GPU raises: it never primes the CPU instead.

    python -m infinistore_tpu_torch.warmup --service-port 22345 --prime-cuda
"""

import argparse
import sys
import uuid

import numpy as np

from .config import ClientConfig
from .lib import InfinityConnection, Logger


def _prime_cuda(conn, size_kb):
    """One put/get of ``size_kb`` KB through a CudaKVStore on the card,
    checked byte-equal."""
    import torch

    from .cuda import CudaKVStore

    store = CudaKVStore(conn, "cuda")  # raises without a GPU
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        src = torch.randint(0, 256, (1, size_kb << 10), dtype=torch.uint8,
                            device="cuda", generator=gen)
        key = f"warmup_cuda_{uuid.uuid4()}"
        store.put_kv_pages([key], src, sync=True)
        back = store.get_kv_pages([key], (size_kb << 10,), torch.uint8)
        if not torch.equal(back, src):
            raise RuntimeError("warmup CUDA round-trip mismatch")
        conn.delete_keys([key])
    finally:
        store.close()


def warm_up(service_port=22345, host="127.0.0.1", size_kb=256,
            prime_cuda=False):
    conn = InfinityConnection(
        ClientConfig(host_addr=host, service_port=service_port)
    )
    conn.connect()
    try:
        src = np.random.default_rng(0).integers(
            0, 255, size_kb << 10, dtype=np.uint8
        )
        key = f"warmup_{uuid.uuid4()}"
        blocks = conn.allocate([key], src.nbytes)
        conn.write_cache(src, [0], src.size, blocks)
        conn.sync()
        dst = np.zeros_like(src)
        conn.read_cache(dst, [(key, 0)], src.size)
        conn.sync()
        if not np.array_equal(src, dst):
            raise RuntimeError("warmup round-trip mismatch")
        conn.delete_keys([key])
        if prime_cuda:
            _prime_cuda(conn, size_kb)
        Logger.info(
            f"warmup ok ({'SHM' if conn.shm_connected else 'STREAM'} path, "
            f"{size_kb} KB{', CUDA primed' if prime_cuda else ''})"
        )
        return True
    finally:
        conn.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--service-port", type=int, default=22345)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--size-kb", type=int, default=256)
    p.add_argument("--prime-cuda", action="store_true",
                   help="also round-trip a page between the card and the "
                        "store (raises without a GPU)")
    args = p.parse_args(argv)
    ok = warm_up(args.service_port, args.host, args.size_kb, args.prime_cuda)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

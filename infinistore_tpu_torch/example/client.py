"""Basic sync API usage (the port of ``infinistore_tpu/example/client.py``;
parity with reference example/client.py): put/get round-trips over both
paths with per-op latency printouts, then the host<->device leg through
``CudaKVStore`` on ``--device`` (the card by default; ``cpu`` runs it on
the CPU). A failed device round trip fails the example.

    python -m infinistore_tpu_torch.example.client --service-port 22345 \\
        --path shm
"""

import argparse
import time
import uuid

import numpy as np
import torch

from infinistore_tpu_torch import (
    ClientConfig,
    InfinityConnection,
    TYPE_AUTO,
    TYPE_SHM,
    TYPE_STREAM,
)
from infinistore_tpu_torch.cuda import CudaKVStore


def run(host, port, ctype, device="cuda"):
    conn = InfinityConnection(
        ClientConfig(host_addr=host, service_port=port, connection_type=ctype)
    )
    conn.connect()
    try:
        print(f"connected, path={'SHM' if conn.shm_connected else 'STREAM'}")

        page = 4096  # elements
        nblocks = 16
        src = np.random.default_rng(0).random(page * nblocks).astype(
            np.float32)
        keys = [f"example_{uuid.uuid4()}" for _ in range(nblocks)]

        t0 = time.perf_counter()
        blocks = conn.allocate(keys, page * 4)
        conn.write_cache(src, [i * page for i in range(nblocks)], page,
                         blocks)
        t_write = time.perf_counter() - t0

        t0 = time.perf_counter()
        conn.sync()
        t_sync = time.perf_counter() - t0

        dst = np.zeros_like(src)
        t0 = time.perf_counter()
        conn.read_cache(dst, [(k, i * page) for i, k in enumerate(keys)],
                        page)
        conn.sync()
        t_read = time.perf_counter() - t0

        if not np.array_equal(src, dst):
            raise RuntimeError("host round-trip mismatch")
        mb = src.nbytes / (1 << 20)
        print(
            f"write {mb:.2f} MB in {t_write*1e3:.2f} ms, "
            f"sync {t_sync*1e3:.2f} ms, read {t_read*1e3:.2f} ms"
        )

        # Device round-trip (the cpu<->gpu matrix of reference
        # example/client.py:77-85) through the CUDA device edge.
        store = CudaKVStore(conn, device)
        try:
            x = torch.from_numpy(
                np.random.default_rng(1).random((page,)).astype(np.float32)
            ).to(store.device)
            k = f"device_{uuid.uuid4()}"
            store.put_arrays([(k, x)])
            conn.sync()
            back = store.get_array(k, shape=x.shape, dtype=x.dtype)
            if not torch.equal(back, x):
                raise RuntimeError("device array round-trip mismatch")
            print(f"device array round-trip OK ({store.device})")
            keys.append(k)
        finally:
            store.close()

        conn.delete_keys(keys)
    finally:
        conn.close()


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--service-port", type=int, default=22345)
    p.add_argument("--path", choices=["auto", "shm", "stream"], default="auto")
    p.add_argument("--device", default="cuda",
                   help="device of the round trip through CudaKVStore")
    args = p.parse_args()
    run(
        args.host,
        args.service_port,
        {"auto": TYPE_AUTO, "shm": TYPE_SHM, "stream": TYPE_STREAM}[args.path],
        args.device,
    )

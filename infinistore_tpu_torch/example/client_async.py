"""Async API usage (the port of ``infinistore_tpu/example/client_async.py``;
parity with reference example/client_async.py): overlapping writes with
asyncio, one sync at the end.

    python -m infinistore_tpu_torch.example.client_async --service-port 22345
"""

import argparse
import asyncio
import uuid

import numpy as np

from infinistore_tpu_torch import ClientConfig, InfinityConnection


async def run(host, port):
    conn = InfinityConnection(
        ClientConfig(host_addr=host, service_port=port)
    )
    conn.connect()
    page = 4096
    layers = 8
    srcs = [
        np.random.default_rng(i).random(page).astype(np.float32)
        for i in range(layers)
    ]
    keys = [f"async_{uuid.uuid4()}" for _ in range(layers)]

    blocks = await conn.allocate_rdma_async(keys, page * 4)
    await asyncio.gather(
        *[
            conn.rdma_write_cache_async(srcs[i], [0], page, blocks[i : i + 1])
            for i in range(layers)
        ]
    )
    await conn.sync_async()
    print(f"wrote {layers} layers concurrently")

    for i, k in enumerate(keys):
        dst = np.zeros(page, dtype=np.float32)
        await conn.read_cache_async(dst, [(k, 0)], page)
        assert np.array_equal(dst, srcs[i])
    await conn.sync_async()
    print("verified all layers")
    conn.delete_keys(keys)
    conn.close()


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--service-port", type=int, default=22345)
    args = p.parse_args()
    asyncio.run(run(args.host, args.service_port))

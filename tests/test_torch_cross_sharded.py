"""The sharded store tier across packages: the JAX package's
``ShardedConnection`` + ``TpuKVStore`` and the port's ``ShardedConnection``
+ ``CudaKVStore`` route every key alike and read each other's pages
byte-identical over one 3-shard fleet of the port's servers.

- Routing (in this process; the routing code of both packages is pure
  Python): ``_shard_of`` (crc32 % n, ``sharded.py:99``) and the directory
  ring (``cluster.directory_ring``, replication 2, vnodes 64) give each of
  10,000 keys the same shard, and the same replica set, in both packages.
- Pages (the JAX side in a subprocess, its store library being the
  port's through ``INFINISTORE_TPU_NATIVE_LIB``, as in
  ``tests/test_torch_cross_package.py``): raw bf16 pages and int8 pages
  written by one package read back byte-equal from the other, in both
  directions, and each lies on the shard both packages route it to.
- With replication 2 a page put through either device edge lies on its
  key's primary shard only: both edges write through ``allocate`` +
  ``write_cache``, which are primary-routed (``tpu.py:273-304``). That
  is the reference's behaviour, recorded here and not changed; only the
  fused ``put_cache`` writes every replica.

Tolerance: bytes exact."""

import json
import os
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest
import torch

from infinistore_tpu import cluster as jcluster
from infinistore_tpu import sharded as jsharded
from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_STREAM, _native)
from infinistore_tpu_torch import cluster as tcluster
from infinistore_tpu_torch import cuda as tcuda
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch import sharded as tsharded
from infinistore_tpu_torch.ops import kv_quant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE_SHAPE = (8, 2, 16)   # page, kv heads, head dim
N_PAGES = 12
N_SHARDS = 3

# The JAX side: over the same fleet, reads what the port wrote and
# writes the same inputs under its own keys, through a static-hash and a
# replication-2 ShardedConnection. Arguments: one JSON object.
JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from infinistore_tpu import TYPE_STREAM, ClientConfig
    from infinistore_tpu.sharded import ShardedConnection
    from infinistore_tpu.tpu import TpuKVStore

    a = json.loads(sys.argv[1])
    cfgs = [ClientConfig(host_addr="127.0.0.1", service_port=p,
                         connection_type=TYPE_STREAM) for p in a["ports"]]
    shape = tuple(a["page_shape"])
    data = np.load(a["inputs"])
    bits = jnp.asarray(data["bf16_bits"])
    pages = jax.lax.bitcast_convert_type(bits, jnp.bfloat16)
    out = {}
    sc = ShardedConnection(cfgs)
    sc.connect()
    store = TpuKVStore(sc)
    got = store.get_kv_pages(a["port_raw"], shape, jnp.bfloat16)
    out["raw_bits"] = np.asarray(got).view(np.uint16)
    out["deq"] = np.asarray(store.get_kv_pages_quantized(
        a["port_q"], shape, jnp.float32))
    store.put_kv_pages(a["jax_raw"], pages, sync=True)
    store.put_kv_pages_quantized(a["jax_q"], jnp.asarray(data["f32"]),
                                 sync=True)
    sc.close()
    rc = ShardedConnection(cfgs, replication=2, vnodes=64)
    rc.connect()
    TpuKVStore(rc).put_kv_pages(a["jax_rep"], pages, sync=True)
    out["rep_primary"] = np.asarray([rc.shard_of(k) for k in a["jax_rep"]])
    rc.close()
    np.savez(a["outputs"], **out)
    print("JAX_SIDE_OK")
""")


# ---- routing -------------------------------------------------------------


def _routing_keys():
    """10,000 keys: the serving engine's content keys (the keys the
    store tier really routes) and uuid strings."""
    rng = np.random.default_rng(7)
    tokens = [int(t) for t in rng.integers(0, 32000, 1250 * 16)]
    digests = ts.content_page_digests(tokens, 16, 1250, "ns/p16")
    keys = [f"cp/{d}/L{li}/{kind}" for d in digests[:1000]
            for li in range(4) for kind in "kv"]
    keys += [str(uuid.UUID(bytes=rng.bytes(16))) for _ in range(2000)]
    assert len(set(keys)) == 10000
    return keys


def test_static_hash_routes_every_key_alike():
    keys = _routing_keys()
    for n in (2, 3, 4):
        j = [jsharded._shard_of(k, n) for k in keys]
        t = [tsharded._shard_of(k, n) for k in keys]
        assert j == t
        assert len(set(t)) == n


def test_directory_ring_routes_every_key_alike():
    keys = _routing_keys()
    shards = [{"id": i, "host": "127.0.0.1", "service_port": 1 + i}
              for i in range(N_SHARDS)]
    jring = jcluster.directory_ring(jcluster.build_directory(
        shards, vnodes=64, replication=2))
    tring = tcluster.directory_ring(tcluster.build_directory(
        shards, vnodes=64, replication=2))
    j = [tuple(jring.replica_set(k)) for k in keys]
    t = [tuple(tring.replica_set(k)) for k in keys]
    assert j == t
    assert all(len(set(r)) == 2 for r in t)
    assert len({r[0] for r in t}) == N_SHARDS
    assert [jcluster.ring_hash(k) for k in keys[:500]] == \
        [tcluster.ring_hash(k) for k in keys[:500]]


# ---- pages over one fleet --------------------------------------------------


@pytest.fixture(scope="module")
def fleet():
    servers = [InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.03125, minimal_allocate_size=16))
        for _ in range(N_SHARDS)]
    for s in servers:
        s.start()
    yield servers
    for s in servers:
        s.stop()


def _configs(fleet):
    return [ClientConfig(host_addr="127.0.0.1", service_port=s.service_port,
                         connection_type=TYPE_STREAM) for s in fleet]


def _keys(tag):
    return [f"xshard/{tag}/{uuid.uuid4().hex}/p{i}" for i in range(N_PAGES)]


def _holders(fleet, keys):
    """For each key, the fleet indices of the servers holding it."""
    conns = []
    try:
        for s in fleet:
            c = InfinityConnection(ClientConfig(
                host_addr="127.0.0.1", service_port=s.service_port,
                connection_type=TYPE_STREAM))
            c.connect()
            conns.append(c)
        return [[i for i, c in enumerate(conns) if c.check_exist(k)]
                for k in keys]
    finally:
        for c in conns:
            c.close()


@pytest.fixture(scope="module")
def exchange(fleet, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xshard")
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((N_PAGES, *PAGE_SHAPE)).astype(np.float32)
    bf16 = torch.from_numpy(f32).to(torch.bfloat16)
    bits = bf16.view(torch.int16).numpy().view(np.uint16)
    np.savez(tmp / "inputs.npz", f32=f32, bf16_bits=bits)
    keys = {k: _keys(k) for k in ("port_raw", "port_q", "jax_raw", "jax_q",
                                  "port_rep", "jax_rep")}
    sc = tsharded.ShardedConnection(_configs(fleet))
    sc.connect()
    rc = tsharded.ShardedConnection(_configs(fleet), replication=2,
                                    vnodes=64)
    rc.connect()
    store = tcuda.CudaKVStore(sc, device="cpu")
    try:
        store.put_kv_pages(keys["port_raw"], bf16, sync=True)
        store.put_kv_pages_quantized(keys["port_q"], torch.from_numpy(f32),
                                     sync=True)
        tcuda.CudaKVStore(rc, device="cpu").put_kv_pages(
            keys["port_rep"], bf16, sync=True)
        args = dict(ports=[s.service_port for s in fleet],
                    page_shape=PAGE_SHAPE, inputs=str(tmp / "inputs.npz"),
                    outputs=str(tmp / "outputs.npz"), **keys)
        env = dict(os.environ)
        env["INFINISTORE_TPU_NATIVE_LIB"] = _native.build_native()
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        r = subprocess.run([sys.executable, "-c", JAX_SIDE,
                            json.dumps(args)], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0 and "JAX_SIDE_OK" in r.stdout, \
            r.stdout + r.stderr
        jax_saw = dict(np.load(tmp / "outputs.npz"))
        port_saw = dict(
            raw=store.get_kv_pages(keys["jax_raw"], PAGE_SHAPE,
                                   torch.bfloat16),
            q_raw=store.get_kv_pages_quantized_raw(keys["jax_q"],
                                                   PAGE_SHAPE),
            deq=store.get_kv_pages_quantized(keys["jax_q"], PAGE_SHAPE,
                                             torch.float32),
            rep_primary=[rc.shard_of(k) for k in keys["jax_rep"]])
        yield dict(f32=f32, bits=bits, keys=keys, jax=jax_saw,
                   port=port_saw)
    finally:
        store.close()
        sc.close()
        rc.close()


def test_raw_pages_cross_byte_equal_over_shards(exchange, fleet):
    """bf16 pages over 3 shards: the port's bytes as the JAX client reads
    them, and the JAX client's bytes as the port reads them, equal to the
    input bits; each page lies on the one shard crc32 % 3 names."""
    np.testing.assert_array_equal(exchange["jax"]["raw_bits"],
                                  exchange["bits"])
    got = exchange["port"]["raw"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, exchange["bits"])
    for tag in ("port_raw", "jax_raw"):
        keys = exchange["keys"][tag]
        want = [[jsharded._shard_of(k, N_SHARDS)] for k in keys]
        assert _holders(fleet, keys) == want
        assert len({w[0] for w in want}) > 1


def test_int8_pages_cross_byte_equal_over_shards(exchange):
    """int8 pages over 3 shards: what the JAX client packed unpacks, on
    the port, to the port's own quantization of the same pages (int8
    values and f32 scales bit-equal); what the port packed dequantizes,
    on the JAX side, to the port's own dequantization."""
    q, scales = kv_quant.quantize_kv_pages(torch.from_numpy(exchange["f32"]))
    q_got, s_got = exchange["port"]["q_raw"]
    assert torch.equal(q_got, q)
    assert torch.equal(s_got.view(torch.int32), scales.view(torch.int32))
    deq = kv_quant.dequantize_kv_pages(q, scales, torch.float32)
    assert torch.equal(exchange["port"]["deq"], deq)
    np.testing.assert_array_equal(exchange["jax"]["deq"].view(np.uint32),
                                  deq.numpy().view(np.uint32))


def test_replicated_fleet_pages_lie_on_the_primary_only(exchange, fleet):
    """Replication 2: a page put through either device edge lies on its
    key's primary shard and on no replica, and both packages name the
    same primary."""
    jax_primary = exchange["jax"]["rep_primary"].tolist()
    assert jax_primary == exchange["port"]["rep_primary"]
    ring = tcluster.directory_ring(tcluster.build_directory(
        [{"id": i} for i in range(N_SHARDS)], vnodes=64, replication=2))
    for tag in ("port_rep", "jax_rep"):
        keys = exchange["keys"][tag]
        sets = [ring.replica_set(k) for k in keys]
        assert all(len(s) == 2 for s in sets)
        assert _holders(fleet, keys) == [[s[0]] for s in sets]
    assert [ring.replica_set(k)[0]
            for k in exchange["keys"]["jax_rep"]] == jax_primary

"""Pages one package writes read back byte-identical from the other,
through each package's own client, on one server of the port's.

The JAX side runs in a subprocess: its ``TpuKVStore`` loads the port's
store library through ``INFINISTORE_TPU_NATIVE_LIB`` (read when the JAX
package's ``_native`` is imported, so the override never reaches this
process or another test file). Legs, on SHM and on STREAM:

- raw pages: ``TpuKVStore.put_kv_pages`` -> ``CudaKVStore.get_kv_pages``
  and back, bf16 bit patterns equal;
- int8 pages: ``TpuKVStore.put_kv_pages_quantized`` ->
  ``CudaKVStore.get_kv_pages_quantized`` (and ``_raw``) and back, the int8
  values, scales and dequantized pages equal to each package's own;
- MoE serving: the JAX MoE engine (float32) offloads turn 1 under an
  explicit ``model_id``; the port's MoE engine hits those pages on turn 2
  and emits the tokens of the JAX engine.

Beside them, two device-edge paths of the port: ``CudaKVStore.prefetch``
and the layer streamer's non-blocking ``submit``."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import uuid

import jax
import numpy as np
import pytest
import torch

from infinistore_tpu.models import moe as jm
from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM, TYPE_STREAM, _native)
from infinistore_tpu_torch import cuda as tcuda
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.models import moe as tm
from infinistore_tpu_torch.ops import kv_quant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE_SHAPE = (8, 2, 16)   # page, kv heads, head dim
N_PAGES = 6
MODEL_ID = "xpkg-moe"
MOE_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=64, n_experts=4, top_k=2, max_seq=128,
               page_size=8, capacity_factor=4.0, dtype="float32")
MOE_SEED = 21

# The JAX side: reads the pages the port wrote, writes its own, and runs
# the MoE engine's turn 1 (through the store) and turn 2 (store-less, the
# reference tokens). Arguments: one JSON object.
JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from infinistore_tpu import ClientConfig, InfinityConnection
    from infinistore_tpu import serving as js
    from infinistore_tpu.models import moe
    from infinistore_tpu.tpu import TpuKVStore

    a = json.loads(sys.argv[1])
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=a["port"],
        connection_type=a["ctype"]))
    conn.connect()
    assert conn.shm_connected == (a["ctype"] == "SHM")
    store = TpuKVStore(conn)
    shape = tuple(a["page_shape"])
    data = np.load(a["inputs"])
    out = {}
    # Read what the port wrote.
    got = store.get_kv_pages(a["port_raw"], shape, jnp.bfloat16)
    out["raw_bits"] = np.asarray(got).view(np.uint16)
    out["deq"] = np.asarray(store.get_kv_pages_quantized(
        a["port_q"], shape, jnp.float32))
    # Write the same inputs under this package's keys.
    bits = jnp.asarray(data["bf16_bits"])
    store.put_kv_pages(a["jax_raw"],
                       jax.lax.bitcast_convert_type(bits, jnp.bfloat16),
                       sync=True)
    store.put_kv_pages_quantized(a["jax_q"], jnp.asarray(data["f32"]),
                                 sync=True)
    # MoE serving: turn 1 through the store, turn 2 store-less.
    cfg = moe.MoEConfig(**a["moe_cfg"])
    params = moe.init_params(jax.random.PRNGKey(a["moe_seed"]), cfg)
    sc = js.ServingConfig(model_id=a["model_id"])
    eng = js.ServingEngine(params, cfg, sc, store=store, model=moe)
    out1 = eng.run([js.Request("t1", a["turn1"], max_new_tokens=8)])["t1"]
    assert eng.stats["offloaded_pages"] > 0, eng.stats
    convo = a["turn1"] + out1
    page = cfg.page_size
    turn2 = convo[: (len(convo) // page) * page] + a["extra"]
    ref = js.ServingEngine(params, cfg, sc, model=moe).run(
        [js.Request("t2", turn2, max_new_tokens=6)])["t2"]
    out["turn2"] = np.asarray(turn2)
    out["tokens2"] = np.asarray(ref)
    out["ns"] = np.frombuffer(eng._ns.encode(), np.uint8)
    np.savez(a["outputs"], **out)
    conn.close()
    print("JAX_SIDE_OK")
""")


@pytest.fixture(scope="module")
def port_server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=16,
    ))
    srv.start()
    yield srv
    srv.stop()


def _connect(port, ctype):
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=port, connection_type=ctype))
    conn.connect()
    return conn


def _keys(tag):
    return [f"xpkg/{tag}/{uuid.uuid4().hex}/p{i}" for i in range(N_PAGES)]


@pytest.fixture(scope="module", params=[TYPE_SHM, TYPE_STREAM])
def exchange(request, port_server, tmp_path_factory):
    """One round trip on one transport: the port writes, the JAX side
    reads and writes, the port reads. Returns everything both saw."""
    ctype = request.param
    tmp = tmp_path_factory.mktemp(f"xpkg_{ctype}")
    rng = np.random.default_rng(0 if ctype == TYPE_SHM else 1)
    f32 = rng.standard_normal((N_PAGES, *PAGE_SHAPE)).astype(np.float32)
    bf16 = torch.from_numpy(f32).to(torch.bfloat16)
    bits = bf16.view(torch.int16).numpy().view(np.uint16)
    np.savez(tmp / "inputs.npz", f32=f32, bf16_bits=bits)
    keys = {k: _keys(f"{ctype}/{k}") for k in ("port_raw", "port_q",
                                                "jax_raw", "jax_q")}
    conn = _connect(port_server.service_port, ctype)
    assert conn.shm_connected == (ctype == TYPE_SHM)
    store = tcuda.CudaKVStore(conn, device="cpu")
    try:
        store.put_kv_pages(keys["port_raw"], bf16, sync=True)
        store.put_kv_pages_quantized(keys["port_q"], torch.from_numpy(f32),
                                     sync=True)
        rng_t = np.random.default_rng(2)
        turn1 = [int(t) for t in rng_t.integers(0, MOE_CFG["vocab_size"],
                                                16)]
        extra = [int(t) for t in rng_t.integers(0, MOE_CFG["vocab_size"],
                                                5)]
        args = dict(port=port_server.service_port, ctype=ctype,
                    page_shape=PAGE_SHAPE, inputs=str(tmp / "inputs.npz"),
                    outputs=str(tmp / "outputs.npz"), moe_cfg=MOE_CFG,
                    moe_seed=MOE_SEED, model_id=MODEL_ID, turn1=turn1,
                    extra=extra, **keys)
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
                                             torch.float32))
        yield dict(ctype=ctype, f32=f32, bf16=bf16, bits=bits, jax=jax_saw,
                   port=port_saw, port_server=port_server)
    finally:
        store.close()
        conn.close()


def test_raw_pages_cross_byte_equal(exchange):
    """bf16 pages: the port's bytes as the JAX client reads them, and the
    JAX client's bytes as the port reads them, equal to the input bits."""
    np.testing.assert_array_equal(exchange["jax"]["raw_bits"],
                                  exchange["bits"])
    got = exchange["port"]["raw"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, exchange["bits"])


def test_int8_pages_cross_byte_equal(exchange):
    """int8 pages: what the JAX client packed unpacks, on the port, to the
    port's own quantization of the same pages (int8 values and f32
    scales bit-equal) and dequantizes equally; what the port packed
    dequantizes, on the JAX side, to the port's own dequantization."""
    q, scales = kv_quant.quantize_kv_pages(torch.from_numpy(exchange["f32"]))
    q_got, s_got = exchange["port"]["q_raw"]
    assert torch.equal(q_got, q)
    assert torch.equal(s_got.view(torch.int32), scales.view(torch.int32))
    deq = kv_quant.dequantize_kv_pages(q, scales, torch.float32)
    assert torch.equal(exchange["port"]["deq"], deq)
    np.testing.assert_array_equal(exchange["jax"]["deq"].view(np.uint32),
                                  deq.numpy().view(np.uint32))


def test_port_moe_engine_hits_the_jax_engines_pages(exchange):
    """The JAX MoE engine offloaded turn 1 under MODEL_ID; the port's MoE
    engine, on the same weights, restores those pages for turn 2 (a
    prefix hit) and emits the JAX engine's turn-2 tokens."""
    jcfg = jm.MoEConfig(**MOE_CFG)
    jparams = jm.init_params(jax.random.PRNGKey(MOE_SEED), jcfg)
    tparams = tl.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jparams),
                                 device="cpu")
    tcfg = tm.MoEConfig(**MOE_CFG)
    conn = _connect(exchange["port_server"].service_port, exchange["ctype"])
    store = tcuda.CudaKVStore(conn, device="cpu")
    try:
        eng = ts.ServingEngine(tparams, tcfg,
                               ts.ServingConfig(model_id=MODEL_ID),
                               store=store, model=tm, device="cpu")
        assert eng._ns == bytes(exchange["jax"]["ns"]).decode()
        turn2 = [int(t) for t in exchange["jax"]["turn2"]]
        out = eng.run([ts.Request("t2", turn2, max_new_tokens=6)])["t2"]
        assert eng.stats["prefix_hit_pages"] > 0
        assert eng.stats["restored_pages"] > 0
        assert out == [int(t) for t in exchange["jax"]["tokens2"]]
    finally:
        store.close()
        conn.close()


# ---- device-edge paths ---------------------------------------------------


class _NoPrefetchConn:
    shm_connected = False


class _FailingPrefetchConn(_NoPrefetchConn):
    def prefetch(self, keys):
        raise ConnectionError("store down")


def test_prefetch_is_advisory(port_server):
    """CudaKVStore.prefetch issues OP_PREFETCH on a live connection (True;
    the keys are pool-resident, and the read that follows is unchanged)
    and never raises: False for no keys, a connection without prefetch,
    or one whose prefetch fails."""
    conn = _connect(port_server.service_port, TYPE_SHM)
    store = tcuda.CudaKVStore(conn, device="cpu")
    try:
        keys = _keys("prefetch")
        pages = torch.randn(N_PAGES, *PAGE_SHAPE)
        store.put_kv_pages(keys, pages, sync=True)
        assert store.prefetch(keys) is True
        counts = conn.prefetch(keys, wait=True)
        assert counts["resident"] == N_PAGES and counts["missing"] == 0
        assert store.prefetch([]) is False
        assert torch.equal(store.get_kv_pages(keys, PAGE_SHAPE,
                                              torch.float32), pages)
    finally:
        store.close()
        conn.close()
    for stub in (_NoPrefetchConn(), _FailingPrefetchConn()):
        assert tcuda.CudaKVStore(stub, device="cpu").prefetch(["k"]) is False


class _StallingConn:
    """A connection whose allocate blocks until released: submit must
    return while the previous layer's upload has not even started."""

    shm_connected = False

    def __init__(self):
        self.release = threading.Event()
        self.uploaded = []
        self.synced = 0

    def allocate(self, keys, nbytes):
        self.release.wait(10)
        return {"keys": list(keys)}

    def _write_async_native(self, flat, offsets, size, blocks, cb):
        self.uploaded.extend(blocks["keys"])
        cb(_native.OK)

    def sync(self):
        self.synced += 1


def test_layer_streamer_submit_never_blocks():
    stub = _StallingConn()
    with tcuda.LayerStreamer(stub) as streamer:
        a = torch.from_numpy(np.random.default_rng(3).random(128)
                             .astype(np.float32))
        t0 = time.perf_counter()
        for key in ("l0", "l1", "l2"):
            streamer.submit(key, a)
        elapsed = time.perf_counter() - t0
        # The store is stalled in l0's allocate, yet every submit
        # returned and nothing has been written.
        assert elapsed < 1.0
        assert stub.uploaded == []
        stub.release.set()
        streamer.finish()
        assert stub.uploaded == ["l0", "l1", "l2"]
        assert stub.synced == 1

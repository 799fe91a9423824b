"""The port's device edge (``infinistore_tpu_torch.cuda``) against the
port's own server, on both data paths, with CPU tensors (the same code
paths the card takes, with memcpys in place of DMAs)."""

import os
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch import (
    ClientConfig,
    InfiniStoreServer,
    InfinityConnection,
    ServerConfig,
    TYPE_SHM,
    TYPE_STREAM,
)
from infinistore_tpu_torch import cuda as tcuda
from infinistore_tpu_torch.models import llama as tl


@pytest.fixture(scope="module")
def port_server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.125, minimal_allocate_size=16,
        auto_increase=True, extend_size=0.0625,
    ))
    srv.start()
    yield srv
    srv.stop()


def _connect(server, ctype):
    c = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=server.service_port,
        connection_type=ctype,
    ))
    c.connect()
    return c


@pytest.fixture(params=[TYPE_SHM, TYPE_STREAM])
def conn(port_server, request):
    c = _connect(port_server, request.param)
    yield c
    c.close()


@pytest.fixture
def store(conn):
    s = tcuda.CudaKVStore(conn, device="cpu")
    yield s
    s.close()


def _keys(n):
    base = uuid.uuid4()
    return [f"{base}/p{i}" for i in range(n)]


def _bf16(rng, *shape):
    bits = rng.integers(0, 1 << 16, shape, dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0  # no inf/NaN patterns
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def test_bf16_pages_round_trip_byte_for_byte(store):
    rng = np.random.default_rng(0)
    pages = _bf16(rng, 6, 16, 2, 32)
    keys = _keys(6)
    store.put_kv_pages(keys, pages, sync=True)
    back = store.get_kv_pages(keys, (16, 2, 32), torch.bfloat16)
    assert torch.equal(back.view(torch.int16), pages.view(torch.int16))
    host = store.get_kv_pages_host(keys[2:4], (16, 2, 32), torch.bfloat16)
    assert torch.equal(host.view(torch.int16), pages[2:4].view(torch.int16))
    one = _bf16(rng, 128)
    store.put_arrays([(keys[0] + "/a", one)], sync=True)
    got = store.get_array(keys[0] + "/a", (128,), torch.bfloat16)
    assert torch.equal(got.view(torch.int16), one.view(torch.int16))
    assert store.cached_prefix_len(keys + _keys(2)) == 6


def test_shm_put_makes_no_staging_copy(port_server):
    conn = _connect(port_server, TYPE_SHM)
    store = tcuda.CudaKVStore(conn, device="cpu")
    try:
        tcuda.reset_copy_counters()
        keys = _keys(8)
        pages = _bf16(np.random.default_rng(1), 8, 16, 2, 32)
        store.put_kv_pages(keys, pages)  # no sync: committed on return
        assert tcuda.copy_counters["staging_copies"] == 0
        assert store.cached_prefix_len(keys) == 8
    finally:
        store.close()
        conn.close()


def test_failed_write_aborts_uncommitted_blocks(store, monkeypatch):
    """A write failure after allocate rolls the tokens back, so the keys
    are usable again (uncommitted tokens would dedup-poison them)."""
    keys = _keys(3)
    pages = torch.from_numpy(
        np.random.default_rng(2).random((3, 8, 4)).astype(np.float32))

    def boom(*a, **kw):
        raise ConnectionError("injected write failure")

    monkeypatch.setattr(store, "_write_pages", boom)
    with pytest.raises(ConnectionError):
        store.put_kv_pages(keys, pages)
    monkeypatch.undo()
    assert store.cached_prefix_len(keys) == 0
    store.put_kv_pages(keys, pages, sync=True)
    assert torch.equal(store.get_kv_pages(keys, (8, 4), torch.float32),
                       pages)


def test_layer_streamer_uploads_every_layer(conn):
    rng = np.random.default_rng(3)
    layers = [_bf16(rng, 4, 16, 2, 32) for _ in range(3)]
    keys = [_keys(4) for _ in layers]
    single = _bf16(rng, 256)
    single_key = _keys(1)[0]
    with tcuda.LayerStreamer(conn) as streamer:
        for k, p in zip(keys, layers):
            streamer.submit_pages(k, p)
        streamer.submit(single_key, single)
        streamer.finish()
    store = tcuda.CudaKVStore(conn, device="cpu")
    for k, p in zip(keys, layers):
        got = store.get_kv_pages(k, (16, 2, 32), torch.bfloat16)
        assert torch.equal(got.view(torch.int16), p.view(torch.int16))
    got = store.get_array(single_key, (256,), torch.bfloat16)
    assert torch.equal(got.view(torch.int16), single.view(torch.int16))


def test_jax_and_port_pages_are_the_same_bytes(port_server):
    """Both packages cut the same KV into the same page bytes under the
    same keys: a page the port writes is the page the JAX package would
    have written."""
    cfg = tl.LlamaConfig(n_kv_heads=2, d_model=64, n_heads=2, page_size=8)
    rng = np.random.default_rng(4)
    k_bits = _bf16(rng, 1, 19, 2, 32)
    v_bits = _bf16(rng, 1, 19, 2, 32)
    jk = jnp.asarray(k_bits.view(torch.int16).numpy().view(np.uint16)
                     ).view(jnp.bfloat16)
    jv = jnp.asarray(v_bits.view(torch.int16).numpy().view(np.uint16)
                     ).view(jnp.bfloat16)
    jkp, _ = jl.kv_to_pages(cfg, jk, jv)
    want = np.asarray(jkp).view(np.uint16).reshape(-1).view(np.uint8)
    tkp, _ = tl.kv_to_pages(cfg, k_bits, v_bits)
    seq = f"x_{uuid.uuid4()}"
    keys = tl.page_keys(seq, 0, "k", tkp.shape[1])
    assert keys == jl.page_keys(seq, 0, "k", tkp.shape[1])

    conn = _connect(port_server, TYPE_SHM)
    try:
        store = tcuda.CudaKVStore(conn, device="cpu")
        store.put_kv_pages(keys, tkp[0], sync=True)
        raw = np.empty(want.size, dtype=np.uint8)
        page_bytes = cfg.kv_page_bytes()
        conn.read_cache(raw, [(k, i * page_bytes) for i, k in
                              enumerate(keys)], page_bytes)
        conn.sync()
        np.testing.assert_array_equal(raw, want)
    finally:
        conn.close()


def test_prefix_cache_hit_flow_through_store(port_server):
    """Prefill a prefix, page it out; a second request restores it and
    prefills only its suffix, landing on the full prefill's logits
    (the JAX package's test_prefix_cache_hit_flow, on the port)."""
    cfg = tl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128, max_seq=64, page_size=8,
                         dtype="float32")
    params = tl.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(5)
    p_len, s_new = 16, 8
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, p_len + s_new)))
    conn = _connect(port_server, TYPE_SHM)
    store = tcuda.CudaKVStore(conn, device="cpu")
    try:
        seq = f"pfx_{uuid.uuid4()}"
        _, kvs = tl.prefill(params, cfg, tokens[:, :p_len])
        n_pages = p_len // cfg.page_size
        for li, (k, v) in enumerate(kvs):
            kp, vp = tl.kv_to_pages(cfg, k, v)
            store.put_kv_pages(tl.page_keys(seq, li, "k", n_pages), kp[0])
            store.put_kv_pages(tl.page_keys(seq, li, "v", n_pages), vp[0])
        hit = store.cached_prefix_len(tl.page_keys(seq, 0, "k", 3))
        assert hit == n_pages
        prefix_kvs = tl.restore_prefix_kvs(store, cfg, seq, hit)
        tail, _ = tl.prefill_with_prefix(params, cfg, tokens[:, p_len:],
                                         prefix_kvs)
        full, _ = tl.prefill(params, cfg, tokens)
        np.testing.assert_allclose(tail.numpy(), full[:, p_len:].numpy(),
                                   rtol=2e-4, atol=2e-4)
    finally:
        store.close()
        conn.close()


def test_store_build_follows_the_makefile_and_its_sources(tmp_path):
    # The port compiles exactly native/Makefile's SRC with its flags...
    from infinistore_tpu_torch import _native

    mk = _native.makefile_vars()
    with open(os.path.join(_native._NATIVE_DIR, "Makefile")) as f:
        makefile = f.read()
    assert "src/capi.cc" in mk["SRC"] and len(mk["SRC"]) > 10
    for src in mk["SRC"]:
        assert src in makefile
        assert os.path.exists(os.path.join(_native._NATIVE_DIR, src))
    assert {"-Werror", "-std=c++17", "-fPIC"} <= set(mk["CXXFLAGS"])
    assert "-shared" in mk["LDFLAGS"]
    # ...and a library counts as current only for the digest it was
    # built with: any change to a source or a setting rebuilds it.
    src, lib = tmp_path / "a.cc", tmp_path / "lib.so"
    src.write_text("int f() { return 1; }\n")
    digest = _native.fingerprint([str(src)], "g++", ["-O2"])
    assert not _native.is_current(str(lib), digest)
    tmp = tmp_path / "lib.so.tmp"
    tmp.write_bytes(b"\x7fELF")
    _native.install(str(tmp), str(lib), digest)
    assert _native.is_current(str(lib), digest)
    assert _native.fingerprint([str(src)], "g++", ["-O3"]) != digest
    src.write_text("int f() { return 2; }\n")
    assert not _native.is_current(
        str(lib), _native.fingerprint([str(src)], "g++", ["-O2"]))

"""The port's int8 slice against the JAX package on the same numpy inputs:
KV-page quantization and its wire format, the quantized store methods
(bytes across packages, both data paths, against the port's own server),
K4's plain version against the Pallas kernel in interpret mode, the CPU
dispatcher against the JAX package's off-TPU route, and int8 weights
(``quantize_params`` and the quantized model's logits).

Tolerances: the quantizers are bit-identical. float32 attention differs
only in summation order (2e-5; the model's 2e-4 as in
``test_torch_llama.py``). At bf16 the outputs are rounded to bf16 from
float32 folds that sum in another order, so they may differ by one bf16
step of the output (2**-8 relative): 1e-2 relative and absolute."""

import dataclasses
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import llama as jl
from infinistore_tpu.ops import kv_quant as jq
from infinistore_tpu.ops import pallas_paged_attention as jpp
from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM, TYPE_STREAM)
from infinistore_tpu_torch import cuda as tcuda
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.ops import kv_quant as tq
from infinistore_tpu_torch.ops import paged_flash_decode_q as pq

TOL = 2e-5        # f32 attention: summation order only
TOL_MODEL = 2e-4  # f32 model logits, as test_torch_llama.py
TOL_BF16 = 1e-2   # one bf16 step of the output
PAGE_SHAPE = (16, 4, 64)


def _pages(rng, n, page_shape=PAGE_SHAPE):
    """Normal values whose (token, head) rows vary in scale, as KV does."""
    shape = (n, *page_shape)
    return (rng.standard_normal(shape)
            * np.exp(rng.standard_normal(shape[:-1] + (1,)))
            ).astype(np.float32)


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


def _bits(a):
    """Array bytes for exact comparison (bf16 as its 16 bits)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---- quantize / dequantize / pack ----------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_bit_identical_to_jax(dtype):
    jx, tx = _both(_pages(np.random.default_rng(0), 12), dtype)
    j_q, j_s = jq.quantize_kv_pages(jx)
    t_q, t_s = tq.quantize_kv_pages(tx)
    assert t_q.dtype == torch.int8 and t_s.dtype == torch.float32
    np.testing.assert_array_equal(t_q.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(t_s.numpy().view(np.uint32),
                                  np.asarray(j_s).view(np.uint32))
    for out in ("float32", "bfloat16"):
        j_back = jq.dequantize_kv_pages(j_q, j_s, jnp.dtype(out))
        t_back = tq.dequantize_kv_pages(t_q, t_s, getattr(torch, out))
        np.testing.assert_array_equal(_bits(t_back), _bits(j_back))
    # Half a quantization step of the row's absmax at most.
    x = tx.float().numpy()
    err = np.abs(tq.dequantize_kv_pages(t_q, t_s, torch.float32).numpy() - x)
    assert (err <= np.abs(x).max(-1, keepdims=True) / 127 * 0.5 + 1e-6).all()


def test_zero_pages_quantize_to_zero():
    z = torch.zeros(2, 4, 2, 32)
    q, s = tq.quantize_kv_pages(z)
    assert (s == 1e-8).all() and not q.any()
    back = tq.dequantize_kv_pages(q, s, torch.float32)
    assert torch.equal(back, z)
    j_q, j_s = jq.quantize_kv_pages(jnp.zeros((2, 4, 2, 32)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))


def test_device_and_host_pack_match_jax_bytes():
    rng = np.random.default_rng(1)
    jx, tx = _both(_pages(rng, 5), "bfloat16")
    want = jq.pack_pages_host(*jq.quantize_kv_pages(jx))
    t_q, t_s = tq.quantize_kv_pages(tx)
    block = tq.packed_page_bytes(PAGE_SHAPE)
    assert block == jq.packed_page_bytes(PAGE_SHAPE)
    assert tq.packed_page_bytes((16, 8, 128)) == 16896  # Llama-3.1-8B
    dev = tq.pack_pages(t_q, t_s)
    assert dev.dtype == torch.uint8 and dev.shape == (5, block)
    np.testing.assert_array_equal(dev.numpy(), want)
    np.testing.assert_array_equal(tq.pack_pages_host(t_q.numpy(),
                                                     t_s.numpy()), want)
    for q, s in (tq.unpack_pages(dev, PAGE_SHAPE),
                 tq.unpack_pages_host(want, PAGE_SHAPE)):
        q, s = torch.as_tensor(q), torch.as_tensor(s)
        assert torch.equal(q, t_q) and torch.equal(s, t_s)


# ---- the quantized store methods -------------------------------------------


@pytest.fixture(scope="module")
def port_server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.125, minimal_allocate_size=16,
    ))
    srv.start()
    yield srv
    srv.stop()


def _connect(server, ctype):
    c = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=server.service_port,
        connection_type=ctype))
    c.connect()
    return c


def _keys(n):
    base = uuid.uuid4()
    return [f"q8/{base}/p{i}" for i in range(n)]


@pytest.mark.parametrize("ctype", [TYPE_SHM, TYPE_STREAM])
def test_quantized_store_round_trip(port_server, ctype):
    conn = _connect(port_server, ctype)
    store = tcuda.CudaKVStore(conn, device="cpu")
    try:
        pages = torch.from_numpy(_pages(np.random.default_rng(2), 6)).to(
            torch.bfloat16)
        keys = _keys(6)
        tcuda.reset_copy_counters()
        blocks = store.put_kv_pages_quantized(keys, pages, sync=True)
        assert len(blocks) == 6
        if ctype == TYPE_SHM:
            assert tcuda.copy_counters["staging_copies"] == 0
        back = store.get_kv_pages_quantized(keys, PAGE_SHAPE, torch.bfloat16)
        assert back.dtype == torch.bfloat16 and back.shape == pages.shape
        a, b = pages.float(), back.float()
        assert ((a - b).norm() / a.norm()).item() < 0.012
        q, s = store.get_kv_pages_quantized_raw(keys[1:4], PAGE_SHAPE)
        t_q, t_s = tq.quantize_kv_pages(pages[1:4])
        assert torch.equal(q, t_q) and torch.equal(s, t_s)
        assert q.is_contiguous() and s.is_contiguous()
        block = tq.packed_page_bytes(PAGE_SHAPE)
        assert block < 0.55 * pages[0].numel() * 2
        # The raw bytes under the keys are blocks of exactly that size.
        raw = np.empty(block, dtype=np.uint8)
        conn.read_cache(raw, [(keys[0], 0)], block)
        conn.sync()
        assert store.get_kv_pages_quantized([], PAGE_SHAPE,
                                            torch.bfloat16).shape[0] == 0
    finally:
        store.close()
        conn.close()


def test_failed_quantized_write_aborts_uncommitted(port_server, monkeypatch):
    conn = _connect(port_server, TYPE_SHM)
    store = tcuda.CudaKVStore(conn, device="cpu")
    try:
        keys = _keys(3)
        pages = torch.from_numpy(_pages(np.random.default_rng(3), 3))

        def boom(*a, **kw):
            raise ConnectionError("injected write failure")

        monkeypatch.setattr(store, "_write_pages", boom)
        with pytest.raises(ConnectionError):
            store.put_kv_pages_quantized(keys, pages)
        monkeypatch.undo()
        assert store.cached_prefix_len(keys) == 0
        store.put_kv_pages_quantized(keys, pages, sync=True)
        assert store.cached_prefix_len(keys) == 3
    finally:
        store.close()
        conn.close()


@pytest.mark.parametrize("ctype", [TYPE_SHM, TYPE_STREAM])
def test_int8_page_bytes_cross_packages(port_server, ctype):
    """The port's packed pages are the JAX package's bytes under the same
    keys, and JAX-packed bytes restore through the port to JAX's
    dequantized pages, bit for bit."""
    rng = np.random.default_rng(4)
    x = _pages(rng, 4)
    jx, tx = _both(x, "bfloat16")
    j_q, j_s = jq.quantize_kv_pages(jx)
    want = jq.pack_pages_host(j_q, j_s)
    block = want.shape[1]
    conn = _connect(port_server, ctype)
    store = tcuda.CudaKVStore(conn, device="cpu")
    try:
        keys = _keys(4)
        store.put_kv_pages_quantized(keys, tx, sync=True)
        raw = np.empty(want.size, dtype=np.uint8)
        conn.read_cache(raw, [(k, i * block) for i, k in enumerate(keys)],
                        block)
        conn.sync()
        np.testing.assert_array_equal(raw.reshape(want.shape), want)

        keys2 = _keys(4)
        store.put_kv_pages(keys2, torch.from_numpy(want), sync=True)
        got = store.get_kv_pages_quantized(keys2, PAGE_SHAPE, torch.bfloat16)
        np.testing.assert_array_equal(
            _bits(got), _bits(jq.dequantize_kv_pages(j_q, j_s,
                                                     jnp.bfloat16)))
    finally:
        store.close()
        conn.close()


# ---- restores of strided blocks: one copy per run ---------------------------


def _blocks(offsets, pools=None, fake=()):
    from infinistore_tpu_torch._native import FAKE_TOKEN, REMOTE_BLOCK_DTYPE

    b = np.zeros(len(offsets), dtype=REMOTE_BLOCK_DTYPE)
    b["offset"] = offsets
    b["pool_idx"] = 0 if pools is None else pools
    b["token"] = 1
    b["token"][list(fake)] = FAKE_TOKEN
    return b


def test_runs_join_blocks_at_a_constant_stride():
    """_runs: a read joins consecutive blocks of one pool at a constant
    stride of up to twice the page (an int8 page in a larger block) into
    one run; a write joins only blocks back to back (it must not write
    into the gaps)."""
    page, block = 16896, 20480  # Llama-3.1-8B's int8 page, 5 x 4 KB
    offs = [4096 + i * block for i in range(8)]
    assert tcuda._runs(_blocks(offs), page, False, strided=True) == [
        (0, 8, 0, 4096, block)]
    assert tcuda._runs(_blocks(offs), page, False) == [
        (i, 1, 0, o, page) for i, o in enumerate(offs)]
    # Back to back, both ways; a stride past twice the page is not joined.
    tight = [i * page for i in range(4)]
    for strided in (False, True):
        assert tcuda._runs(_blocks(tight), page, False, strided) == [
            (0, 4, 0, 0, page)]
    wide = [i * 2 * page + i for i in range(3)]
    assert len(tcuda._runs(_blocks(wide), page, False, True)) == 3
    # A run ends where the stride, the pool or the order changes.
    mixed = [0, block, 2 * block, 2 * block + page, 2 * block + 2 * page,
             0, block, 9 * block]
    pools = [0, 0, 0, 0, 0, 1, 1, 1]
    assert tcuda._runs(_blocks(mixed, pools), page, False, True) == [
        (0, 3, 0, 0, block), (3, 2, 0, 2 * block + page, page),
        (5, 2, 1, 0, block), (7, 1, 1, 9 * block, page)]
    # FAKE blocks are skipped on writes: the run breaks around them.
    assert tcuda._runs(_blocks(tight, fake=[1]), page, True) == [
        (0, 1, 0, 0, page), (2, 2, 0, 2 * page, page)]


def test_int8_restore_of_strided_blocks_round_trips(monkeypatch):
    """Int8 pages at Llama-3.1-8B's geometry in a store of 4 KB units
    (each 16896-byte page in a 20 KB block) restore byte-equal through
    the port's server on SHM, in one copy of each run's span."""
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=4))
    srv.start()
    conn = _connect(srv, TYPE_SHM)
    store = tcuda.CudaKVStore(conn, device="cpu")
    seen = []
    real = tcuda._runs

    def spy(blocks, page_bytes, skip_fake, strided=False):
        runs = real(blocks, page_bytes, skip_fake, strided)
        if strided:
            seen.append(runs)
        return runs

    monkeypatch.setattr(tcuda, "_runs", spy)
    try:
        shape = (16, 8, 128)
        pages = torch.from_numpy(_pages(np.random.default_rng(7), 24,
                                        shape)).to(torch.bfloat16)
        keys = _keys(24)
        store.put_kv_pages_quantized(keys, pages, sync=True)
        q, s = store.get_kv_pages_quantized_raw(keys, shape)
        t_q, t_s = tq.quantize_kv_pages(pages)
        assert torch.equal(q, t_q) and torch.equal(s, t_s)
        (runs,) = seen
        assert sum(r[1] for r in runs) == 24 and len(runs) < 24
        assert any(r[1] > 1 and r[4] == 20480 for r in runs)
        # Out of order, the same bytes.
        order = [5, 4, 3, 20, 21, 22, 0]
        q, s = store.get_kv_pages_quantized_raw([keys[i] for i in order],
                                                shape)
        assert torch.equal(q, t_q[order]) and torch.equal(s, t_s[order])
    finally:
        store.close()
        conn.close()
        srv.stop()


# ---- K4's plain version and the dispatcher ---------------------------------


def _q8_inputs(seed, dtype, n_heads, n_kv, seq_lens, window_pad=False,
               hd=64):
    """q, int8 k/v pages with their scales, a shuffled table (padded with
    -1 and past-the-pool ids when ``window_pad``) and seq_lens, as numpy
    arrays (q in ``dtype`` through JAX)."""
    rng = np.random.default_rng(seed)
    batch, page, n_pages, max_pages = len(seq_lens), 16, 24, 6
    q = rng.standard_normal((batch, n_heads, hd)).astype(np.float32)
    k_q, k_s = jq.quantize_kv_pages(jnp.asarray(
        _pages(rng, n_pages, (page, n_kv, hd))))
    v_q, v_s = jq.quantize_kv_pages(jnp.asarray(
        _pages(rng, n_pages, (page, n_kv, hd))))
    table = rng.permutation(n_pages)[:batch * max_pages].reshape(
        batch, max_pages).astype(np.int32)
    if window_pad:
        for b, sl in enumerate(seq_lens):
            used = -(-sl // page)
            table[b, used:] = np.where(np.arange(max_pages - used) % 2,
                                       n_pages + 5, -1)
    jq_ = jnp.asarray(q).astype(getattr(jnp, dtype))
    arrays = [np.array(a) for a in (k_q, k_s, v_q, v_s)]
    return jq_, arrays, table, np.asarray(seq_lens, np.int32)


def _torch_args(jq_, arrays, table, sl):
    q = torch.from_numpy(np.array(jq_.astype(jnp.float32))).to(
        torch.bfloat16 if jq_.dtype == jnp.bfloat16 else torch.float32)
    return [q] + [torch.from_numpy(a) for a in (*arrays, table, sl)]


Q8_CASES = {
    # (dtype, n_heads, n_kv, seq_lens, window, padded table, hd)
    "f32_8_4": ("float32", 8, 4, [5, 37, 96], 0, False, 64),
    "f32_4_1": ("float32", 4, 1, [5, 37, 96], 0, False, 64),
    "bf16_8_2": ("bfloat16", 8, 2, [5, 37, 96], 0, False, 64),
    "f32_window16_padded": ("float32", 8, 2, [1, 16, 33, 90], 16, True, 64),
    "bf16_window16_padded": ("bfloat16", 8, 4, [17, 40, 64], 16, True, 64),
    # Shapes the CUDA routes take since hd 256 and any group.
    "f32_12_2_group6": ("float32", 12, 2, [5, 37, 96], 0, False, 32),
    "f32_7_1_group7_window": ("float32", 7, 1, [1, 33, 90], 16, True, 32),
    "bf16_16_1_group16": ("bfloat16", 16, 1, [5, 37, 96], 0, False, 32),
    "f32_4_2_hd256": ("float32", 4, 2, [5, 37, 96], 0, False, 256),
}


@pytest.mark.parametrize("case", list(Q8_CASES))
def test_plain_matches_pallas_kernel(case):
    dtype, n_heads, n_kv, lens, window, pad, hd = Q8_CASES[case]
    jq_, arrays, table, sl = _q8_inputs(len(case), dtype, n_heads, n_kv,
                                        lens, pad, hd)
    want = jpp.paged_flash_decode_quantized(
        jq_, *map(jnp.asarray, (*arrays, table, sl)), interpret=True,
        window=window)
    args = _torch_args(jq_, arrays, table, sl)
    got = pq.paged_decode_quantized_plain(*args, window=window)
    assert got.dtype == args[0].dtype
    tol = TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", list(Q8_CASES))
def test_cpu_dispatcher_matches_jax_fallback(case):
    dtype, n_heads, n_kv, lens, window, pad, hd = Q8_CASES[case]
    jq_, arrays, table, sl = _q8_inputs(len(case) + 1, dtype, n_heads, n_kv,
                                        lens, pad, hd)
    want = jpp.decode_attention_quantized(
        jq_, *map(jnp.asarray, (*arrays, table, sl)), window=window)
    args = _torch_args(jq_, arrays, table, sl)
    launches = pq.launches
    got = pq.decode_attention_quantized(*args, window=window)
    assert pq.launches == launches
    tol = 1e-5 if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    plain = pq.paged_decode_quantized_plain(*args, window=window)
    if dtype == "float32":  # the two CPU routes agree at f32
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                                   atol=TOL)


# ---- int8 weights ----------------------------------------------------------


JCFG = jl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=128, max_seq=64, page_size=8,
                      dtype="float32")


def _tcfg(jcfg):
    return tl.LlamaConfig(**dataclasses.asdict(jcfg))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a).view(np.uint16)
        if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_matches_jax(dtype):
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tl.params_from_jax(_numpy_tree(jparams), device="cpu")
    j_q = jl.quantize_params(jparams, jcfg)
    t_q = tl.quantize_params(tparams, _tcfg(jcfg))
    j_leaves = jax.tree_util.tree_leaves_with_path(j_q)
    t_leaves = tl.param_leaves(t_q)
    assert len(j_leaves) == len(t_leaves)
    for (path, a), b in zip(j_leaves, t_leaves):
        assert str(b.dtype).replace("torch.", "") == np.asarray(a).dtype.name
        np.testing.assert_array_equal(_bits(b), _bits(a),
                                      err_msg=jax.tree_util.keystr(path))
    assert tl.param_bytes(t_q) == jl.param_bytes(j_q)
    assert tl.param_bytes(t_q) < tl.param_bytes(tparams) / (
        3 if dtype == "float32" else 1.5)
    # The quantized tree crosses from JAX leaf for leaf.
    carried = tl.params_from_jax(_numpy_tree(j_q), device="cpu")
    for a, b in zip(tl.param_leaves(carried), t_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_quantized_model_logits_match_jax():
    """prefill, decode_step and verify_step on the quantized tree against
    the JAX model on the same quantized tree."""
    jparams = jl.quantize_params(jl.init_params(jax.random.PRNGKey(1), JCFG),
                                 JCFG)
    tcfg = _tcfg(JCFG)
    tparams = tl.params_from_jax(_numpy_tree(jparams), device="cpu")
    rng = np.random.default_rng(5)
    batch, s = 2, 19
    tokens = rng.integers(0, JCFG.vocab_size, (batch, s)).astype(np.int32)
    j_lg, j_kvs = jl.prefill(jparams, JCFG, jnp.asarray(tokens))
    t_lg, _ = tl.prefill(tparams, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg),
                               rtol=TOL_MODEL, atol=TOL_MODEL)

    n_pages, max_pages = 16, 5
    shape = (JCFG.n_layers, n_pages, *JCFG.kv_page_shape())
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    table = 1 + np.arange(batch * max_pages, dtype=np.int32).reshape(
        batch, max_pages)
    for li, (k, v) in enumerate(j_kvs):
        pk, pv = jl.kv_to_pages(JCFG, k, v)
        for b in range(batch):
            kp[li, table[b, :pk.shape[1]]] = np.asarray(pk[b])
            vp[li, table[b, :pv.shape[1]]] = np.asarray(pv[b])
    lens = np.full(batch, s, np.int32)
    token = rng.integers(0, JCFG.vocab_size, batch).astype(np.int32)
    j_dl, j_kp, j_vp = jl.decode_step(
        jparams, JCFG, jnp.asarray(token), jnp.asarray(lens), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table))
    t_kp, t_vp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_dl, t_kp, t_vp = tl.decode_step(
        tparams, tcfg, torch.from_numpy(token), torch.from_numpy(lens), t_kp,
        t_vp, torch.from_numpy(table))
    np.testing.assert_allclose(t_dl.numpy(), np.asarray(j_dl),
                               rtol=TOL_MODEL, atol=TOL_MODEL)

    m = 3
    vtok = rng.integers(0, JCFG.vocab_size, (batch, m)).astype(np.int32)
    lens = lens + 1
    j_vl, _, _ = jl.verify_step(jparams, JCFG, jnp.asarray(vtok),
                                jnp.asarray(lens), j_kp, j_vp,
                                jnp.asarray(table))
    t_vl, _, _ = tl.verify_step(tparams, tcfg, torch.from_numpy(vtok),
                                torch.from_numpy(lens), t_kp, t_vp,
                                torch.from_numpy(table))
    np.testing.assert_allclose(t_vl.numpy(), np.asarray(j_vl),
                               rtol=TOL_MODEL, atol=TOL_MODEL)


def test_embed_quantization_is_per_row():
    """A token whose embedding is 100x smaller than the loudest rows
    still dequantizes to int8 precision: the row is the unit."""
    cfg = tl.LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                         n_kv_heads=2, d_ff=64, max_seq=64, page_size=8,
                         dtype="float32")
    params = tl.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params["embed"][7] *= 0.01
    q = tl.quantize_params(params, cfg)
    assert q["embed"]["scale"].shape == (cfg.vocab_size,)
    toks = torch.tensor([[7]])
    ef = tl._embed(params, toks)
    eq = tl._embed(q, toks)
    assert ((eq - ef).abs().max() / ef.abs().max()).item() < 0.02


def test_init_params_quantized_is_int8_and_serves():
    """Direct int8 init: bytes about one per parameter, the same leaves
    as quantize_params, and an engine serves from it."""
    cfg = tl.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128, max_seq=128, page_size=8,
                         dtype="float32")
    qp = tl.init_params_quantized(torch.Generator().manual_seed(1), cfg,
                                  device="cpu")
    dense = tl.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    ref = tl.quantize_params(dense, cfg)
    assert [(t.shape, t.dtype) for t in tl.param_leaves(qp)] == \
        [(t.shape, t.dtype) for t in tl.param_leaves(ref)]
    n_params = sum(t.numel() for t in tl.param_leaves(qp)
                   if t.dtype == torch.int8)
    assert tl.param_bytes(qp) < 1.2 * n_params
    assert int(qp["layers"][0]["wq"]["int8"].min()) >= -127
    eng = ts.ServingEngine(qp, cfg, ts.ServingConfig(
        max_slots=2, total_pages=32, max_pages_per_seq=12), device="cpu")
    toks = []
    eng.submit(ts.Request("q", list(range(10)), max_new_tokens=5,
                          on_token=lambda r, t: toks.append(int(t))))
    eng.run([])
    assert len(toks) == 5
    with pytest.raises(TypeError, match="int8"):
        tl.trainable(qp)

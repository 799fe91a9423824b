"""The port's Llama against the JAX package's, on the same weights
(``params_from_jax``) and the same numpy tokens: prefill, prefix prefill,
three paged decode steps and a ragged verify step, logits and KV.
float32; the 2e-4
tolerance is the JAX package's own for its dense-vs-paged identities
(summation order through 2 layers and a 256-wide vocab projection)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch.models import llama as tl

TOL = 2e-4


def _cfgs(variant):
    jcfg = dataclasses.replace(_tiny_cfg(), dtype="float32")
    if variant == "window_rope_scaling":
        jcfg = dataclasses.replace(jcfg, window=12,
                                   rope_scaling=(8.0, 1.0, 4.0, 32))
    return jcfg, tl.LlamaConfig(**dataclasses.asdict(jcfg))


def _jax_params_numpy(jparams):
    def conv(x):
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(conv, jparams)


def test_params_from_jax_keeps_every_bf16_bit():
    jcfg = _tiny_cfg()  # bfloat16
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tl.params_from_jax(_jax_params_numpy(jparams), device="cpu")
    assert tparams["layers"][1]["wq"].dtype == torch.bfloat16
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        bits = np.asarray(leaf).view(np.uint16)
        np.testing.assert_array_equal(
            node.view(torch.int16).numpy().view(np.uint16), bits)


@pytest.mark.parametrize("variant", ["tiny", "window_rope_scaling"])
def test_prefill_prefix_and_decode_match_jax(variant):
    jcfg, tcfg = _cfgs(variant)
    jparams = jl.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = tl.params_from_jax(_jax_params_numpy(jparams), device="cpu")
    rng = np.random.default_rng(11)
    batch, s, p_len = 2, 19, 8  # 19: not a page multiple
    tokens = rng.integers(0, jcfg.vocab_size, (batch, s)).astype(np.int32)

    # Dense prefill: logits and per-layer KV.
    j_logits, j_kvs = jl.prefill(jparams, jcfg, jnp.asarray(tokens))
    t_logits, t_kvs = tl.prefill(tparams, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=TOL, atol=TOL)
    for (jk, jv), (tk, tv) in zip(j_kvs, t_kvs):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL,
                                   atol=TOL)

    # Suffix prefill over the first p_len tokens' KV.
    j_pre = [(k[:, :p_len], v[:, :p_len]) for k, v in j_kvs]
    t_pre = [(k[:, :p_len], v[:, :p_len]) for k, v in t_kvs]
    j_tail, _ = jl.prefill_with_prefix(jparams, jcfg,
                                       jnp.asarray(tokens[:, p_len:]), j_pre)
    t_tail, _ = tl.prefill_with_prefix(tparams, tcfg,
                                       torch.from_numpy(tokens[:, p_len:]),
                                       t_pre)
    np.testing.assert_allclose(t_tail.numpy(), np.asarray(j_tail),
                               rtol=TOL, atol=TOL)

    # Three decode steps over paged KV built from the dense prefill.
    n_pages, max_pages = 16, 5
    shape = (jcfg.n_layers, n_pages, *jcfg.kv_page_shape())
    kp = np.zeros(shape, np.float32)
    vp = np.zeros(shape, np.float32)
    table = np.arange(batch * max_pages, dtype=np.int32).reshape(
        batch, max_pages)
    used = -(-s // jcfg.page_size)
    for li, (k, v) in enumerate(j_kvs):
        pk, pv = jl.kv_to_pages(jcfg, k, v)
        for b in range(batch):
            kp[li, table[b, :used]] = np.asarray(pk[b])
            vp[li, table[b, :used]] = np.asarray(pv[b])
    j_kp, j_vp = jnp.asarray(kp), jnp.asarray(vp)
    t_kp, t_vp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    seq_lens = np.full(batch, s, np.int32)
    token = rng.integers(0, jcfg.vocab_size, batch).astype(np.int32)
    for _ in range(3):
        j_lg, j_kp, j_vp = jl.decode_step(
            jparams, jcfg, jnp.asarray(token), jnp.asarray(seq_lens), j_kp,
            j_vp, jnp.asarray(table))
        t_lg, t_kp, t_vp = tl.decode_step(
            tparams, tcfg, torch.from_numpy(token),
            torch.from_numpy(seq_lens), t_kp, t_vp, torch.from_numpy(table))
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg),
                                   rtol=TOL, atol=TOL)
        token = np.asarray(j_lg).argmax(-1).astype(np.int32)
        seq_lens = seq_lens + 1
    np.testing.assert_allclose(t_kp.numpy(), np.asarray(j_kp), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(t_vp.numpy(), np.asarray(j_vp), rtol=TOL,
                               atol=TOL)


def test_page_helpers_round_trip_and_prefix_identity():
    """kv_to_pages -> pages_to_kv is lossless, and a suffix prefill over
    the paged-and-restored prefix lands on the full prefill's logits
    (the identity the prefix-cache hit rests on)."""
    _, tcfg = _cfgs("tiny")
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(gen, tcfg, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, tcfg.vocab_size, (1, 24)))
    p_len = 16
    full, _ = tl.prefill(params, tcfg, tokens)
    _, kvs = tl.prefill(params, tcfg, tokens[:, :p_len])
    restored = []
    for k, v in kvs:
        kp, vp = tl.kv_to_pages(tcfg, k, v)
        assert kp.shape == (1, p_len // tcfg.page_size, *tcfg.kv_page_shape())
        rk, rv = tl.pages_to_kv(tcfg, kp, vp, p_len)
        assert torch.equal(rk, k) and torch.equal(rv, v)
        restored.append((rk, rv))
    tail, _ = tl.prefill_with_prefix(params, tcfg, tokens[:, p_len:],
                                     restored)
    np.testing.assert_allclose(tail.numpy(), full[:, p_len:].numpy(),
                               rtol=TOL, atol=TOL)


def _paged_prefill(jcfg, j_kvs, table, n_pages):
    """Pools [L, n_pages, page, kv, hd] holding the prefill KV of each
    row at its table's pages (page 0, the scratch page, is in no row)."""
    shape = (jcfg.n_layers, n_pages, *jcfg.kv_page_shape())
    kp = np.zeros(shape, np.float32)
    vp = np.zeros(shape, np.float32)
    for li, (k, v) in enumerate(j_kvs):
        pk, pv = jl.kv_to_pages(jcfg, k, v)
        for b in range(table.shape[0]):
            kp[li, table[b, :pk.shape[1]]] = np.asarray(pk[b])
            vp[li, table[b, :pv.shape[1]]] = np.asarray(pv[b])
    return kp, vp


@pytest.mark.parametrize("variant", ["tiny", "window_rope_scaling"])
def test_verify_step_matches_jax(variant):
    """verify_step over a ragged batch (valid_len 3 and 2 of m = 3): the
    logits at every position and every page of the pools, scratch page
    included, against the JAX verify_step."""
    jcfg, tcfg = _cfgs(variant)
    jparams = jl.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = tl.params_from_jax(_jax_params_numpy(jparams), device="cpu")
    rng = np.random.default_rng(12)
    s, m = 13, 3
    tokens = rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    step = rng.integers(0, jcfg.vocab_size, (2, m)).astype(np.int32)
    _, j_kvs = jl.prefill(jparams, jcfg, jnp.asarray(tokens))
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    kp, vp = _paged_prefill(jcfg, j_kvs, table, n_pages=10)
    seq_lens = np.array([s, s - 2], np.int32)
    valid = np.array([3, 2], np.int32)
    j_lg, j_kp, j_vp = jl.verify_step(
        jparams, jcfg, jnp.asarray(step), jnp.asarray(seq_lens),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(valid))
    t_kp, t_vp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_lg, t_kp2, t_vp2 = tl.verify_step(
        tparams, tcfg, torch.from_numpy(step), torch.from_numpy(seq_lens),
        t_kp, t_vp, torch.from_numpy(table), torch.from_numpy(valid))
    assert t_kp2 is t_kp and t_vp2 is t_vp  # updated in place
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(t_kp.numpy(), np.asarray(j_kp), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(t_vp.numpy(), np.asarray(j_vp), rtol=TOL,
                               atol=TOL)


def test_verify_step_equals_sequential_decode():
    """The identity speculative decoding rests on (the JAX package's
    test_verify_step_equals_sequential_decode): m verify tokens give the
    logits and pages of m single decode steps."""
    _, tcfg = _cfgs("tiny")
    params = tl.init_params(torch.Generator().manual_seed(3), tcfg,
                            device="cpu")
    rng = np.random.default_rng(7)
    s, m = 12, 3
    tokens = torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, (2, s)).astype(np.int32))
    step = torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, (2, m)).astype(np.int32))
    _, kvs = tl.prefill(params, tcfg, tokens)
    # Row 0 owns pages 0-3, row 1 pages 4-7.
    table = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    shape = (tcfg.n_layers, 8, *tcfg.kv_page_shape())
    k_pages, v_pages = torch.zeros(shape), torch.zeros(shape)
    for li, (k, v) in enumerate(kvs):
        kp, vp = tl.kv_to_pages(tcfg, k, v)
        for b in range(2):
            k_pages[li, table[b, :kp.shape[1]].long()] = kp[b]
            v_pages[li, table[b, :vp.shape[1]].long()] = vp[b]
    seq_lens = torch.full((2,), s, dtype=torch.int32)
    ks, vs = k_pages.clone(), v_pages.clone()
    seq_logits = []
    for j in range(m):
        lg, ks, vs = tl.decode_step(params, tcfg, step[:, j], seq_lens + j,
                                    ks, vs, table)
        seq_logits.append(lg)
    ver, kv2, vv2 = tl.verify_step(params, tcfg, step, seq_lens, k_pages,
                                   v_pages, table)
    for j in range(m):
        np.testing.assert_allclose(ver[:, j].numpy(),
                                   seq_logits[j].numpy(), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(kv2.numpy(), ks.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vv2.numpy(), vs.numpy(), rtol=TOL, atol=TOL)

"""The port's plain attention ops (the CPU path and the oracle of the CUDA
kernels) against the JAX package: the Pallas kernels in interpret mode
and the XLA ops, on the same numpy inputs. float32 throughout, so the
tolerance (2e-5) covers only summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.ops import paged_attention as jpa
from infinistore_tpu.ops.pallas_flash_attention import (
    flash_prefill_attention as jax_flash,
)
from infinistore_tpu.ops.pallas_paged_attention import (
    paged_flash_decode as jax_paged_decode,
)
from infinistore_tpu_torch.ops import flash_attention as fa
from infinistore_tpu_torch.ops import paged_attention as tpa
from infinistore_tpu_torch.ops import paged_flash_decode as pd

TOL = 2e-5  # f32: summation order only


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "s_q,s_kv,heads,kv_heads,hd,window",
    [
        (40, 40, 4, 4, 32, 0),    # MHA (group 1), length not a multiple of 16
        (24, 70, 4, 2, 32, 0),    # group 2, suffix over a 46-token prefix
        (50, 50, 8, 2, 64, 16),   # group 4, sliding window
        (33, 81, 8, 2, 32, 20),   # group 4, prefix + window
    ],
)
def test_prefill_plain_matches_jax(s_q, s_kv, heads, kv_heads, hd, window):
    rng = np.random.default_rng(s_q * 1000 + s_kv)
    q = _np(rng, 2, s_q, heads, hd)
    k = _np(rng, 2, s_kv, kv_heads, hd)
    v = _np(rng, 2, s_kv, kv_heads, hd)
    got = tpa.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                window=window).numpy()
    want_pallas = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       interpret=True, window=window))
    want_xla = np.asarray(jpa.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window))
    np.testing.assert_allclose(got, want_pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_xla, rtol=TOL, atol=TOL)
    # The dispatcher takes the plain version for CPU tensors.
    launches = fa.launches
    via = fa.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), window=window)
    assert torch.equal(via, torch.from_numpy(got))
    assert fa.launches == launches


def test_prefill_rejects_kv_shorter_than_q():
    q = torch.zeros(1, 8, 2, 32)
    kv = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="kv_len >= q_len"):
        tpa.prefill_attention(q, kv, kv)
    with pytest.raises(ValueError, match="kv_len >= q_len"):
        fa.flash_prefill(q, kv, kv)


def _decode_inputs(seed, batch, heads, kv_heads, hd, n_pages, page,
                   max_pages, seq_lens):
    rng = np.random.default_rng(seed)
    q = _np(rng, batch, heads, hd)
    kp = _np(rng, n_pages, page, kv_heads, hd)
    vp = _np(rng, n_pages, page, kv_heads, hd)
    table = np.empty((batch, max_pages), dtype=np.int32)
    perm = rng.permutation(n_pages)
    for b, sl in enumerate(seq_lens):
        used = -(-sl // page)
        table[b, :used] = perm[b * max_pages:b * max_pages + used]
        # Padding past the used pages: negative and past-the-pool ids.
        table[b, used:] = np.where(np.arange(max_pages - used) % 2, -1,
                                   n_pages + 3)
    return q, kp, vp, table, np.asarray(seq_lens, dtype=np.int32)


@pytest.mark.parametrize(
    "heads,kv_heads,hd,window,seq_lens",
    [
        (4, 2, 32, 0, [8, 16, 17, 1]),     # page boundaries, group 2
        (8, 2, 64, 5, [24, 9, 40, 3]),     # group 4, sliding window
    ],
)
def test_decode_plain_matches_pallas(heads, kv_heads, hd, window, seq_lens):
    q, kp, vp, table, sl = _decode_inputs(
        7, len(seq_lens), heads, kv_heads, hd, n_pages=40, page=8,
        max_pages=6, seq_lens=seq_lens)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(sl), window=window).numpy()
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(sl), interpret=True, window=window))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    launches = pd.launches
    via = pd.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(sl), window=window)
    assert torch.equal(via, torch.from_numpy(got))
    assert pd.launches == launches


def test_scatters_match_jax_drop_mode():
    """Out-of-range targets are dropped and negative ones wrap, exactly
    as JAX's mode="drop" scatter does."""
    rng = np.random.default_rng(3)
    pages = _np(rng, 5, 4, 2, 8)
    one = _np(rng, 4, 1, 2, 8)
    pg = np.array([1, 7, -1, 3], dtype=np.int32)   # 7 dropped, -1 wraps
    slot = np.array([0, 2, 3, 9], dtype=np.int32)  # slot 9 dropped
    want = np.asarray(jpa.scatter_kv_to_pages(
        jnp.asarray(pages), jnp.asarray(one), jnp.asarray(pg),
        jnp.asarray(slot)))
    got = tpa.scatter_kv_to_pages(
        torch.from_numpy(pages.copy()), torch.from_numpy(one),
        torch.from_numpy(pg), torch.from_numpy(slot)).numpy()
    np.testing.assert_array_equal(got, want)

    multi = _np(rng, 2, 3, 2, 8)
    pg2 = np.array([[0, 4, 5], [-6, 2, 2]], dtype=np.int32)
    slot2 = np.array([[1, 3, 0], [0, -1, 1]], dtype=np.int32)
    want2 = np.asarray(jpa.scatter_kv_multi(
        jnp.asarray(pages), jnp.asarray(multi), jnp.asarray(pg2),
        jnp.asarray(slot2)))
    got2 = tpa.scatter_kv_multi(
        torch.from_numpy(pages.copy()), torch.from_numpy(multi),
        torch.from_numpy(pg2), torch.from_numpy(slot2)).numpy()
    np.testing.assert_array_equal(got2, want2)


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers take CUDA tensors only, and the
    dispatchers refuse devices that are neither CPU nor CUDA."""
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_prefill_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        pd.paged_flash_decode(torch.zeros(1, 2, 32), torch.zeros(4, 8, 2, 32),
                              torch.zeros(4, 8, 2, 32),
                              torch.zeros(1, 2, dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32))
    meta = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_prefill(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        pd.decode_attention(torch.empty(1, 2, 32, device="meta"), None,
                            None, None, None)

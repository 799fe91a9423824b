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
from infinistore_tpu.ops.pallas_paged_attention import (
    paged_flash_verify as jax_paged_verify,
)
from infinistore_tpu_torch.ops import flash_attention as fa
from infinistore_tpu_torch.ops import paged_attention as tpa
from infinistore_tpu_torch.ops import paged_flash_decode as pd
from infinistore_tpu_torch.ops import paged_flash_verify as pv

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
        # Shapes the CUDA routes take since hd 256 and any group.
        (12, 2, 32, 0, [5, 30, 17]),       # group 6 (Qwen2-1.5B's)
        (7, 1, 32, 3, [24, 9, 40, 3]),     # group 7, sliding window
        (16, 1, 32, 0, [8, 16, 17, 1]),    # group 16 (Llama-3.1-405B's)
        (4, 2, 256, 0, [8, 16, 17, 1]),    # hd 256 (Gemma's)
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


def _verify_inputs(seed, m, heads, kv_heads, hd, page, n_pages, max_pages,
                   seq_lens, pad):
    """Random q and pages, and a table of distinct shuffled ids; with
    ``pad``, the entries past the pages a row uses (up to seq_len + m)
    are -1 and n_pages + 5 in turn."""
    rng = np.random.default_rng(seed)
    batch = len(seq_lens)
    q = _np(rng, batch, m, heads, hd)
    kp = _np(rng, n_pages, page, kv_heads, hd)
    vp = _np(rng, n_pages, page, kv_heads, hd)
    table = rng.permutation(n_pages)[:batch * max_pages].reshape(
        batch, max_pages).astype(np.int32)
    if pad:
        for b, sl in enumerate(seq_lens):
            used = min(-(-(sl + m) // page), max_pages)
            table[b, used:] = np.where(np.arange(max_pages - used) % 2,
                                       n_pages + 5, -1)
    return q, kp, vp, table, np.asarray(seq_lens, dtype=np.int32)


@pytest.mark.parametrize(
    "m,heads,kv_heads,hd,page,max_pages,seq_lens,window,pad",
    [
        # the shapes of the JAX package's verify kernel tests
        (4, 8, 8, 128, 16, 4, [7, 40], 0, False),     # MHA
        (3, 8, 2, 128, 16, 4, [16, 50], 0, False),    # GQA 4:1, odd m
        (5, 4, 2, 64, 8, 4, [20], 0, False),          # group 2, hd 64
        (2, 16, 4, 32, 8, 4, [1, 15, 29], 0, False),  # group 4, hd 32
        (1, 8, 4, 128, 16, 4, [33], 0, False),        # m = 1: decode
        # empty cache, and a chunk spanning several pages
        (12, 4, 2, 64, 8, 4, [0, 5], 0, False),
        (3, 4, 2, 64, 8, 4, [21, 13], 12, False),     # sliding window
        (4, 8, 2, 32, 8, 6, [3, 17, 30], 0, True),    # -1 / N+5 padding
        (6, 4, 2, 32, 8, 3, [4, 21], 0, False),       # 21 + 6 > 24
        # Shapes the CUDA routes take since hd 256 and any group.
        (3, 7, 1, 64, 8, 4, [5, 20], 0, False),       # group 7
        (2, 12, 2, 32, 8, 4, [9, 14], 0, True),       # group 6, padding
        (2, 16, 1, 32, 8, 4, [3, 11], 5, False),      # group 16, window
        (3, 2, 2, 256, 8, 4, [7, 19], 0, False),      # hd 256
    ],
)
def test_verify_plain_matches_jax(m, heads, kv_heads, hd, page, max_pages,
                                  seq_lens, window, pad):
    q, kp, vp, table, sl = _verify_inputs(
        m * 100 + len(seq_lens), m, heads, kv_heads, hd, page, n_pages=32,
        max_pages=max_pages, seq_lens=seq_lens, pad=pad)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, sl)]
    got = tpa.multi_token_paged_attention(*args, window=window).numpy()
    want_pallas = np.asarray(jax_paged_verify(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(sl), interpret=True, window=window))
    # The XLA op fills out-of-range ids with NaN where the kernels clamp
    # them: give it the clamped table (the same pages).
    want_xla = np.asarray(jpa.multi_token_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(np.clip(table, 0, kp.shape[0] - 1)), jnp.asarray(sl),
        window=window))
    np.testing.assert_allclose(got, want_pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_xla, rtol=TOL, atol=TOL)
    launches = pv.launches
    via = pv.verify_attention(*args, window=window)
    assert torch.equal(via, torch.from_numpy(got))
    assert pv.launches == launches


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
    with pytest.raises(ValueError, match="CUDA"):
        pv.paged_flash_verify(q, torch.zeros(4, 8, 2, 32),
                              torch.zeros(4, 8, 2, 32),
                              torch.zeros(1, 2, dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32))
    meta = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_prefill(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        pd.decode_attention(torch.empty(1, 2, 32, device="meta"), None,
                            None, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        pv.verify_attention(meta, None, None, None, None)


# ---- the shape rule of every CUDA route -------------------------------------

from infinistore_tpu_torch.ops import _kernels  # noqa: E402
from infinistore_tpu_torch.ops import paged_flash_decode_q as pq  # noqa: E402


@pytest.mark.parametrize("hd,n_heads,n_kv", [
    (256, 16, 16),   # Gemma-7B
    (256, 8, 1),     # Gemma-2B: group 8
    (64, 6, 2),      # group 3
    (128, 12, 2),    # Qwen2-1.5B: group 6
    (128, 28, 4),    # Qwen2-7B: group 7
    (128, 128, 8),   # Llama-3.1-405B: group 16
    (32, 5, 5),
    (80, 32, 32),    # microsoft/phi-2
    (96, 32, 32),    # microsoft/Phi-3-mini
    (16, 4, 2),      # below the smallest instantiation (32)
])
def test_shape_rule_accepts_hd_256_and_any_group(hd, n_heads, n_kv):
    _kernels.check_head_shape(hd, n_heads, n_kv, "test")
    cap = _kernels.kernel_head_dim(hd)
    assert cap in _kernels.HEAD_DIMS and hd <= cap
    assert all(d < hd for d in _kernels.HEAD_DIMS if d < cap)


@pytest.mark.parametrize("hd,n_heads,n_kv,match", [
    (100, 8, 2, "F1"),       # not a multiple of 8: rows of 16-byte vectors
    (320, 8, 8, "F1"),       # above the largest instantiation (256)
    (128, 6, 4, "multiple"),  # not a GQA group
    (128, 2, 4, "multiple"),
])
def test_shape_rule_refuses(hd, n_heads, n_kv, match):
    with pytest.raises(ValueError, match=match):
        _kernels.check_head_shape(hd, n_heads, n_kv, "test")


def _wrapper_calls(hd, n_heads, n_kv):
    """Each CUDA kernel wrapper called with CPU tensors of one shape."""
    q = torch.zeros(1, 4, n_heads, hd)
    kv = torch.zeros(1, 4, n_kv, hd)
    rows = torch.zeros(1, n_heads, 4)
    qd = torch.zeros(2, n_heads, hd)
    pages = torch.zeros(3, 8, n_kv, hd)
    q8 = torch.zeros(3, 8, n_kv, hd, dtype=torch.int8)
    s8 = torch.ones(3, 8, n_kv)
    table = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    return {
        "flash_prefill_attention": lambda: fa.flash_prefill_attention(
            q, kv, kv),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, kv, kv, q, rows, rows),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, kv, kv, q, rows, rows),
        "paged_flash_decode": lambda: pd.paged_flash_decode(
            qd, pages, pages, table, lens),
        "paged_flash_decode_quantized": lambda: (
            pq.paged_flash_decode_quantized(qd, q8, s8, q8, s8, table,
                                            lens)),
        "paged_flash_verify": lambda: pv.paged_flash_verify(
            q[:, :2].expand(2, 2, n_heads, hd).contiguous(), pages, pages,
            table, lens),
    }


def test_every_wrapper_calls_the_shape_rule(monkeypatch):
    """All six kernel wrappers go through _kernels.check_head_shape before
    anything else: hd 100 is refused with F1's message (even for CPU
    tensors), while hd 256 at group 7 (and hd 96, phi-3's) passes the
    rule and is refused only because the tensors are not on the card."""
    seen = []
    real = _kernels.check_head_shape

    def spy(hd, n_heads, n_kv, kernel):
        seen.append(hd)
        return real(hd, n_heads, n_kv, kernel)

    monkeypatch.setattr(_kernels, "check_head_shape", spy)
    for name, call in _wrapper_calls(100, 4, 2).items():
        with pytest.raises(ValueError, match="F1"):
            call()
    assert seen == [100] * 6
    for hd in (256, 96):
        for name, call in _wrapper_calls(hd, 7, 1).items():
            with pytest.raises(ValueError, match="CUDA"):
                call()
    assert seen == [100] * 6 + [256] * 6 + [96] * 6

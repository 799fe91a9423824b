"""The port's tensor-parallel decode wrappers against the JAX package's:
``ops.paged_flash_decode.decode_attention_tp`` and
``ops.paged_flash_decode_q.decode_attention_quantized_tp`` against
``infinistore_tpu.ops.pallas_paged_attention.decode_attention_tp`` and
``decode_attention_quantized_tp``, whose ``shard_map`` runs the Pallas
kernels (K2, K4) in interpret mode on the 8-device CPU mesh, as
``tests/test_serving_mesh.py`` runs them. The port runs every one of the
tp slices in this process, each through the rank-local call, which on
the CPU is the plain version. Same numpy inputs,
f32, tolerance 2e-5 (the JAX test's)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from infinistore_tpu.ops import pallas_paged_attention as jpa
from infinistore_tpu_torch.ops import paged_flash_decode as pd
from infinistore_tpu_torch.ops import paged_flash_decode_q as pq

B, H, KV, HD, PAGE, N_PAGES, MAX_PAGES = 3, 8, 4, 16, 8, 17, 3
TOL = 2e-5


def _inputs(seed, quantized=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    shape = (N_PAGES, PAGE, KV, HD)
    if quantized:
        pages = [rng.integers(-127, 128, shape).astype(np.int8),
                 rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32),
                 rng.integers(-127, 128, shape).astype(np.int8),
                 rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)]
    else:
        pages = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
    table = rng.permutation(N_PAGES)[:B * MAX_PAGES].reshape(
        B, MAX_PAGES).astype(np.int32)
    lens = rng.integers(1, MAX_PAGES * PAGE, B).astype(np.int32)
    return q, pages, table, lens


def _mesh(tp):
    return Mesh(np.array(jax.devices()[:tp]), ("tp",))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("tp,window", [(2, 0), (4, 0), (4, 12)])
def test_decode_attention_tp_matches_jax(tp, window):
    q, (k, v), table, lens = _inputs(7)
    ref = jpa.decode_attention_tp(_mesh(tp), q, k, v, table, lens,
                                  window=window)
    out = pd.decode_attention_tp(tp, _t(q), _t(k), _t(v), _t(table),
                                 _t(lens), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_decode_attention_quantized_tp_matches_jax(tp):
    q, pages, table, lens = _inputs(8, quantized=True)
    ref = jpa.decode_attention_quantized_tp(_mesh(tp), q, *pages, table,
                                            lens)
    out = pq.decode_attention_quantized_tp(tp, _t(q), *map(_t, pages),
                                           _t(table), _t(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_each_slice_is_the_full_call_on_its_heads():
    """One slice per tp rank, each the rank-local call on its kv heads
    and their q heads: the slices together are the single-device call."""
    q, (k, v), table, lens = _inputs(9)
    full = pd.decode_attention(_t(q), _t(k), _t(v), _t(table), _t(lens))
    out = pd.decode_attention_tp(4, _t(q), _t(k), _t(v), _t(table),
                                 _t(lens))
    torch.testing.assert_close(out, full, rtol=TOL, atol=TOL)


def test_kv_heads_must_divide_by_tp():
    q, (k, v), table, lens = _inputs(10)
    with pytest.raises(ValueError, match="not divisible"):
        pd.decode_attention_tp(3, _t(q), _t(k), _t(v), _t(table), _t(lens))

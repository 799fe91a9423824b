"""Sequence parallelism: the port's ring (``ops/ring_attention.py``)
over gloo CPU ranks against the JAX package's ``ring_attention`` over
``make_sp_mesh(n)`` on the same inputs, to 1e-5 (float32; the ring's
blocks run the plain version of K1 with lse on the CPU). The cases of
``tests/test_ring_attention.py`` (causal and not; GQA), at n = 2 and 4
ranks; its jit case has no counterpart in eager torch. The ranks are
spawned once for the module."""

import numpy as np
import pytest

import torch_parallel_ranks
from infinistore_tpu.ops.paged_attention import prefill_attention
from infinistore_tpu.ops.ring_attention import make_sp_mesh, ring_attention
from infinistore_tpu_torch.parallel.launch import run_ranks

WORLD = 4
TOL = 1e-5


def _inputs(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))


# (name, n ranks, causal, inputs): test_ring_matches_dense's shapes
# (b 2, s 64, 4 heads, hd 16) and test_ring_gqa's (b 1, s 32, 8 q / 2 kv
# heads, hd 8).
CASES = [(f"{kind}_n{n}", n, causal, _inputs(seed, *shape))
         for n in (2, 4)
         for kind, causal, seed, shape in (
             ("causal", True, 0, (2, 64, 4, 4, 16)),
             ("full", False, 0, (2, 64, 4, 4, 16)),
             ("gqa", True, 1, (1, 32, 8, 2, 8)))]


@pytest.fixture(scope="module")
def port_out():
    cases = [(name, n, causal, *arrays) for name, n, causal, arrays in CASES]
    return run_ranks(torch_parallel_ranks.ring_cases, WORLD, (cases, 63),
                     device="cpu", timeout=300)[0]


@pytest.mark.parametrize("name,n,causal,arrays", CASES,
                         ids=[c[0] for c in CASES])
def test_ring_matches_jax_ring(port_out, name, n, causal, arrays):
    """``ring_attention`` (JAX, ``make_sp_mesh(n)``) and the port's ring
    over n gloo ranks, against each other and against dense attention."""
    q, k, v = arrays
    jax_out = np.asarray(ring_attention(q, k, v, make_sp_mesh(n),
                                        causal=causal))
    dense = np.asarray(prefill_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(port_out[name], jax_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port_out[name], dense, rtol=TOL, atol=TOL)


def test_ring_refuses_indivisible_sequence(port_out):
    """A sequence that does not divide by the ranks raises ValueError,
    as the JAX ring does (``ring_attention.py:68-70``)."""
    assert port_out["odd_raises"]
    with pytest.raises(ValueError):
        ring_attention(*_inputs(0, 1, 63, 2, 2, 8), make_sp_mesh(WORLD))

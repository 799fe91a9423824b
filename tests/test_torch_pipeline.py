"""Pipeline parallelism: the port's GPipe schedule
(``parallel/pipeline.py``) over gloo CPU ranks against the JAX package's
``pipeline_apply`` over ``make_pp_mesh(S)``, with the same stages and
microbatches, to 1e-5 (float32): the cases of ``tests/test_pipeline.py``.
Its (8, 8) case runs as (4, 4) here, on the module's 4 ranks. The
gradients of sum(out ** 2) are held to ``jax.grad`` through the JAX
schedule, so a replication whose backward reached the last stage from
every rank (grads x S) fails. The ranks are spawned once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks
from infinistore_tpu.parallel.pipeline import (make_pp_mesh, pipeline_apply,
                                               stack_stage_params,
                                               stage_shardings)
from infinistore_tpu_torch.parallel.launch import run_ranks
from infinistore_tpu_torch.parallel.pipeline import n_ticks

WORLD = 4
TOL = 1e-5


def stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def make_stages(seed, n_stages, d):
    """test_pipeline.py's stages: w ~ N(0, 1/d), b = 0 (b drawn here, so
    its gradient is held too)."""
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) / np.sqrt(d)).astype(
                 np.float32),
             "b": (0.1 * rng.standard_normal(d)).astype(np.float32)}
            for _ in range(n_stages)]


def _case(name, n_stages, n_micro, d, mb, seed, grad):
    stages = make_stages(seed, n_stages, d)
    x = np.random.default_rng(seed + 100).standard_normal(
        (n_micro, mb, d)).astype(np.float32)
    stacked = {k: np.stack([s[k] for s in stages]) for k in ("w", "b")}
    return name, n_stages, stacked, x, grad


CASES = [
    # test_pipeline_matches_sequential: (4, 8), (2, 3); (8, 8) as (4, 4)
    _case("seq_4x8", 4, 8, 16, 4, 0, False),
    _case("seq_2x3", 2, 3, 16, 4, 1, False),
    _case("seq_4x4", 4, 4, 16, 4, 2, False),
    # test_pipeline_is_differentiable: 4 stages, 6 microbatches
    _case("grad_4x6", 4, 6, 8, 2, 3, True),
    # test_bubble_schedule_length: n_micro < S
    _case("bubble_4x2", 4, 2, 8, 2, 4, False),
]
BY_NAME = {c[0]: c for c in CASES}


@pytest.fixture(scope="module")
def port_out():
    return run_ranks(torch_parallel_ranks.pipeline_cases, WORLD, (CASES,),
                     device="cpu", timeout=300)[0]


def _jax_pipeline(stacked, x, n_stages):
    mesh = make_pp_mesh(n_stages)
    st = jax.device_put(stack_stage_params(
        [{k: v[i] for k, v in stacked.items()} for i in range(n_stages)]),
        stage_shardings(mesh, {k: jnp.asarray(v)
                               for k, v in stacked.items()}))
    return mesh, st


@pytest.mark.parametrize("name", ["seq_4x8", "seq_2x3", "seq_4x4",
                                  "bubble_4x2"])
def test_pipeline_matches_jax_pipeline(port_out, name):
    _, n_stages, stacked, x, _ = BY_NAME[name]
    mesh, st = _jax_pipeline(stacked, x, n_stages)
    ref = np.asarray(jax.jit(
        lambda p, x: pipeline_apply(stage_fn, p, x, mesh))(st, x))
    got, _, _ = port_out[name]
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_pipeline_grads_match_jax_grad(port_out):
    """``jax.grad`` through the JAX schedule against the port's backward
    (each rank's stage grads, summed over the ranks), every leaf."""
    _, n_stages, stacked, x, _ = BY_NAME["grad_4x6"]
    mesh = make_pp_mesh(n_stages)
    params = {k: jnp.asarray(v) for k, v in stacked.items()}

    def loss(p):
        return jnp.sum(pipeline_apply(stage_fn, p, x, mesh) ** 2)

    ref = jax.jit(jax.grad(loss))(params)
    out, grads, _ = port_out["grad_4x6"]
    np.testing.assert_allclose(
        out, np.asarray(pipeline_apply(stage_fn, params, x, mesh)),
        rtol=TOL, atol=TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(grads[k], np.asarray(ref[k]), rtol=TOL,
                                   atol=TOL)


def test_bubble_schedule_length(port_out):
    """n_micro + S - 1 ticks: at S = 4, n_micro = 2 the output is right
    (above) and stage 0 hands off on its 2 active ticks only."""
    assert n_ticks(4, 2) == 5 and n_ticks(2, 3) == 4
    assert port_out["bubble_4x2"][2] == 2
    assert port_out["seq_4x8"][2] == 8

"""The port's training path against the JAX package, on the CPU: the plain
forward-with-lse and the plain backward (the oracles of kernels K1, K5
and K6) against the Pallas kernels in interpret mode, the FlashAttention
Function against ``jax.grad`` through ``_flash_with_vjp``, and
``loss_fn`` / ``train_step`` against the JAX model with optax, on the same
numpy inputs and weights. float32 unless stated; each tolerance is stated
with its reason beside it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_flash_prefill import CASES

from __graft_entry__ import _tiny_cfg
from infinistore_tpu.models import llama as jl
from infinistore_tpu.ops.pallas_flash_attention import (
    _flash_backward,
    _flash_with_vjp,
    _forward_impl,
)
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.ops import flash_attention as fa

# f32 against the Pallas kernels: the two differ only in summation order
# (blocked online softmax vs one pass), ~1e-6 here; JAX's own tests hold
# its backward kernels to XLA at 1e-3.
TOL = 1e-4


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``
    (float32 or bfloat16, rounded once, to nearest even, by each)."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(a)
    if dtype == jnp.bfloat16:
        t = t.to(torch.bfloat16)
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES)
def test_forward_lse_plain_matches_pallas(case):
    """flash_forward_lse_plain against _forward_impl(with_lse=True) in
    interpret mode, on tests/test_flash_prefill.py's CASES."""
    B, S, H, KV, D, dtype, causal = case
    rng = np.random.default_rng(42)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_np(rng, B, S, n, D), dtype) for n in (H, KV, KV))
    j_out, j_lse = _forward_impl(jq, jk, jv, causal, 128, 128, True,
                                 with_lse=True)
    t_out, t_lse = fa.flash_forward_lse_plain(tq, tk, tv, causal=causal)
    assert t_lse.dtype == torch.float32 and t_lse.shape == (B, H, S)
    assert t_out.dtype == tq.dtype
    # lse: both sum exact bf16 products in f32 -> summation order only.
    np.testing.assert_allclose(_f32(t_lse), _f32(j_lse), rtol=TOL, atol=TOL)
    # bf16 output: the TPU kernel rounds the unnormalized P to bf16, the
    # plain version the normalized one; 2e-2 is the JAX package's own bf16
    # tolerance against an f64 reference (test_matches_f64_reference).
    tol = 2e-2 if dtype == jnp.bfloat16 else TOL
    np.testing.assert_allclose(_f32(t_out), _f32(j_out), rtol=tol, atol=tol)


BWD_CASES = [
    # (batch, s_q, s_kv, heads, kv_heads, hd, causal, window)
    (1, 128, 320, 4, 2, 64, True, 0),    # 128 queries over a 192 prefix
    (1, 256, 256, 4, 2, 64, True, 48),   # sliding window
    (2, 100, 100, 4, 4, 32, False, 0),   # not causal, ragged, MHA
    (1, 200, 200, 8, 2, 64, True, 0),    # ragged, group 4
    (1, 96, 300, 4, 1, 32, True, 40),    # prefix + window: dead kv rows
    # Shapes the CUDA routes take since hd 256 and any group: Gemma's
    # head dim, and Qwen2's groups of 6 and 7.
    (1, 64, 96, 2, 2, 256, True, 0),     # hd 256 over a 32 prefix
    (1, 80, 80, 6, 1, 64, True, 0),      # group 6
    (1, 64, 64, 7, 1, 64, True, 0),      # group 7
    (1, 72, 136, 7, 1, 64, True, 24),    # group 7, prefix + window
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_plain_matches_pallas(case):
    """flash_bwd_dq_plain / flash_bwd_dkv_plain against _flash_backward in
    interpret mode, given the same q, k, v, o, lse and cotangent."""
    B, SQ, SK, H, KV, D, causal, window = case
    rng = np.random.default_rng(SQ * 7 + SK)
    q, k, v = _np(rng, B, SQ, H, D), _np(rng, B, SK, KV, D), \
        _np(rng, B, SK, KV, D)
    g = _np(rng, B, SQ, H, D)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = fa.flash_forward_lse_plain(tq, tk, tv, causal, window)
    dvec = (tg * o).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq_plain(tq, tk, tv, tg, lse, dvec, causal, window)
    dk, dv = fa.flash_bwd_dkv_plain(tq, tk, tv, tg, lse, dvec, causal,
                                    window)
    jdq, jdk, jdv = _flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(g),
        causal, True, block_q=128, block_k=128, window=window)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL,
                                   atol=TOL, err_msg=name)
    if window and SK > SQ:
        # kv rows below every query's window floor get exactly zero.
        dead = SK - SQ - window + 1
        assert torch.all(dk[:, :dead] == 0) and torch.all(dv[:, :dead] == 0)


@pytest.mark.parametrize("case", [
    (1, 128, 192, 4, 2, 64, 0),    # test_prefix_backward_matches_xla_grads
    (1, 256, 0, 4, 2, 64, 48),     # test_sliding_window_backward_...
])
def test_flash_attention_grads_match_jax(case):
    """torch.autograd.grad through flash_prefill (which takes the
    FlashAttention Function for tensors that require grad) against
    jax.grad through _flash_with_vjp(interpret=True)."""
    B, S, P, H, KV, D, window = case
    rng = np.random.default_rng(29 + window)
    q, k, v = _np(rng, B, S, H, D), _np(rng, B, P + S, KV, D), \
        _np(rng, B, P + S, KV, D)
    w = _np(rng, B, S, H, D)

    def loss_jax(q, k, v):
        return jnp.sum(_flash_with_vjp(q, k, v, True, True, window) * w)

    jg = jax.grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    launches = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out = fa.flash_prefill(tq, tk, tv, causal=True, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == launches
    for name, got, want in zip("qkv", tg, jg):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3),
                                           (False, 0)])
def test_flash_attention_gradcheck_float64(causal, window):
    """The Function's backward is the derivative of its forward: finite
    differences in float64 on a tiny GQA shape with a 2-token prefix."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(1, 5, 4, 8, generator=gen, dtype=torch.float64)
    k = torch.randn(1, 7, 2, 8, generator=gen, dtype=torch.float64)
    v = torch.randn(1, 7, 2, 8, generator=gen, dtype=torch.float64)
    for t in (q, k, v):
        t.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.FlashAttention.apply(q, k, v, causal, window,
                                                fa.PLAIN_LEAVES),
        (q, k, v))


def test_no_grad_route_and_kernel_wrappers():
    """Without a gradient to track, flash_prefill keeps the forward-only
    route (no graph); the K5/K6 wrappers take CUDA tensors only."""
    q = torch.randn(1, 6, 2, 32, requires_grad=True)
    with torch.no_grad():
        out = fa.flash_prefill(q, q, q)
    assert out.grad_fn is None
    assert fa.flash_prefill(q.detach(), q.detach(), q.detach()).grad_fn \
        is None
    rows = torch.zeros(1, 2, 6)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq(q, q, q, q, rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv(q, q, q, q, rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_prefill_attention(q, q, q, with_lse=True)


# ---------------------------------------------------------------------------
# The model: loss_fn and train_step
# ---------------------------------------------------------------------------

def _cfgs(window):
    jcfg = dataclasses.replace(_tiny_cfg(), dtype="float32", window=window)
    return jcfg, tl.LlamaConfig(**dataclasses.asdict(jcfg))


def _paths(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _at(tparams, path):
    node = tparams
    for p in path:
        node = node[p.key if hasattr(p, "key") else p.idx]
    return node


def _rel(a, b):
    a, b = _f32(a).ravel(), _f32(b).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("window", [0, 12])
def test_loss_and_grads_match_jax(window):
    """loss_fn and the grad of every leaf against
    jax.value_and_grad(llama.loss_fn) on the same weights and tokens.
    Loss within 1e-5 relative and every grad within 1e-4 relative L2:
    float32 through 2 layers and a 256-wide vocab, differing only in
    summation order (the JAX package's own dense-vs-paged identities
    hold at 2e-4)."""
    jcfg, tcfg = _cfgs(window)
    jparams = jl.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(jl.loss_fn)(jparams, jcfg,
                                                     jnp.asarray(tokens))
    leaves = tl.trainable(tparams)
    assert len(leaves) == len(_paths(jparams))
    t_loss = tl.loss_fn(tparams, tcfg, torch.from_numpy(tokens))
    t_grads = torch.autograd.grad(t_loss, leaves)
    by_id = {id(t): g for t, g in zip(leaves, t_grads)}
    assert abs(float(t_loss.detach()) - float(j_loss)) <= \
        1e-5 * abs(float(j_loss))
    for path, jg in _paths(j_grads):
        tg = by_id[id(_at(tparams, path))]
        assert torch.isfinite(tg).all()
        assert _rel(tg, jg) <= 1e-4, (jax.tree_util.keystr(path),
                                      _rel(tg, jg))


# Adam's first update is lr * g / (|g| + eps): near |g| ~ eps = 1e-8 it
# turns an absolute grad difference into lr / eps = 1e5 times as much
# weight difference, and float32 summation noise (~1e-7 of the largest
# grad, ~1e-8 here) reaches that scale. Weights whose grad, at any step,
# lies below NOISE_FLOOR are held only to Adam's largest move instead.
NOISE_FLOOR = 1e-6


def test_two_train_steps_match_optax():
    """Two train_steps (AdamW with optax's defaults) against the JAX
    train_step with optax.adamw(1e-3) from the same weights. Losses
    within 1e-5 relative (as above). Parameters within 2e-5 absolute:
    Adam moves each weight by about lr = 1e-3 per step whatever its
    grad's scale, so grads that agree to 1e-4 move weights that agree to
    a small fraction of lr — except where a grad sits at the noise floor
    (see NOISE_FLOOR): there, at most one weight in a thousand, each
    within Adam's largest two-step move, 2 lr (1 + weight decay)."""
    jcfg, tcfg = _cfgs(0)
    jparams = jl.init_params(jax.random.PRNGKey(5), jcfg)
    tparams = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    optimizer = optax.adamw(1e-3)
    opt_state = optimizer.init(jparams)
    opt = tl.adamw(tparams, 1e-3)
    floor = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, bool),
                                   jparams)
    for _ in range(2):
        grads = jax.grad(jl.loss_fn)(jparams, jcfg, jnp.asarray(tokens))
        floor = jax.tree_util.tree_map(
            lambda f, g: f | ((np.abs(g) < NOISE_FLOOR) & (g != 0)), floor,
            grads)
        jparams, opt_state, j_loss = jl.train_step(
            jparams, opt_state, jcfg, jnp.asarray(tokens), optimizer)
        t_loss = tl.train_step(tparams, opt, tcfg, torch.from_numpy(tokens))
        assert abs(float(t_loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    n_floor = n_all = 0
    for (path, jp), (_, low) in zip(_paths(jparams), _paths(floor)):
        diff = np.abs(_f32(_at(tparams, path)) - _f32(jp))
        name = jax.tree_util.keystr(path)
        assert diff[~low].max(initial=0) <= 2e-5, (name, diff[~low].max())
        assert diff[low].max(initial=0) <= 2 * 1e-3 * (1 + 1e-4), name
        n_floor += int(low.sum())
        n_all += low.size
    assert n_floor <= 1e-3 * n_all, (n_floor, n_all)


def test_adamw_step_matches_optax_on_the_same_grads():
    """The optimizer mapping alone: given the same grads twice,
    torch.optim.AdamW from :func:`adamw` moves every weight as
    optax.adamw(1e-3) does, to float32 rounding: the two round the
    decayed weight and the step at different points, so they agree to
    two ulps of each weight (2.5e-7 relative) or of the largest weights
    of each leaf (5e-8 absolute: ulps of ~0.2 and of ~1)."""
    rng = np.random.default_rng(9)
    w = {"a": _np(rng, 64, 32) * 0.1, "b": [_np(rng, 32)]}
    grads = [jax.tree_util.tree_map(
        lambda x: (_np(rng, *x.shape) * 10.0 ** rng.integers(
            -9, 1, x.shape)).astype(np.float32), w) for _ in range(2)]
    optimizer = optax.adamw(1e-3)
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    state = optimizer.init(jw)
    tw = {"a": torch.from_numpy(w["a"].copy()),
          "b": [torch.from_numpy(w["b"][0].copy())]}
    opt = tl.adamw(tw, 1e-3)
    for g in grads:
        updates, state = optimizer.update(g, state, jw)
        jw = optax.apply_updates(jw, updates)
        for t, gt in zip(tl.param_leaves(tw), jax.tree_util.tree_leaves(g)):
            t.grad = torch.from_numpy(np.asarray(gt))
        opt.step()
    for t, jt in zip(tl.param_leaves(tw), jax.tree_util.tree_leaves(jw)):
        np.testing.assert_allclose(_f32(t), _f32(jt), rtol=2.5e-7,
                                   atol=5e-8)


def test_train_step_loss_hook_and_serving_steps_stay_no_grad():
    """train_step takes another family's loss (the hook moe.train_step
    uses) and lowers it on a repeated batch; with trainable leaves,
    decode_step and verify_step still build no graph."""
    _, tcfg = _cfgs(0)
    params = tl.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    opt = tl.adamw(params, 1e-2)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 12)))
    calls = []

    def loss(p, c, t):
        calls.append(t.shape)
        return tl.loss_fn(p, c, t)

    losses = [float(tl.train_step(params, opt, tcfg, tokens, loss=loss))
              for _ in range(3)]
    assert len(calls) == 3 and losses[-1] < losses[0]
    assert all(t.grad is not None for t in tl.param_leaves(params))
    kp = torch.zeros(tcfg.n_layers, 4, *tcfg.kv_page_shape())
    table = torch.arange(4, dtype=torch.int32)[None]
    lens = torch.tensor([3], dtype=torch.int32)
    lg, _, _ = tl.decode_step(params, tcfg, tokens[:1, 0], lens, kp,
                              kp.clone(), table)
    assert lg.grad_fn is None and not lg.requires_grad
    lg, _, _ = tl.verify_step(params, tcfg, tokens[:1, :2], lens, kp,
                              kp.clone(), table)
    assert lg.grad_fn is None and not lg.requires_grad

"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_prefill.cu`` (K1, with an optional row logsumexp),
``csrc/flash_bwd_dq.cu`` (K5) and ``csrc/flash_bwd_dkv.cu`` (K6), their
plain PyTorch versions, the :class:`FlashAttention` autograd Function and
the dispatcher :func:`flash_prefill`.

Counterpart of ``infinistore_tpu/ops/pallas_flash_attention.py``:
``flash_prefill_attention`` / ``_forward_impl`` (K1), ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel`` behind ``_flash_backward`` (K5, K6),
``_flash_with_vjp`` (:class:`FlashAttention`) and ``flash_prefill``.
:func:`k1_schedule`, :func:`k5_schedule`, :func:`k6_schedule` and
:func:`k6_wide_schedule` (K6 at capacity 256, over :func:`k6_splits`'s
runs of q heads) are the bf16 kernels' tile walks in Python (their
order, live tiles and interior tiles), for the tests and
``chip_smoke.py``.

:func:`flash_prefill` with no gradient to track takes the forward-only
route: K1 for CUDA tensors, ``paged_attention.prefill_attention`` for CPU
tensors. When grad mode is on and q, k or v requires grad it goes through
:class:`FlashAttention`, whose leaves are K1 (with lse), K5 and K6 for
CUDA tensors and the plain versions below for CPU tensors. A CUDA tensor
launches the kernels or raises — there is no fallback, and the output on
the card always carries its ``grad_fn``.
"""

import collections

import torch

from . import _kernels
from .paged_attention import (_NEG_INF, _repeat_kv, causal_mask,
                              check_causal, prefill_attention)

# Launches of K1, K5 and K6 (incremented only where each is launched).
launches = 0
dq_launches = 0
dkv_launches = 0

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def reset_launches():
    global launches, dq_launches, dkv_launches
    launches = dq_launches = dkv_launches = 0


def _check_kernel_args(q, k, v, causal, do=None, rows=()):
    """What every kernel takes: the shape rule of
    :func:`_kernels.check_head_shape`; q/k/v (and dO) CUDA, contiguous,
    16-byte aligned, one dtype (bf16 or f32); row vectors (lse, D) f32
    [batch, n_heads, s_q] on the same card."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k must be 4-D")
    _kernels.check_head_shape(q.shape[3], q.shape[2], k.shape[2],
                              "flash attention")
    named = [("q", q), ("k", k), ("v", v)] + ([("dout", do)] if do is not
                                               None else [])
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} (need bf16 or f32, "
                            "all the same)")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
    batch, s_q, n_heads, hd = q.shape
    if k.shape != v.shape or k.shape[0] != batch or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dout {tuple(do.shape)} is not q's shape")
    check_causal(q, k, causal)
    for name, t in rows:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (batch, n_heads, s_q)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[{batch}, {n_heads}, {s_q}] on {q.device}")
    return batch, s_q, k.shape[1], n_heads, k.shape[2], hd


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def flash_prefill_attention(q, k, v, causal=True, window=0, with_lse=False):
    """Launch K1, the CUDA flash prefill kernel.

    q: [batch, s_q, n_heads, hd]; k/v: [batch, s_kv, n_kv, hd], CUDA,
    contiguous, bf16 or float32, n_heads a multiple of n_kv, hd a
    multiple of 8 up to 256. s_kv may exceed s_q (suffix over a cached prefix:
    the causal diagonal shifts by s_kv - s_q). Returns [batch, s_q,
    n_heads, hd] in q's dtype; with ``with_lse``, also the row logsumexp
    of the scaled logits, float32 [batch, n_heads, s_q]."""
    global launches
    batch, s_q, s_kv, n_heads, n_kv, hd = _check_kernel_args(q, k, v, causal)
    out = torch.empty_like(q)
    lse = (torch.empty((batch, n_heads, s_q), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    if out.numel():
        err = _kernels.lib().istpu_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPES[q.dtype],
            batch, s_q, s_kv, n_heads, n_kv, hd, _kernels.softmax_scale(hd),
            int(bool(causal)), int(window),
            _kernels.stream_handle(q.device),
        )
        _kernels.check(err, "flash_prefill")
        launches += 1
    return (out, lse) if with_lse else out


def flash_bwd_dq(q, k, v, do, lse, dvec, causal=True, window=0):
    """Launch K5: dQ from q, k, v, the output cotangent ``do`` (q's shape
    and dtype), the forward's ``lse`` and ``dvec`` = rowsum(dO * O), both
    float32 [batch, n_heads, s_q]. Returns dq in q's dtype."""
    global dq_launches
    batch, s_q, s_kv, n_heads, n_kv, hd = _check_kernel_args(
        q, k, v, causal, do, (("lse", lse), ("dvec", dvec)))
    dq = torch.empty_like(q)
    if not (dq.numel() and s_kv):
        return dq.zero_()
    err = _kernels.lib().istpu_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), _DTYPES[q.dtype],
        batch, s_q, s_kv, n_heads, n_kv, hd, _kernels.softmax_scale(hd),
        int(bool(causal)), int(window), _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_bwd_dq")
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dvec, causal=True, window=0):
    """Launch K6: dK and dV (arguments as :func:`flash_bwd_dq`), each
    summed over its kv head's group of q heads. Returns (dk, dv) in k's
    dtype."""
    global dkv_launches
    batch, s_q, s_kv, n_heads, n_kv, hd = _check_kernel_args(
        q, k, v, causal, do, (("lse", lse), ("dvec", dvec)))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if not (dk.numel() and s_q):
        return dk.zero_(), dv.zero_()
    splits = k6_splits(batch, s_kv, n_kv, n_heads // n_kv, hd, q.dtype,
                       _kernels.sm_count(q.device))
    # The splits' f32 sums, added in split order by the kernel's second
    # pass.
    partial = (torch.empty((splits, 2, *k.shape), dtype=torch.float32,
                           device=k.device) if splits > 1 else None)
    err = _kernels.lib().istpu_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if partial is None else partial.data_ptr(), splits,
        _DTYPES[q.dtype], batch, s_q, s_kv, n_heads, n_kv, hd,
        _kernels.softmax_scale(hd), int(bool(causal)), int(window),
        _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_bwd_dkv")
    dkv_launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# The kernels' tile schedules, in Python (csrc/flash_prefill.cu,
# flash_bwd_dq.cu, flash_bwd_dkv.cu and flash_tile.cuh)
# ---------------------------------------------------------------------------

# K1's bf16 tiles (flash_prefill.cu's kRows, kBK and kBKWide): 64 query
# rows per consumer warpgroup, one or two consumers per CTA, 128 keys per
# kv tile at hd <= 128 and 64 at capacity 256. The f32 variant keeps
# flash_tile.cuh's 64 x 64 tiles.
K1_ROWS = 64
K1_BK = 128
K1_BK_WIDE = 64
# K5's bf16 tiles (flash_bwd_dq.cu's kRows and kBK): 64 q rows per
# consumer warpgroup, one or two consumers per CTA (k5_consumers), 64
# keys per kv tile. K6's (flash_bwd_dkv.cu's kRows, kBQ and kNC): 64 kv
# rows per CTA, 64 q rows per stage, two consumers, which take the stages
# in turn at hd <= 128 and at capacity 256 each take every stage into
# their half of dK's and dV's columns.
K5_ROWS = K5_BK = 64
K6_ROWS = K6_BQ = 64
K6_CONSUMERS = 2


def k1_bk(hd):
    """Keys per kv tile of K1's bf16 kernel at head dim ``hd``."""
    return K1_BK if _kernels.kernel_head_dim(hd) <= 128 else K1_BK_WIDE


def k6_splits(batch, s_kv, n_kv, group, hd, dtype, sm_count):
    """Runs of q heads each kv head's group is cut into over K6's grid
    (bf16 at capacity 256 only; 1 elsewhere): 1 where the ceil(s_kv / 64)
    * batch * n_kv CTAs fill the card's SMs, else the least divisor of
    the group that makes them do so, else the group."""
    if dtype != torch.bfloat16 or _kernels.kernel_head_dim(hd) <= 128:
        return 1
    ctas = -(-s_kv // K6_ROWS) * batch * n_kv
    if ctas >= sm_count:
        return 1
    return next((d for d in range(1, group + 1)
                 if group % d == 0 and ctas * d >= sm_count), group)


def k1_consumers(batch, s_q, n_heads, sm_count):
    """Consumer warpgroups per CTA of K1's bf16 kernel: two (128-row q
    tiles) unless that launches fewer CTAs than the card has SMs."""
    ctas = -(-s_q // (2 * K1_ROWS)) * batch * n_heads
    return 1 if ctas < sm_count else 2


def k5_consumers(batch, s_q, n_heads, hd, sm_count):
    """Consumer warpgroups per CTA of K5's bf16 kernel: one at capacity
    256 (two would leave shared memory for one K + V stage), else
    :func:`k1_consumers`' rule."""
    if _kernels.kernel_head_dim(hd) > 128:
        return 1
    return k1_consumers(batch, s_q, n_heads, sm_count)


def kv_tile_range(q_start, s_q, s_kv, causal, window, bq, bk):
    """flash_tile.cuh's kv_tiles<bq, bk>: the live kv tiles [begin, end)
    of the q tile at q_start (s_kv >= s_q when causal)."""
    offset = s_kv - s_q
    end = -(-s_kv // bk)
    begin = 0
    if causal:
        end = min(end, (min(q_start + bq, s_q) - 1 + offset) // bk + 1)
        if window > 0:
            begin = max(q_start + offset - window + 1, 0) // bk
    return begin, end


def q_tile_range(k_start, s_q, s_kv, causal, window, bq, bk):
    """flash_tile.cuh's q_tiles<bq, bk>: the live q tiles [begin, end) of
    the kv tile at k_start."""
    offset = s_kv - s_q
    end = -(-s_q // bq)
    begin = 0
    if causal:
        begin = max(k_start - offset, 0) // bq
        if window > 0:
            last = k_start + bk - 1 - offset + window - 1
            end = 0 if last < 0 else min(end, last // bq + 1)
    return begin, end


def interior_tile(q_start, k_start, s_q, s_kv, causal, window, bq, bk):
    """flash_tile.cuh's interior_tile<bq, bk>: every (query, key) pair of
    the tile is kept, so no mask is built."""
    interior = k_start + bk <= s_kv and q_start + bq <= s_q
    if causal:
        offset = s_kv - s_q
        interior = interior and k_start + bk - 1 <= q_start + offset
        if window > 0:
            interior = interior and (k_start
                                     > q_start + bq - 1 + offset - window)
    return interior


def k1_schedule(s_q, s_kv, causal=True, window=0, consumers=2, hd=128):
    """The tiles K1's bf16 kernel visits for one (batch, head) at head
    dim ``hd``, in launch order (heaviest q tile first): a list of
    (q_start, [(k_start, interior of each consumer's 64 rows), ...]) over
    the live kv tiles."""
    bq, bk = consumers * K1_ROWS, k1_bk(hd)
    n_qt = -(-s_q // bq)
    order = []
    for rank in range(n_qt):
        q_start = (n_qt - 1 - rank) * bq
        begin, end = kv_tile_range(q_start, s_q, s_kv, causal, window, bq,
                                   bk)
        order.append((q_start, [
            (kt * bk, tuple(
                interior_tile(q_start + c * K1_ROWS, kt * bk, s_q, s_kv,
                              causal, window, K1_ROWS, bk)
                for c in range(consumers)))
            for kt in range(begin, end)]))
    return order


def _visit(own, q0, k0, s_q, s_kv, causal, window):
    """A consumer's 64 x 64 part of one tile (K5's and K6's tiles alike):
    "dead" where its own rows see none of it (it skips its products),
    else "interior" or "masked"."""
    if not own:
        return "dead"
    return ("interior" if interior_tile(q0, k0, s_q, s_kv, causal, window,
                                        K5_ROWS, K5_BK) else "masked")


def k5_schedule(s_q, s_kv, causal=True, window=0, consumers=2):
    """The tiles K5's bf16 kernel visits for one (batch, head), in launch
    order (heaviest q tile first): a list of (q_start, [(k_start, (state
    of each consumer's 64 rows: "interior", "masked" or "dead")), ...])
    over the CTA's live kv tiles."""
    bq = consumers * K5_ROWS
    n_qt = -(-s_q // bq)
    order = []
    for rank in range(n_qt):
        q_start = (n_qt - 1 - rank) * bq
        begin, end = kv_tile_range(q_start, s_q, s_kv, causal, window, bq,
                                   K5_BK)
        owns = []
        for c in range(consumers):
            row0 = q_start + c * K5_ROWS
            owns.append(kv_tile_range(row0, s_q, s_kv, causal, window,
                                      K5_ROWS, K5_BK)
                        if row0 < s_q else (0, 0))
        order.append((q_start, [
            (kt * K5_BK, tuple(
                _visit(ob <= kt < oe, q_start + c * K5_ROWS, kt * K5_BK,
                       s_q, s_kv, causal, window)
                for c, (ob, oe) in enumerate(owns)))
            for kt in range(begin, end)]))
    return order


def k6_schedule(s_q, s_kv, group, causal=True, window=0):
    """The stages K6's bf16 kernel walks at hd <= 128 for one (batch, kv
    head), in launch order (kv tile 0 first): a list of (k_start,
    [(group member, q_start, consumer, "interior" or "masked"), ...]),
    stage i going to consumer i % K6_CONSUMERS. An empty list is a kv
    tile no query sees: the kernel writes its dK and dV rows as zeros."""
    order = []
    for k_start in range(0, s_kv, K6_ROWS):
        begin, end = q_tile_range(k_start, s_q, s_kv, causal, window,
                                  K6_BQ, K6_ROWS)
        walk = [(g, qt * K6_BQ) for g in range(group)
                for qt in range(begin, end)]
        order.append((k_start, [
            (g, q0, i % K6_CONSUMERS,
             _visit(True, q0, k_start, s_q, s_kv, causal, window))
            for i, (g, q0) in enumerate(walk)]))
    return order


def k6_wide_schedule(s_q, s_kv, group, splits, causal=True, window=0):
    """The stages K6's bf16 kernel walks at capacity 256 for one (batch,
    kv head), in launch order (kv tile 0 first, its splits side by side):
    a list of (k_start, split, [(group member, q_start, "interior" or
    "masked"), ...]), both consumers taking every stage (each into its
    half of the columns). Split s walks members [s * group / splits,
    (s + 1) * group / splits). An empty list writes the split's sums as
    zeros."""
    order = []
    for k_start in range(0, s_kv, K6_ROWS):
        begin, end = q_tile_range(k_start, s_q, s_kv, causal, window,
                                  K6_BQ, K6_ROWS)
        for split in range(splits):
            lo, hi = split * group // splits, (split + 1) * group // splits
            order.append((k_start, split, [
                (g, qt * K6_BQ,
                 _visit(True, qt * K6_BQ, k_start, s_q, s_kv, causal,
                        window))
                for g in range(lo, hi) for qt in range(begin, end)]))
    return order


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the oracle of K1 (with lse), K5 and K6
# ---------------------------------------------------------------------------

def _acc_dtype(dtype):
    """bf16 and f32 operands are multiplied in f32 (f32 stays true f32);
    float64 stays float64, for gradcheck."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _masked_logits(q, k, causal, window):
    """Scaled logits [batch, n_heads, s_q, s_kv] in the accumulation
    type, the pairs the mask drops at -1e30 (the JAX package's
    _tile_mask: shifted diagonal, window floor)."""
    check_causal(q, k, causal)
    acc = _acc_dtype(q.dtype)
    kr = _repeat_kv(k, q.shape[2] // k.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), kr.to(acc)) \
        * q.shape[-1] ** -0.5
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], window, q.device)
        logits = logits.masked_fill(~mask, _NEG_INF)
    return logits


def flash_forward_lse_plain(q, k, v, causal=True, window=0):
    """Plain version of K1 with lse: (out [batch, s_q, n_heads, hd] in
    q's dtype, lse [batch, n_heads, s_q] float32 — float64 for float64
    inputs)."""
    acc = _acc_dtype(q.dtype)
    logits = _masked_logits(q, k, causal, window)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    vr = _repeat_kv(v, q.shape[2] // v.shape[2])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(acc), vr.to(acc))
    return out.to(q.dtype), lse


def _probs_and_ds(q, k, v, do, lse, dvec, causal, window):
    """The backward tile recompute over the whole matrix (the JAX
    package's _bwd_tile): P = exp(logits - lse), exactly 0 where masked,
    and dS = P (dO V^T - D) scale, both [batch, n_heads, s_q, s_kv]."""
    acc = _acc_dtype(q.dtype)
    p = torch.exp(_masked_logits(q, k, causal, window)
                  - lse.to(acc)[..., None])
    vr = _repeat_kv(v, q.shape[2] // v.shape[2])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), vr.to(acc))
    ds = p * (dp - dvec.to(acc)[..., None]) * q.shape[-1] ** -0.5
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, dvec, causal=True, window=0):
    """Plain version of K5: dQ = dS K, with dS rounded to k's dtype
    before the product (ds.astype(k.dtype)). Returns dq in q's dtype."""
    acc = _acc_dtype(q.dtype)
    _, ds = _probs_and_ds(q, k, v, do, lse, dvec, causal, window)
    kr = _repeat_kv(k, q.shape[2] // k.shape[2])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(acc), kr.to(acc))
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, dvec, causal=True, window=0):
    """Plain version of K6: dV = P^T dO and dK = dS^T Q per q head (P and
    dS rounded to the operands' dtype first), summed over each kv head's
    group. Returns (dk, dv) in k's dtype."""
    acc = _acc_dtype(q.dtype)
    p, ds = _probs_and_ds(q, k, v, do, lse, dvec, causal, window)
    batch, s_kv, n_kv, hd = k.shape
    group = q.shape[2] // n_kv
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc), do.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(acc), q.to(acc))
    dk = dk.reshape(batch, s_kv, n_kv, group, hd).sum(3)
    dv = dv.reshape(batch, s_kv, n_kv, group, hd).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The autograd Function and the dispatcher
# ---------------------------------------------------------------------------

# The three functions FlashAttention runs: forward with lse, dQ, dK/dV.
Leaves = collections.namedtuple("Leaves", "forward dq dkv")


def _kernel_forward(q, k, v, causal, window):
    return flash_prefill_attention(q, k, v, causal=causal, window=window,
                                   with_lse=True)


KERNEL_LEAVES = Leaves(_kernel_forward, flash_bwd_dq, flash_bwd_dkv)
PLAIN_LEAVES = Leaves(flash_forward_lse_plain, flash_bwd_dq_plain,
                      flash_bwd_dkv_plain)


class FlashAttention(torch.autograd.Function):
    """Flash attention whose gradient is the recompute backward (the JAX
    package's _flash_with_vjp): the forward keeps q, k, v, out and the
    row lse, and the backward computes D = rowsum(dO * O) in torch and
    dQ, dK, dV through ``leaves`` — :data:`KERNEL_LEAVES` (K1, K5, K6) or
    :data:`PLAIN_LEAVES`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, leaves):
        out, lse = leaves.forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.leaves = causal, window, leaves
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        do = g.to(q.dtype).contiguous()
        acc = _acc_dtype(q.dtype)
        # D = rowsum(dO * O), [batch, n_heads, s_q], as XLA computes it
        # outside the kernels in the JAX package.
        dvec = (do.to(acc) * out.to(acc)).sum(-1).transpose(1, 2)
        dvec = dvec.to(lse.dtype).contiguous()
        args = (q, k, v, do, lse, dvec, ctx.causal, ctx.window)
        dq = ctx.leaves.dq(*args)
        dk, dv = ctx.leaves.dkv(*args)
        return dq, dk, dv, None, None, None


def flash_prefill(q, k, v, causal=True, window=0):
    """Prefill attention. With grad mode on and q, k or v requiring grad:
    :class:`FlashAttention` (kernel leaves on the card, plain leaves on
    the CPU). Otherwise K1 for CUDA tensors and the plain
    ``prefill_attention`` for CPU tensors; any other device raises."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        leaves = KERNEL_LEAVES if q.device.type == "cuda" else PLAIN_LEAVES
        return FlashAttention.apply(q, k, v, causal, window, leaves)
    if q.device.type == "cuda":
        return flash_prefill_attention(q, k, v, causal=causal, window=window)
    return prefill_attention(q, k, v, causal=causal, window=window)

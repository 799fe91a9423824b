"""The split-K paged attention kernel (csrc/paged_split.cuh: K2 and K3;
K4's int8 cases, on this file's mirror, are in
test_torch_paged_split_q.py) on the CPU, where it cannot run: its split
plan (ops/paged_split.py, the very function that sets the grid) against
the JAX package's page map and
masks, and a torch mirror of the kernel's split arithmetic (per-split
partials, then the merge in split order) against the Pallas kernels in
interpret mode; and, for fault F1's repair, the plain decode, verify,
prefill and backward at head dims between the instantiated ones (hd 80
and 96) against the JAX functions, on the same numpy inputs."""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.ops import pallas_paged_attention as jpp
from infinistore_tpu.ops.pallas_flash_attention import (
    _flash_backward,
    flash_prefill_attention as jax_flash,
)
from infinistore_tpu_torch.ops import _kernels, paged_split
from infinistore_tpu_torch.ops import flash_attention as fa
from infinistore_tpu_torch.ops import paged_attention as tpa

SMS = 132  # an H100's SMs
TOL = 1e-5  # f32: summation order only


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---- the kernel's arithmetic, mirrored (csrc/paged_split.cu) -------------

def row_range(row, R, group, base, window, t_end, s_lo, s_hi):
    """paged_split.cu's row_range: the positions [lo, hi) that query row
    ``row`` keeps within the split [s_lo, s_hi)."""
    if row >= R:
        return 0, 0
    limit = base + row // group + 1
    hi = min(limit, t_end, s_hi)
    lo = max(max(limit - window, 0) if window > 0 else 0, s_lo)
    return lo, hi


def cta_range(plan, rt, split, R, group, base, window, t_end, page):
    """The positions [lo, hi) the CTA (row tile rt, split) walks, and its
    split's [s_lo, s_hi): from its first row's floor to its last row's
    limit within the split. The splits start at page 0, or with a window
    at the page of token 0's window floor."""
    first = max(base + 1 - window, 0) // page if window > 0 else 0
    s_lo = (first + split * plan.pages_per_split) * page
    s_hi = min(s_lo + plan.pages_per_split * page, t_end)
    r0 = rt * plan.row_tile
    lo, _ = row_range(r0, R, group, base, window, t_end, s_lo, s_hi)
    _, hi = row_range(min(r0 + plan.row_tile, R) - 1, R, group, base,
                      window, t_end, s_lo, s_hi)
    return lo, hi, s_lo, s_hi


# ---- the JAX package's masks and page map --------------------------------

def _jax_rule(seq_len, j, m, window, decode):
    """The JAX kernels' rule for token j: _kernel (decode: seq_len counts
    the current token) or _kernel_multi (token j sees < seq_len + j + 1).
    Returns (limit, low, page floor, live end): a page is live (the
    kernel's `live`) if it starts below the live end and, with a window,
    ends above the page floor; a position counts (_attend's `valid`) if
    low <= pos < limit."""
    limit = seq_len if decode else seq_len + j + 1
    low = max(limit - window, 0) if window else 0
    floor = (max(seq_len - window, 0) if decode
             else seq_len + 1 - window) if window else None
    return limit, low, floor, seq_len if decode else seq_len + m


def jax_kept_brute(seq_len, j, m, window, page, max_pages, decode):
    """The positions token j's rows keep in the JAX kernels, page by page
    and position by position."""
    limit, low, floor, live_end = _jax_rule(seq_len, j, m, window, decode)
    kept = []
    for p in range(max_pages):
        start = p * page
        if start < live_end and (floor is None or start + page > floor):
            kept.extend(pos for pos in range(start, start + page)
                        if low <= pos < limit)
    return (kept[0], kept[-1] + 1) if kept else (0, 0)


def jax_kept(seq_len, j, m, window, page, max_pages, decode):
    """jax_kept_brute's [lo, hi), from the ends of the live pages."""
    limit, low, floor, live_end = _jax_rule(seq_len, j, m, window, decode)
    first = 0 if floor is None else max(floor // page, 0)
    last = min((live_end - 1) // page, max_pages - 1)
    lo, hi = max(low, first * page), min(limit, (last + 1) * page)
    return (lo, hi) if lo < hi else (0, 0)


@pytest.mark.parametrize("decode,m", [(True, 1), (False, 5), (False, 64)])
def test_jax_kept_matches_the_kernels_rule(decode, m):
    """The closed form the plan test uses against the JAX kernels' rule
    applied page by page."""
    for sl, window, page, width in itertools.product(
            (0, 1, 15, 16, 17, 100, 131), (0, 1, 7, 40), (8, 16, 48),
            (1, 3, 12)):
        for j in range(m):
            assert jax_kept(sl, j, m, window, page, width, decode) == \
                jax_kept_brute(sl, j, m, window, page, width, decode)


def jax_last_used(lens, m, page, max_pages, decode):
    """The last page _make_page_idx lets the kernel fetch for each of
    ``lens``: its index for the table's last column over an identity
    table."""
    idx = jpp._make_page_idx(page, 1 << 20, 0 if decode else m)
    pt = jnp.tile(jnp.arange(max_pages, dtype=jnp.int32), (len(lens), 1))
    sl = jnp.asarray(lens, jnp.int32)
    return [int(idx(b, max_pages - 1, pt, sl)[0]) for b in range(len(lens))]


def _plan_cases():
    lens = (0, 1, 15, 16, 17, 1000, 4000, 32768)
    for page, m, group in itertools.product((8, 16, 48), (1, 5, 64, 512),
                                            (1, 4, 6, 7, 16)):
        yield page, m, group, lens


@pytest.mark.parametrize("page,m,group,lens", list(_plan_cases()))
def test_split_plan_covers_the_jax_masks(page, m, group, lens):
    """For every length, window (0, 1, 256) and table (tight, padded): the
    (row, position) pairs the JAX kernel keeps are each walked by exactly
    one CTA, in exactly one split; no CTA walks a pair the JAX kernel
    drops or reads a page past _make_page_idx's last used one; splits fall
    on page boundaries; with a window the splits cover only the pages the
    window can span; and the grid has two waves of CTAs on 132 SMs unless
    the splits are at their least size."""
    decode = m == 1
    R = m * group
    n_kv, batch = 2, len(lens)
    need = max(-(-(s + (0 if decode else m)) // page) for s in lens)
    for window, padded in itertools.product((0, 1, 256), (False, True)):
        max_pages = max(need, 1) + (3 if padded else 0)
        t_end = max_pages * page
        lasts = jax_last_used(lens, m, page, max_pages, decode)
        plan = paged_split.split_plan(batch, n_kv, R, max_pages, page, SMS,
                                      window, m)
        assert plan.row_tile % 16 == 0 and plan.row_tile <= 64
        assert plan.row_tiles * plan.row_tile >= R
        assert (plan.row_tiles - 1) * plan.row_tile < R
        if window:
            assert plan.span == min(max_pages,
                                    -(-(window + m - 1) // page) + 1)
        else:
            assert plan.span == max_pages
        assert plan.n_splits * plan.pages_per_split >= plan.span
        assert (plan.n_splits - 1) * plan.pages_per_split < plan.span
        ctas = batch * n_kv * plan.row_tiles
        least = -(-paged_split.SPLIT_MIN_TOKENS // page)
        if plan.n_splits * ctas < paged_split.SPLIT_WAVES * SMS:
            assert plan.pages_per_split <= least
        for sl, last in zip(lens, lasts):
            # Decode's lengths count the current token: less one.
            base = sl - 1 if decode else sl
            walks = {}
            for rt, split in itertools.product(range(plan.row_tiles),
                                               range(plan.n_splits)):
                lo, hi, s_lo, s_hi = cta_range(plan, rt, split, R, group,
                                               base, window, t_end, page)
                assert s_lo % page == 0
                if lo >= hi:
                    continue  # an empty partial
                assert (hi - 1) // page <= last
                r0 = rt * plan.row_tile
                for r in range(r0, min(r0 + plan.row_tile, R)):
                    a, b = row_range(r, R, group, base, window, t_end,
                                     s_lo, s_hi)
                    a, b = max(a, lo), min(b, hi)
                    if a < b:
                        walks.setdefault(r, []).append((a, b))
            kept = [jax_kept(sl, j, m, window, page, max_pages, decode)
                    for j in range(m)]
            for r in range(R):
                want = kept[r // group]
                got = sorted(walks.get(r, []))
                # Disjoint, gap-free runs that make up the JAX range.
                if want[0] >= want[1]:
                    assert got == [], (sl, window, r, got)
                    continue
                assert got[0][0] == want[0] and got[-1][1] == want[1], (
                    sl, window, r, got, want)
                for (_, b), (a, _) in zip(got, got[1:]):
                    assert a == b, (sl, window, r, got)


def test_split_plan_reads_no_device_value():
    """The plan is pure host arithmetic on ints: the wrappers pass it
    shapes only (seq_lens and the table stay on the card)."""
    plan = paged_split.split_plan(4, 8, 4, 130, 16, SMS)
    assert plan == paged_split.SplitPlan(4, 16, 1, 130, 15, 9)
    # With a 256 window the splits cut the 17 pages it can span.
    win = paged_split.split_plan(4, 8, 4, 130, 16, SMS, 256, 1)
    assert win.span == 17 and win.n_splits * win.pages_per_split >= 17
    # Phase 4's decode shape: 9 splits of 15 pages, 288 CTAs.
    assert plan.n_splits * 4 * 8 >= 2 * SMS
    long = paged_split.split_plan(1, 8, 4, 2048, 16, SMS)
    assert long.n_splits * 8 >= 2 * SMS
    chunk = paged_split.split_plan(1, 8, 2048, 130, 16, SMS)
    assert (chunk.row_tile, chunk.row_tiles) == (64, 32)
    empty = paged_split.split_plan(2, 2, 4, 0, 16, SMS)
    assert (empty.n_splits, empty.pages_per_split) == (1, 1)


def p_times_v(p, v, p_mode):
    """P' V in float32 as the kernel folds it: P' whole (``"f32"``: f32
    q), as two bf16 parts hi = bf16(P') and lo = bf16(P' - hi) (``"hilo"``:
    bf16 q over int8 pages), or rounded once to bf16 (``"once"``: K2's
    rounding, which over int8 pages would be another function)."""
    if p_mode == "hilo":
        hi = p.bfloat16().float()
        return hi @ v + (p - hi).bfloat16().float() @ v
    if p_mode == "once":
        return p.bfloat16().float() @ v
    return p @ v


def split_mirror(q, k_pages, v_pages, table, seq_lens, window, decode,
                 sms=SMS, scales=None, p_mode="f32"):
    """The kernel's function by its own split arithmetic, in float32:
    for each CTA (sequence, kv head, row tile, split) of the plan, the
    partial (m in log2 units, l, unnormalised acc) of its rows over the
    positions it walks (masked positions give p = 0; a CTA with no
    position writes l = 0 only), then each row's partials merged in
    split order, skipping l = 0; a row no split kept is 0. Used by the
    tests only, never by the wrapper. q: [B, m, H, D] ([B, H, D] with
    ``decode``). With ``scales`` = (k_s, v_s) the pages are int8 (K4):
    each token's logit takes its k scale, and P' = p v_s goes into P V
    by ``p_mode`` (:func:`p_times_v`). Returns float32 rows (before any
    cast to q's dtype) and the plan."""
    if decode:
        q = q[:, None]
    B, m, H, D = q.shape
    N, P, KV, _ = k_pages.shape
    W = table.shape[1]
    group, t_end = H // KV, W * P
    R = m * group
    plan = paged_split.split_plan(B, KV, R, W, P, sms, window, m)
    NS = plan.n_splits
    scale_log2 = D ** -0.5 * math.log2(math.e)
    ws_m = torch.full((B, KV, NS, R), float("nan"))
    ws_l = torch.full((B, KV, NS, R), float("nan"))
    ws_acc = torch.full((B, KV, NS, R, D), float("nan"))  # unwritten
    for b, kvh, rt, s in itertools.product(range(B), range(KV),
                                           range(plan.row_tiles), range(NS)):
        base = int(seq_lens[b]) - (1 if decode else 0)
        lo, hi, s_lo, s_hi = cta_range(plan, rt, s, R, group, base, window,
                                       t_end, P)
        r0 = rt * plan.row_tile
        rows = range(r0, min(r0 + plan.row_tile, R))
        if lo >= hi:
            for r in rows:
                ws_m[b, kvh, s, r], ws_l[b, kvh, s, r] = -1e30, 0.0
            continue
        pos = torch.arange(lo, hi)
        pid = table[b, pos // P].long().clamp(0, N - 1)
        k = k_pages[pid, pos % P, kvh].float()
        v = v_pages[pid, pos % P, kvh].float()
        for r in rows:
            a, z = row_range(r, R, group, base, window, t_end, s_lo, s_hi)
            keep = (pos >= a) & (pos < z)
            qr = q[b, r // group, kvh * group + r % group].float()
            x = k @ qr
            if scales is not None:
                x = x * scales[0][pid, pos % P, kvh]
            x = x * scale_log2
            mx = x[keep].max() if keep.any() else torch.tensor(-1e30)
            p = torch.where(keep, torch.exp2(x - mx), torch.zeros(()))
            ws_m[b, kvh, s, r], ws_l[b, kvh, s, r] = mx, p.sum()
            if scales is not None:
                p = p * scales[1][pid, pos % P, kvh]
            ws_acc[b, kvh, s, r] = p_times_v(p, v, p_mode)
    out = torch.empty(B, m, H, D)
    for b, kvh, r in itertools.product(range(B), range(KV), range(R)):
        live = [s for s in range(NS) if ws_l[b, kvh, s, r] > 0]
        row = torch.zeros(D)
        if live:
            M = max(ws_m[b, kvh, s, r] for s in live)
            L = torch.zeros(())
            for s in live:  # split order
                f = torch.exp2(ws_m[b, kvh, s, r] - M)
                L = L + ws_l[b, kvh, s, r] * f
                row = row + ws_acc[b, kvh, s, r] * f
            row = row / L
        out[b, r // group, kvh * group + r % group] = row
    return (out[:, 0] if decode else out), plan


def _paged_inputs(seed, batch, m, heads, kv_heads, hd, page, width,
                  seq_lens, decode):
    """Random q and pages; a table of distinct shuffled ids, padded past
    each row's pages with -1 and n_pages + 5 in turn."""
    rng = np.random.default_rng(seed)
    n_pages = batch * width + 4
    q = _np(rng, batch, heads, hd) if decode else \
        _np(rng, batch, m, heads, hd)
    kp = _np(rng, n_pages, page, kv_heads, hd)
    vp = _np(rng, n_pages, page, kv_heads, hd)
    table = rng.permutation(n_pages)[:batch * width].reshape(
        batch, width).astype(np.int32)
    for b, sl in enumerate(seq_lens):
        used = min(-(-(sl + (0 if decode else m)) // page), width)
        table[b, used:] = np.where(np.arange(width - used) % 2,
                                   n_pages + 5, -1)
    return q, kp, vp, table, np.asarray(seq_lens, dtype=np.int32)


MIRROR_CASES = [
    # (decode, m, heads, kv_heads, hd, page, lens, window, table width
    # less the pages the longest row needs, sms)
    (True, 1, 8, 2, 32, 16, (1, 15, 16, 17, 300), 0, 0, SMS),
    (True, 1, 8, 2, 32, 8, (1, 17, 200, 90), 40, 2, SMS),
    (True, 1, 6, 1, 32, 48, (0, 5, 400, 97), 0, 1, SMS),    # a 0 length
    (True, 1, 14, 2, 16, 16, (33, 260), 1, 0, SMS),        # group 7, w 1
    (True, 1, 16, 1, 32, 16, (500, 1), 0, 3, 4),           # group 16
    (True, 1, 4, 4, 80, 16, (70, 150), 0, 0, SMS),         # hd 80
    (False, 5, 8, 2, 32, 16, (1, 15, 16, 17, 300), 0, 0, SMS),
    (False, 5, 8, 2, 32, 8, (0, 19, 200), 64, 1, SMS),
    (False, 5, 12, 2, 16, 48, (3, 150), 0, 2, SMS),        # group 6
    (False, 64, 4, 2, 32, 16, (0, 100, 37), 0, 0, SMS),
    (False, 64, 4, 2, 32, 8, (10, 130), 24, 1, 8),
    (False, 512, 2, 2, 16, 16, (0, 40), 0, 0, SMS),        # a chunk
    # Windows that span several splits, counted from the floor's page.
    (True, 1, 8, 2, 32, 16, (1, 17, 400, 700), 300, 1, SMS),
    (False, 5, 8, 2, 32, 16, (3, 250, 500), 200, 0, SMS),
    (False, 3, 7, 1, 96, 16, (5, 60), 0, 0, SMS),          # hd 96, g 7
    # New tokens past the table's end, and rows whose window floor lies
    # at or past it: no position at all.
    (False, 6, 4, 2, 32, 8, (4, 21), 0, -1, SMS),
    (False, 4, 4, 2, 32, 8, (30, 40), 2, -2, SMS),
]


@pytest.mark.parametrize("case", MIRROR_CASES)
def test_split_mirror_matches_pallas(case):
    """The mirror of the kernel's split arithmetic against
    paged_flash_decode / paged_flash_verify in interpret mode at f32, on
    the same inputs: per-split partials, empty splits and the in-order
    merge give the JAX kernel's rows; a row with no position to attend
    (the JAX kernel's 0 / 0) comes out 0."""
    decode, m, H, KV, D, P, lens, window, pad, sms = case
    need = max(-(-(s + (0 if decode else m)) // P) for s in lens)
    width = need + pad
    q, kp, vp, table, sl = _paged_inputs(
        sum(lens) + m, len(lens), m, H, KV, D, P, width, lens, decode)
    got, plan = split_mirror(*(torch.from_numpy(a)
                               for a in (q, kp, vp, table, sl)),
                             window, decode, sms)
    jfn = jpp.paged_flash_decode if decode else jpp.paged_flash_verify
    want = np.asarray(jfn(*(jnp.asarray(a) for a in (q, kp, vp, table, sl)),
                          interpret=True, window=window))
    # Rows with no position to attend: the JAX kernels give 0 / 0 (no
    # live page) or the mean of V over the pages they folded (all logits
    # masked), the split kernel 0.
    empty = np.array([[jax_kept(s, j, m, window, P, width, decode)[1] == 0
                       for j in range(m)] for s in lens])
    empty = np.broadcast_to(empty[:, :, None], (len(lens), m, H))
    got = got.numpy()
    if decode:
        empty = empty[:, 0]
    np.testing.assert_allclose(got[~empty], want[~empty], rtol=TOL,
                               atol=TOL)
    assert np.all(got[empty] == 0)
    assert not np.isnan(want[~empty]).any()


def test_split_mirror_has_empty_splits_and_several_splits():
    """The mirror cases reach what the kernel must get right: more than
    one split, splits wholly past a short sequence, and rows with no
    position anywhere."""
    decode, m, H, KV, D, P, lens, window, pad, sms = MIRROR_CASES[0]
    plan = paged_split.split_plan(len(lens), KV, H // KV, -(-300 // P),
                                  P, sms)
    assert plan.n_splits > 1
    lo, hi, _, _ = cta_range(plan, 0, plan.n_splits - 1, H // KV, H // KV,
                             0, 0, 19 * P, P)
    assert lo >= hi  # the last split of the 1-token sequence is empty
    # The windowed cases: several splits from the floor's page, whose
    # first split starts past page 0 for the long sequences.
    for case in MIRROR_CASES:
        decode, m, H, KV, D, P, lens, window, pad, sms = case
        if window < 200:
            continue
        width = max(-(-(s + (0 if decode else m)) // P) for s in lens) + pad
        plan = paged_split.split_plan(len(lens), KV, m * (H // KV), width,
                                      P, sms, window, m)
        assert plan.n_splits > 1 and plan.span < width
        base = max(lens) - (1 if decode else 0)
        _, _, s_lo, _ = cta_range(plan, 0, 0, m * (H // KV), H // KV, base,
                                  window, width * P, P)
        assert s_lo > 0


# ---- F1: head dims between the instantiated ones --------------------------

@pytest.mark.parametrize("hd", [80, 96])
@pytest.mark.parametrize("window", [0, 5])
def test_f1_decode_plain_matches_pallas(hd, window):
    """The plain decode at phi-2's and Phi-3-mini's head dims (the JAX
    kernel pads them to 128 lanes and scales by the real hd)."""
    lens = (8, 16, 17, 1)
    q, kp, vp, table, sl = _paged_inputs(hd + window, 4, 1, 8, 2, hd, 8, 6,
                                         lens, True)
    got = tpa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, sl)),
        window=window).numpy()
    want = np.asarray(jpp.paged_flash_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, table, sl)), interpret=True,
        window=window))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [80, 96])
@pytest.mark.parametrize("window", [0, 12])
def test_f1_verify_plain_matches_pallas(hd, window):
    lens = (3, 17, 30)
    q, kp, vp, table, sl = _paged_inputs(hd * 3 + window, 3, 4, 8, 2, hd, 8,
                                         6, lens, False)
    got = tpa.multi_token_paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, sl)),
        window=window).numpy()
    want = np.asarray(jpp.paged_flash_verify(
        *(jnp.asarray(a) for a in (q, kp, vp, table, sl)), interpret=True,
        window=window))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [80, 96])
@pytest.mark.parametrize("s_q,s_kv,window", [(40, 40, 0), (24, 70, 16)])
def test_f1_prefill_plain_matches_pallas(hd, s_q, s_kv, window):
    rng = np.random.default_rng(hd + s_kv)
    q, k, v = _np(rng, 1, s_q, 8, hd), _np(rng, 1, s_kv, 2, hd), \
        _np(rng, 1, s_kv, 2, hd)
    got = tpa.prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=True, window=window).numpy()
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, interpret=True,
                                window=window))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [80, 96])
@pytest.mark.parametrize("s_q,s_kv,window", [(64, 96, 0), (72, 72, 24)])
def test_f1_backward_plain_matches_pallas(hd, s_q, s_kv, window):
    """flash_bwd_dq_plain / flash_bwd_dkv_plain against _flash_backward in
    interpret mode at hd 80 and 96, given the same o, lse and
    cotangent."""
    rng = np.random.default_rng(hd * 7 + s_kv)
    q, k, v = _np(rng, 1, s_q, 4, hd), _np(rng, 1, s_kv, 2, hd), \
        _np(rng, 1, s_kv, 2, hd)
    g = _np(rng, 1, s_q, 4, hd)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = fa.flash_forward_lse_plain(tq, tk, tv, True, window)
    dvec = (tg * o).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq_plain(tq, tk, tv, tg, lse, dvec, True, window)
    dk, dv = fa.flash_bwd_dkv_plain(tq, tk, tv, tg, lse, dvec, True, window)
    jdq, jdk, jdv = _flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(g),
        True, True, block_q=128, block_k=128, window=window)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_kernel_head_dim_and_scale():
    """Each head dim runs at the least instantiation at or above it, with
    the softmax scale of its own hd, as the JAX kernels take it."""
    assert [_kernels.kernel_head_dim(h) for h in (8, 16, 32, 40, 64, 80,
                                                  96, 128, 136, 256)] == \
        [32, 32, 32, 64, 64, 128, 128, 128, 256, 256]
    assert _kernels.softmax_scale(80) == pytest.approx(80 ** -0.5)

"""K4, the split-K paged kernel over int8 pages (csrc/paged_split_q.cu
over csrc/paged_split.cuh), on the CPU, where it cannot run: the torch
mirror of the kernel's split arithmetic (test_torch_paged_split.py's
split_mirror with int8 pages: the splits, each token's k scale on its
logit, P' = p v_s, for bf16 q P' as two bf16 parts hi + lo, the merge in
split order) against ``paged_flash_decode_quantized`` in interpret mode
on the same numpy inputs; the hi/lo split against the float32 fold; and
the wrapper's split plan, taken from shapes alone.

Tolerances (largest relative L2 error over the output rows, as
chip_smoke.py holds the kernel): float32 q 1e-5 (summation order only);
bf16 q 1.5e-2 (the output is rounded to bf16 from two float32 folds
that sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.ops import kv_quant as jq
from infinistore_tpu.ops import pallas_paged_attention as jpp
from infinistore_tpu_torch.ops import _kernels, paged_split
from infinistore_tpu_torch.ops import paged_flash_decode_q as pq
from test_torch_paged_split import SMS, cta_range, split_mirror

TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}
# chip_smoke.py's DECODE_SEQ_LENS: one token, a page's edges, long rows.
DECODE_SEQ_LENS = (1, 15, 16, 17, 1000, 2048, 2049, 4000)


def _int8_inputs(seed, dtype, lens, heads, kv_heads, hd, page, pad):
    """numpy q (float32 values of ``dtype``), int8 pages and their scales
    quantized by the JAX package from rows of varied scale (as real KV
    has), a table of distinct shuffled ids padded past each row's pages
    with -1 and n_pages + 5 in turn (``pad`` columns past the longest
    row's), and the lengths."""
    rng = np.random.default_rng(seed)
    width = max(-(-s // page) for s in lens) + pad
    n_pages = len(lens) * width + 4

    def pages():
        x = rng.standard_normal((n_pages, page, kv_heads, hd)) * np.exp(
            0.5 * rng.standard_normal((n_pages, page, kv_heads, 1)))
        return [np.asarray(a) for a in
                jq.quantize_kv_pages(jnp.asarray(x.astype(np.float32)))]

    q = np.asarray(jnp.asarray(
        rng.standard_normal((len(lens), heads, hd)).astype(np.float32))
        .astype(getattr(jnp, dtype)).astype(jnp.float32))
    k_q, k_s = pages()
    v_q, v_s = pages()
    table = rng.permutation(n_pages)[:len(lens) * width].reshape(
        len(lens), width).astype(np.int32)
    for b, sl in enumerate(lens):
        used = -(-sl // page)
        table[b, used:] = np.where(np.arange(width - used) % 2,
                                   n_pages + 5, -1)
    return q, k_q, k_s, v_q, v_s, table, np.asarray(lens, np.int32)


def _torch(arrays, dtype):
    q, *rest = (torch.from_numpy(np.array(a)) for a in arrays)
    return [q.to(getattr(torch, dtype)), *rest]


def _rel(got, want):
    """Largest relative L2 error over the rows."""
    got = np.asarray(got, np.float32).reshape(-1, got.shape[-1])
    want = np.asarray(want, np.float32).reshape(-1, want.shape[-1])
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


INT8_CASES = [
    # (dtype, heads, kv_heads, hd, lens, window, table pad, sms)
    ("float32", 4, 1, 128, DECODE_SEQ_LENS, 0, 2, SMS),       # group 4
    ("bfloat16", 4, 1, 128, DECODE_SEQ_LENS, 256, 2, SMS),
    ("float32", 16, 1, 256, DECODE_SEQ_LENS, 256, 1, SMS),    # group 16
    ("bfloat16", 16, 1, 256, DECODE_SEQ_LENS, 0, 1, SMS),
    ("float32", 6, 1, 80, (5, 300, 700), 0, 3, SMS),          # group 6
    ("bfloat16", 12, 2, 80, (1, 15, 400), 256, 2, SMS),
    ("float32", 7, 1, 96, (1, 260, 513), 256, 2, SMS),        # group 7
    ("bfloat16", 7, 1, 96, (17, 1000), 0, 0, 4),              # few SMs
    ("float32", 2, 2, 128, (33, 600), 0, 1, SMS),             # group 1
    ("bfloat16", 2, 2, 96, (16, 700), 256, 0, SMS),
    ("bfloat16", 8, 2, 128, (1, 2, 3), 0, 2, SMS),            # 1 page
]


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_split_mirror_matches_pallas(case):
    """The int8 mirror of the kernel's split arithmetic (f32 q: P' whole;
    bf16 q: P' as hi + lo) against paged_flash_decode_quantized in
    interpret mode, on the same inputs, at chip_smoke.py's tolerances."""
    dtype, H, KV, D, lens, window, pad, sms = case
    P = 16
    arrays = _int8_inputs(sum(lens) + H + D, dtype, lens, H, KV, D, P, pad)
    q, k_q, k_s, v_q, v_s, table, sl = _torch(arrays, dtype)
    got, plan = split_mirror(q, k_q, v_q, table, sl, window, True, sms,
                             scales=(k_s, v_s),
                             p_mode="hilo" if dtype == "bfloat16" else "f32")
    got = got.to(q.dtype).float().numpy()
    jargs = [jnp.asarray(a) for a in arrays]
    jargs[0] = jargs[0].astype(getattr(jnp, dtype))
    want = np.asarray(jpp.paged_flash_decode_quantized(
        *jargs, interpret=True, window=window).astype(jnp.float32))
    assert not np.isnan(want).any()
    assert _rel(got, want) <= TOL[dtype], _rel(got, want)


def test_int8_cases_reach_several_and_empty_splits():
    """The cases take several splits, and some of their CTAs have no
    position (a short sequence's splits past its last page): the kernel's
    empty partials (l = 0) and the merge are in the mirror's path."""
    several = empty = 0
    for dtype, H, KV, D, lens, window, pad, sms in INT8_CASES:
        P = 16
        width = max(-(-s // P) for s in lens) + pad
        plan = paged_split.split_plan(len(lens), KV, H // KV, width, P, sms,
                                      window, 1)
        several += plan.n_splits > 1
        for sl in lens:
            for split in range(plan.n_splits):
                lo, hi, _, _ = cta_range(plan, 0, split, H // KV, H // KV,
                                         sl - 1, window, width * P, P)
                empty += lo >= hi
    assert several >= 8 and empty > 0


def test_bf16_fold_keeps_p_to_f32_precision():
    """The design's hold on P: for bf16 q the mirror's rows before their
    cast (P' as hi + lo) are within 1e-4 of the float32 fold, while P'
    rounded once to bf16 (as K2 rounds P over bf16 pages) is not. On the
    card a dropped lo hides under the 1.5e-2 gate of a bf16 output; this
    is what shows it."""
    lens = (544, 1056, 1568, 2080)  # phase 4's decode lengths
    arrays = _int8_inputs(11, "bfloat16", lens, 4, 1, 128, 16, 0)
    q, k_q, k_s, v_q, v_s, table, sl = _torch(arrays, "bfloat16")
    rows = {mode: split_mirror(q, k_q, v_q, table, sl, 0, True,
                               scales=(k_s, v_s), p_mode=mode)[0].numpy()
            for mode in ("f32", "hilo", "once")}
    assert _rel(rows["hilo"], rows["f32"]) <= 1e-4
    assert _rel(rows["once"], rows["f32"]) > 1e-4
    # And the f32 fold is the JAX kernel's, before its cast to bf16.
    jargs = [jnp.asarray(a) for a in arrays]
    want = np.asarray(jpp.paged_flash_decode_quantized(*jargs,
                                                       interpret=True))
    assert _rel(rows["f32"], want) <= 1e-5


def test_decode_q_wrapper_plans_without_reading_a_device_value(monkeypatch):
    """K4's wrapper takes its split plan from shapes alone, as K2's does:
    on meta tensors (which hold no values to read) it hands the C entry
    point the plan of split_plan and a workspace for the merge."""
    calls = []

    class Lib:
        def istpu_paged_decode_q(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_kernels, "lib", Lib)
    monkeypatch.setattr(_kernels, "sm_count", lambda device: SMS)
    monkeypatch.setattr(_kernels, "stream_handle", lambda device: None)
    monkeypatch.setattr(pq, "check_args", lambda *args: None)
    meta = dict(device="meta")
    # Phase 3b's main-path shape: batch 4, 32 / 8 heads, hd 128, a
    # 132-page table of 16-token pages.
    q = torch.empty(4, 32, 128, dtype=torch.bfloat16, **meta)
    k_q = torch.empty(600, 16, 8, 128, dtype=torch.int8, **meta)
    k_s = torch.empty(600, 16, 8, **meta)
    table = torch.empty(4, 132, dtype=torch.int32, **meta)
    lens = torch.empty(4, dtype=torch.int32, **meta)
    launches = pq.launches
    out = pq.paged_flash_decode_quantized(q, k_q, k_s, k_q, k_s, table,
                                          lens)
    assert out.shape == q.shape and pq.launches == launches + 1
    plan = paged_split.split_plan(4, 8, 4, 132, 16, SMS, 0, 1)
    assert plan == paged_split.plan_of(q, k_q, table, 0, 1, SMS)
    assert plan.n_splits > 1
    (args,) = calls
    assert args[10:16] == (1, 4, 32, 8, 128,
                           pytest.approx(_kernels.softmax_scale(128)))
    assert args[16:23] == (600, 16, 132, 0, plan.row_tile, plan.n_splits,
                           plan.pages_per_split)
    # 4 x 8 x 4 row partials in each split: (m, l), then acc[128].
    ws_ml, ws_acc = args[8:10]
    assert ws_acc - ws_ml == 8 * 4 * 8 * plan.n_splits * 4
    # A windowed launch plans the window's pages only.
    calls.clear()
    pq.paged_flash_decode_quantized(q, k_q, k_s, k_q, k_s, table, lens,
                                    window=256)
    win = paged_split.split_plan(4, 8, 4, 132, 16, SMS, 256, 1)
    assert calls[0][19:23] == (256, win.row_tile, win.n_splits,
                               win.pages_per_split)
    assert win.span == 17


def test_int8_entry_point_argtypes_match_the_launch():
    """The C entry point's declared argtypes (ops/_kernels.py) take the
    split arguments, as istpu_paged_decode's do, plus the two scales."""
    decl = _kernels._DECLS["istpu_paged_decode_q"]
    k2 = _kernels._DECLS["istpu_paged_decode"]
    assert len(decl) == len(k2) + 2
    # q, k_q, k_s, v_q, v_s, ...: K2's with k_s and v_s after the pages.
    assert decl[:2] + decl[3:4] + decl[5:] == k2
    assert decl[2] is decl[4] is _kernels._P

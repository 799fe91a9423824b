"""The split-K paged attention kernel (``csrc/paged_split.cuh``) from the
host: its split plan, and the launch that K2 (:mod:`.paged_flash_decode`),
K3 (:mod:`.paged_flash_verify`) and K4 (:mod:`.paged_flash_decode_q`,
over int8 pages) share.

A CTA of the kernel owns one (sequence, kv head, tile of query rows,
split of the pages). :func:`split_plan` sizes the tiles and the splits
from values the host already has (batch, kv heads, query rows, table
width, page size, window, SM count): it never reads ``seq_lens`` or the
table, so a launch adds no device sync. With a window, the splits cut
only the pages a sequence's window can span, counted from the page of
its window floor (which the kernel finds from ``seq_lens``), so no split
lies wholly below the floor. The CPU tests hold this very
function against the JAX package's page map and masks.
"""

import collections
import functools

import torch

from . import _kernels

# Splits aim at this many waves of CTAs over the card's SMs...
SPLIT_WAVES = 2
# ...but no split holds fewer positions than this (two 64-token tiles),
# so that its ring of loads has something to overlap.
SPLIT_MIN_TOKENS = 128
# Query rows a CTA holds at most (tensor-core tiles of 16 rows).
MAX_ROW_TILE = 64

SplitPlan = collections.namedtuple(
    "SplitPlan", "rows row_tile row_tiles span pages_per_split n_splits")
SplitPlan.__doc__ = """The grid of one launch: each kv head's ``rows``
(m x group, token-major) in ``row_tiles`` tiles of ``row_tile`` rows,
and the ``span`` pages a sequence's rows can keep (the table's width;
with a window, the pages from the window floor's) in ``n_splits`` runs
of ``pages_per_split`` pages; the grid is (n_splits, row_tiles * n_kv,
batch) CTAs."""

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def window_span(max_pages, page, window, m):
    """The pages a sequence's m query tokens can keep: the table's width,
    or with a window the pages from the window floor's to the last
    token's, at most ceil((window + m - 1) / page) + 1 (csrc/paged_split.cu
    computes the same)."""
    if window <= 0:
        return max_pages
    return min(max_pages, (window + m + page - 2) // page + 1)


@functools.lru_cache(maxsize=256)
def split_plan(batch, n_kv, rows, max_pages, page, sms, window=0, m=1):
    """The split plan of a launch over ``batch`` sequences, ``n_kv`` kv
    heads of ``rows`` query rows each (``m`` tokens of the group), a
    table ``max_pages`` pages wide of ``page`` positions and a sliding
    ``window`` (0: none), on a card of ``sms`` SMs."""
    row_tile = min(MAX_ROW_TILE, 16 * -(-rows // 16))
    row_tiles = -(-rows // row_tile)
    span = window_span(max_pages, page, window, m)
    if span <= 0:
        return SplitPlan(rows, row_tile, row_tiles, span, 1, 1)
    ctas = batch * n_kv * row_tiles
    min_pages = -(-SPLIT_MIN_TOKENS // page)
    most = -(-span // min_pages)
    want = -(-SPLIT_WAVES * sms // ctas)
    n_splits = max(1, min(want, most))
    pages_per_split = -(-span // n_splits)
    n_splits = -(-span // pages_per_split)
    return SplitPlan(rows, row_tile, row_tiles, span, pages_per_split,
                     n_splits)


def plan_of(q, k_pages, page_table, window, m, sms):
    """The split plan of a launch from its tensors' shapes alone (no
    tensor value is read): q [batch, (m,) n_heads, hd], pages [n_pages,
    page, n_kv, hd], page_table [batch, max_pages]."""
    n_kv = k_pages.shape[2]
    return split_plan(q.shape[0], n_kv, m * (q.shape[-2] // n_kv),
                      page_table.shape[1], k_pages.shape[1], sms,
                      int(window), m)


def check_args(name, q, k_pages, v_pages, page_table, seq_lens):
    """What both entry points take: one CUDA device, contiguous and
    16-byte aligned; q and the pages one dtype, bf16 or float32; the
    shape rule of :func:`_kernels.check_head_shape`; int32 table and
    lengths."""
    _kernels.check_head_shape(q.shape[-1], q.shape[-2], k_pages.shape[2],
                              name)
    dev = q.device
    for arg, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                   ("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{arg} must be a CUDA tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    for arg, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{arg} must be 16-byte aligned")
        if t.dtype != q.dtype:
            raise TypeError(f"{arg} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} (need bf16 or f32)")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    batch, hd = q.shape[0], q.shape[-1]
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != hd:
        raise ValueError("page shapes do not agree with q")
    if page_table.dim() != 2 or page_table.shape[0] != batch:
        raise ValueError("page_table must be [batch, max_pages]")
    if seq_lens.shape != (batch,):
        raise ValueError("seq_lens must be [batch]")


def launch(entry, q, k_pages, v_pages, page_table, seq_lens, window, m,
           scales=None):
    """Launch the kernel through C entry point ``entry``
    (``istpu_paged_decode`` or, over int8 pages with ``scales`` = (k_s,
    v_s), ``istpu_paged_decode_q``: q [batch, H, D], m = 1; or
    ``istpu_paged_verify``: q [batch, m, H, D]) into a new tensor of q's
    shape, and return it. The merge's workspace, with more than one
    split, comes from ``torch.empty``: the kernel allocates nothing."""
    batch, n_heads, hd = q.shape[0], q.shape[-2], q.shape[-1]
    n_pages, page, n_kv, _ = k_pages.shape
    max_pages = page_table.shape[1]
    plan = plan_of(q, k_pages, page_table, window, m,
                   _kernels.sm_count(q.device))
    out = torch.empty_like(q)
    ws_ml = ws_acc = None
    if plan.n_splits > 1:
        # One allocation: each partial row's (m, l), then its acc rows.
        parts = batch * n_kv * plan.n_splits * plan.rows
        ws = torch.empty(parts * (hd + 2), dtype=torch.float32,
                         device=q.device)
        ws_ml = ws.data_ptr()
        ws_acc = ws_ml + 8 * parts
    pages = (k_pages.data_ptr(), v_pages.data_ptr()) if scales is None \
        else (k_pages.data_ptr(), scales[0].data_ptr(), v_pages.data_ptr(),
              scales[1].data_ptr())
    dims = (batch, n_heads, n_kv, hd) if q.dim() == 3 \
        else (batch, m, n_heads, n_kv, hd)
    err = getattr(_kernels.lib(), entry)(
        q.data_ptr(), *pages, page_table.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), ws_ml, ws_acc, _DTYPES[q.dtype], *dims,
        _kernels.softmax_scale(hd), n_pages, page, max_pages, int(window),
        plan.row_tile, plan.n_splits, plan.pages_per_split,
        _kernels.stream_handle(q.device),
    )
    _kernels.check(err, entry)
    return out

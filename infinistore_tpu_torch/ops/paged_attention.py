"""Paged-KV attention ops in plain PyTorch.

The counterpart of ``infinistore_tpu/ops/paged_attention.py``. These are
the CPU path of the port and the oracle its CUDA kernels are held to:
``flash_prefill``, ``decode_attention`` and ``verify_attention`` take
these functions for CPU tensors and a hand-written kernel for CUDA
tensors.

Precision follows the JAX package's ``matmul_precision``: float32 stays
true float32 (no TF32 — the entry points switch TF32 off), and bf16
operands are multiplied in float32 with a float32 sum, as the TPU's
matrix unit does with ``preferred_element_type=f32``.
"""

import torch

_NEG_INF = -1e30


def gather_pages(pages, page_indices):
    """pages: [n_pages, page, ...]; page_indices: [batch, pages_per_seq]
    -> [batch, pages_per_seq, page, ...]. Out-of-range ids are clamped
    into the pool, as the decode kernel clamps them (indexing would raise
    on them; a table padded with -1 or past-the-pool ids reads page 0 or
    the last page, and the length mask hides those rows)."""
    return pages[page_indices.long().clamp(0, pages.shape[0] - 1)]


def _drop_mode_index(idx, size):
    """JAX's ``mode="drop"`` on one index dim: negative ids in
    [-size, -1] wrap, everything else outside [0, size) is dropped.
    Returns (wrapped ids, in-range mask)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + size, idx)
    return idx, (idx >= 0) & (idx < size)


def drop_mode_rows(page_indices, start_in_page, n_pages, page_size):
    """Which scatter entries land, and where: (entries, rows), where
    ``entries`` index the flattened [batch * m] entries that are in range
    and ``rows`` are their rows in the pool flattened to
    [n_pages * page_size, ...]. One host sync (the nonzero), so a caller
    that scatters into many layers with the same targets computes this
    once."""
    pg, ok_p = _drop_mode_index(page_indices, n_pages)
    sl, ok_s = _drop_mode_index(start_in_page, page_size)
    entries = torch.nonzero((ok_p & ok_s).reshape(-1)).reshape(-1)
    rows = (pg * page_size + sl).reshape(-1)[entries]
    return entries, rows


def scatter_rows(pages, new_kv, entries, rows):
    """Write the ``entries`` of ``new_kv`` [batch, m, n_kv, hd] into
    ``pages`` [n_pages, page, n_kv, hd] at flat ``rows`` (from
    :func:`drop_mode_rows`), IN PLACE; returns ``pages``."""
    flat = new_kv.reshape(-1, *new_kv.shape[2:])
    pages.view(-1, *pages.shape[2:]).index_copy_(
        0, rows, flat.index_select(0, entries).to(pages.dtype))
    return pages


def scatter_kv_multi(pages, new_kv, page_indices, start_in_page):
    """Write ``new_kv`` [batch, m, n_kv, hd] into ``pages``
    [n_pages, page, n_kv, hd] at (page_indices[b, j], start_in_page[b, j]).

    IN PLACE: ``pages`` is updated and returned (the JAX version returns
    a new array). Targets outside the pool are dropped, as JAX's
    ``mode="drop"`` drops them; ``index_put_`` has no drop mode, so they
    are filtered out first."""
    entries, rows = drop_mode_rows(page_indices, start_in_page,
                                   pages.shape[0], pages.shape[1])
    return scatter_rows(pages, new_kv, entries, rows)


def scatter_kv_to_pages(pages, new_kv, page_indices, start_in_page):
    """One decode step per sequence: ``new_kv`` [batch, 1, n_kv, hd]
    goes to (page_indices[b], start_in_page[b]). In place, drop mode —
    see :func:`scatter_kv_multi`."""
    return scatter_kv_multi(
        pages, new_kv, page_indices[:, None], start_in_page[:, None]
    )


def _repeat_kv(x, n_rep):
    """GQA: [..., n_kv, hd] -> [..., n_kv * n_rep, hd]."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=-2)


def check_causal(q, k, causal):
    """Causal attention over fewer keys than queries has no diagonal."""
    if causal and k.shape[1] < q.shape[1]:
        raise ValueError(
            f"causal attention needs kv_len >= q_len, got "
            f"{k.shape[1]} < {q.shape[1]}"
        )


def causal_mask(s_q, s_kv, window, device):
    """[s_q, s_kv] bool: query i keeps key j when j <= i + (s_kv - s_q)
    (the diagonal shifted by a cached prefix) and, with window > 0,
    j > i + (s_kv - s_q) - window."""
    pos_q = torch.arange(s_q, device=device)[:, None]
    pos_k = torch.arange(s_kv, device=device)[None, :]
    mask = pos_k <= pos_q + (s_kv - s_q)
    if window:
        mask &= pos_k > pos_q + (s_kv - s_q) - window
    return mask


def prefill_attention(q, k, v, causal=True, window=0):
    """Dense causal attention for prefill.

    q: [batch, s_q, heads, hd]; k/v: [batch, s_kv, kv_heads, hd] (GQA).
    s_kv may exceed s_q (suffix queries over a cached prefix): the causal
    diagonal shifts right by s_kv - s_q. window > 0 adds the sliding
    band: each query sees at most the last ``window`` positions,
    itself included. Returns [batch, s_q, heads, hd] in q's dtype."""
    check_causal(q, k, causal)
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], window, q.device)
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def multi_token_paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                                window=0):
    """m-token attention over paged KV: the verify step of speculative
    decoding and the inner op of chunked prefill.

    q: [batch, m, n_heads, hd], m new tokens per sequence whose KV is
    already scattered into the pages at positions seq_lens[b] + j;
    k_pages/v_pages: [n_pages, page, n_kv, hd]; page_table: [batch,
    max_pages] int32 (ids clamped into the pool); seq_lens: [batch] int32,
    tokens in the cache BEFORE these m, so token j sees positions
    < seq_lens[b] + j + 1 and, with a window, >= that limit - window.
    Returns [batch, m, n_heads, hd]."""
    batch, m, n_heads, hd = q.shape
    page = k_pages.shape[1]
    n_kv = k_pages.shape[2]
    max_pages = page_table.shape[1]
    n_rep = n_heads // n_kv

    k = gather_pages(k_pages, page_table).reshape(
        batch, max_pages * page, n_kv, hd)
    v = gather_pages(v_pages, page_table).reshape(
        batch, max_pages * page, n_kv, hd)
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    logits = torch.einsum("bmhd,bthd->bhmt", q.float(), k.float()) \
        * hd ** -0.5
    t_pos = torch.arange(max_pages * page, device=q.device)[None, None, :]
    limit = (seq_lens.long()[:, None]
             + torch.arange(m, device=q.device)[None, :] + 1)[..., None]
    valid = t_pos < limit  # [b, m, T]
    if window:
        valid &= t_pos >= limit - window
    logits = logits.masked_fill(~valid[:, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhmt,bthd->bmhd", probs.float(), v.float())
    return out.to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens,
                           window=0):
    """Single-token decode attention over paged KV.

    q: [batch, n_heads, hd]; k_pages/v_pages: [n_pages, page, n_kv, hd];
    page_table: [batch, max_pages] int32 (padded arbitrarily: ids are
    clamped); seq_lens: [batch] int32, valid tokens per sequence
    including the current one. Returns [batch, n_heads, hd]."""
    batch, n_heads, hd = q.shape
    page = k_pages.shape[1]
    n_kv = k_pages.shape[2]
    max_pages = page_table.shape[1]
    n_rep = n_heads // n_kv

    k = gather_pages(k_pages, page_table).reshape(
        batch, max_pages * page, n_kv, hd)
    v = gather_pages(v_pages, page_table).reshape(
        batch, max_pages * page, n_kv, hd)
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    logits = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * hd ** -0.5
    positions = torch.arange(max_pages * page, device=q.device)[None, :]
    sl = seq_lens.long()[:, None]
    valid = positions < sl
    if window:  # the current token is at seq_lens - 1: band floor
        valid &= positions >= sl - window
    logits = logits.masked_fill(~valid[:, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bht,bthd->bhd", probs.float(), v.float())
    return out.to(q.dtype)

"""Paged flash-decode attention over int8 pages (K4): the split-K CUDA
kernel (``csrc/paged_split_q.cu`` over ``csrc/paged_split.cuh``, the
kernel of K2 and K3 with int8 pages and their scales), its plain version
and its dispatcher.

Counterpart of ``infinistore_tpu/ops/pallas_paged_attention.py``
(``paged_flash_decode_quantized`` / ``decode_attention_quantized`` /
``decode_attention_quantized_tp``).
Pages stay int8 with one f32 scale per (token, kv head)
(``ops/kv_quant.py``); the kernel computes the TPU kernel's float32 fold
(q, the dequantized pages, the softmax and P.V, P not rounded to q's
type) and casts the output to q's type. Its split plan is K2's
(``ops/paged_split.py``, from shapes only).

- :func:`paged_decode_quantized_plain` is the kernel's own function in
  plain PyTorch, its oracle on the card.
- :func:`decode_attention_quantized`: a CUDA tensor launches the kernel
  or raises (no fallback); a CPU tensor takes the JAX package's off-TPU
  route (gather the table's pages, dequantize them to q's dtype, then
  the plain paged decode over an identity table). At float32 the two
  plain routes agree; at bf16 they differ by bf16 rounding, as the JAX
  package's kernel and fallback do.
"""

import torch

from . import _kernels, paged_split
from .kv_quant import dequantize_kv_pages
from .paged_attention import paged_decode_attention

# Launches of the kernel (incremented only where it is launched).
launches = 0


def reset_launches():
    global launches
    launches = 0


def check_args(q, k_q, k_s, v_q, v_s, page_table, seq_lens):
    """What the kernel takes: one CUDA device, contiguous; q bf16 or
    float32 and 16-byte aligned; int8 pages, 16-byte aligned, with
    float32 scales [n_pages, page, n_kv]; the shape rule of
    :func:`_kernels.check_head_shape`; int32 table and lengths."""
    if q.dim() != 3 or k_q.dim() != 4:
        raise ValueError("q must be [batch, n_heads, hd] and the pages "
                         "[n_pages, page, n_kv, hd]")
    _kernels.check_head_shape(q.shape[2], q.shape[1], k_q.shape[2],
                              "paged_decode_q")
    dev = q.device
    named = (("q", q), ("k_q", k_q), ("k_s", k_s), ("v_q", v_q),
             ("v_s", v_s), ("page_table", page_table),
             ("seq_lens", seq_lens))
    for name, t in named:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in paged_split._DTYPES:
        raise TypeError(f"q dtype {q.dtype} (need bf16 or f32)")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise TypeError("k_q and v_q must be int8")
    if k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError("k_s and v_s must be float32")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    batch, n_heads, hd = q.shape
    if v_q.shape != k_q.shape or k_q.shape[3] != hd:
        raise ValueError("page shapes do not agree with q")
    if k_s.shape != k_q.shape[:3] or v_s.shape != k_q.shape[:3]:
        raise ValueError("scales must be [n_pages, page, n_kv]")
    for name, t in (("q", q), ("k_q", k_q), ("v_q", v_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if page_table.dim() != 2 or page_table.shape[0] != batch:
        raise ValueError("page_table must be [batch, max_pages]")
    if seq_lens.shape != (batch,):
        raise ValueError("seq_lens must be [batch]")


def paged_flash_decode_quantized(q, k_q, k_s, v_q, v_s, page_table,
                                 seq_lens, window=0):
    """Launch the CUDA int8 paged decode kernel.

    q: [batch, n_heads, hd] bf16 or float32; k_q/v_q: int8 [n_pages,
    page, n_kv, hd]; k_s/v_s: float32 [n_pages, page, n_kv];
    page_table: int32 [batch, max_pages] (padded arbitrarily: ids are
    clamped into the pool); seq_lens: int32 [batch], tokens per sequence
    including the current one. All on one CUDA device, contiguous, q and
    the pages 16-byte aligned; hd a multiple of 8 up to 256, any GQA
    group. Returns [batch, n_heads, hd] in q's dtype; a sequence with no
    token gets zeros."""
    global launches
    check_args(q, k_q, k_s, v_q, v_s, page_table, seq_lens)
    if q.shape[0] == 0:
        return q.new_empty(q.shape)
    out = paged_split.launch("istpu_paged_decode_q", q, k_q, v_q,
                             page_table, seq_lens, window, 1,
                             scales=(k_s, v_s))
    launches += 1
    return out


def _gather_dequantized(k_q, k_s, v_q, v_s, page_table, dtype):
    """The table's pages (ids clamped into the pool), dequantized to
    ``dtype`` in table order: (k, v) [batch * max_pages, page, n_kv, hd]
    and the identity table over them."""
    sel = page_table.long().clamp(0, k_q.shape[0] - 1).reshape(-1)
    kg = dequantize_kv_pages(k_q[sel], k_s[sel], dtype)
    vg = dequantize_kv_pages(v_q[sel], v_s[sel], dtype)
    ident = torch.arange(sel.numel(), dtype=torch.int32,
                         device=page_table.device).reshape(page_table.shape)
    return kg, vg, ident


def paged_decode_quantized_plain(q, k_q, k_s, v_q, v_s, page_table,
                                 seq_lens, window=0):
    """The kernel's function in plain PyTorch: q in float32, the pages
    dequantized to float32, float32 softmax and P.V (P is not rounded to
    q's dtype), the output cast to q's dtype."""
    kg, vg, ident = _gather_dequantized(k_q, k_s, v_q, v_s, page_table,
                                        torch.float32)
    out = paged_decode_attention(q.float(), kg, vg, ident, seq_lens,
                                 window=window)
    return out.to(q.dtype)


def decode_attention_quantized(q, k_q, k_s, v_q, v_s, page_table, seq_lens,
                               window=0):
    """Decode attention over int8 pages: the CUDA kernel for CUDA
    tensors; for CPU tensors the JAX package's off-TPU route (gather
    first, so the footprint stays at the referenced pages, then
    dequantize to q's dtype and run the plain paged decode); anything
    else raises."""
    if q.device.type == "cuda":
        return paged_flash_decode_quantized(q, k_q, k_s, v_q, v_s,
                                            page_table, seq_lens,
                                            window=window)
    if q.device.type == "cpu":
        kg, vg, ident = _gather_dequantized(k_q, k_s, v_q, v_s, page_table,
                                            q.dtype)
        return paged_decode_attention(q, kg, vg, ident, seq_lens,
                                      window=window)
    raise ValueError(
        f"decode_attention_quantized: unsupported device {q.device}")


def decode_attention_quantized_tp(tp, q, k_q, k_s, v_q, v_s, page_table,
                                  seq_lens, window=0):
    """Int8 variant of ``paged_flash_decode.decode_attention_tp``: the
    int8 pages and their per-(token, kv head) scales [n_pages, page,
    n_kv] are both cut on the kv-head dim, and each of the ``tp`` slices
    launches K4 on its heads (the CPU route for CPU tensors), with no
    collective."""
    from ..parallel.mesh import head_parallel

    return head_parallel(decode_attention_quantized, tp, q,
                         (k_q, k_s, v_q, v_s), (page_table, seq_lens),
                         window=window)

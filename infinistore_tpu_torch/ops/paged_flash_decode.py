"""Paged flash-decode attention: the CUDA kernel ``csrc/paged_decode.cu``
and its dispatcher.

Counterpart of ``infinistore_tpu/ops/pallas_paged_attention.py``
(``paged_flash_decode`` / ``decode_attention``). The plain version is
``paged_attention.paged_decode_attention``; :func:`decode_attention`
takes it for CPU tensors only. A CUDA tensor launches the kernel or
raises — there is no fallback.
"""

import torch

from . import _kernels
from .paged_attention import paged_decode_attention

# Launches of the kernel (incremented only where it is launched).
launches = 0

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def reset_launches():
    global launches
    launches = 0


def paged_flash_decode(q, k_pages, v_pages, page_table, seq_lens, window=0):
    """Launch the CUDA paged decode kernel.

    q: [batch, n_heads, hd]; k_pages/v_pages: [n_pages, page, n_kv, hd];
    page_table: int32 [batch, max_pages] (padded arbitrarily: ids are
    clamped into the pool); seq_lens: int32 [batch], tokens per sequence
    including the current one. All on one CUDA device and contiguous;
    q and the pages bf16 or float32; hd in (32, 64, 128, 256), any GQA
    group. Returns [batch, n_heads, hd]."""
    global launches
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [batch, n_heads, hd] and the pages "
                         "[n_pages, page, n_kv, hd]")
    _kernels.check_head_shape(q.shape[2], q.shape[1], k_pages.shape[2],
                              "paged_decode")
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} (need bf16 or f32)")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    batch, n_heads, hd = q.shape
    n_pages, page, n_kv, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError("page shapes do not agree with q")
    if page_table.dim() != 2 or page_table.shape[0] != batch:
        raise ValueError("page_table must be [batch, max_pages]")
    if seq_lens.shape != (batch,):
        raise ValueError("seq_lens must be [batch]")
    out = torch.empty_like(q)
    if batch == 0:
        return out
    lib = _kernels.lib()
    err = lib.istpu_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], batch, n_heads, n_kv, hd, n_pages, page,
        page_table.shape[1], int(window), _kernels.stream_handle(dev),
    )
    _kernels.check(err, "paged_decode")
    launches += 1
    return out


def decode_attention(q, k_pages, v_pages, page_table, seq_lens, window=0):
    """Paged decode attention: the CUDA kernel for CUDA tensors, the plain
    PyTorch version for CPU tensors; anything else raises."""
    if q.device.type == "cuda":
        return paged_flash_decode(q, k_pages, v_pages, page_table, seq_lens,
                                  window=window)
    if q.device.type == "cpu":
        return paged_decode_attention(q, k_pages, v_pages, page_table,
                                      seq_lens, window=window)
    raise ValueError(f"decode_attention: unsupported device {q.device}")

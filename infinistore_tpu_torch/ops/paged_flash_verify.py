"""Paged flash verify attention (K3): the split-K CUDA kernel
``csrc/paged_split.cu``, and its dispatcher.

Counterpart of ``infinistore_tpu/ops/pallas_paged_attention.py``
(``paged_flash_verify`` / ``verify_attention``): m new tokens per
sequence over paged KV, for speculative verify and chunked prefill. The
plain version is ``paged_attention.multi_token_paged_attention``;
:func:`verify_attention` takes it for CPU tensors only. A CUDA tensor
launches the kernel or raises — there is no fallback.
"""

from . import paged_split
from .paged_attention import multi_token_paged_attention

# Launches of the kernel (incremented only where it is launched).
launches = 0


def reset_launches():
    global launches
    launches = 0


def paged_flash_verify(q, k_pages, v_pages, page_table, seq_lens, window=0):
    """Launch the CUDA paged verify kernel.

    q: [batch, m, n_heads, hd]; k_pages/v_pages: [n_pages, page, n_kv,
    hd]; page_table: int32 [batch, max_pages] (ids clamped into the
    pool); seq_lens: int32 [batch], tokens in the cache BEFORE the m new
    ones (whose KV is already in the pages at seq_lens + j). All on one
    CUDA device, contiguous and 16-byte aligned; q and the pages bf16 or
    float32, n_heads a multiple of n_kv, hd a multiple of 8 up to 256,
    any page size. Returns [batch, m, n_heads, hd]; a row with no
    position to attend (its window floor at or past the table's end) gets
    zeros."""
    global launches
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be [batch, m, heads, hd] and the pages "
                         "[n_pages, page, n_kv, hd]")
    paged_split.check_args("paged_verify", q, k_pages, v_pages, page_table,
                           seq_lens)
    if q.numel() == 0:
        return q.new_empty(q.shape)
    out = paged_split.launch("istpu_paged_verify", q, k_pages, v_pages,
                             page_table, seq_lens, window, q.shape[1])
    launches += 1
    return out


def verify_attention(q, k_pages, v_pages, page_table, seq_lens, window=0):
    """m-token paged attention: the CUDA kernel for CUDA tensors, the
    plain PyTorch version for CPU tensors; anything else raises."""
    if q.device.type == "cuda":
        return paged_flash_verify(q, k_pages, v_pages, page_table, seq_lens,
                                  window=window)
    if q.device.type == "cpu":
        return multi_token_paged_attention(q, k_pages, v_pages, page_table,
                                           seq_lens, window=window)
    raise ValueError(f"verify_attention: unsupported device {q.device}")

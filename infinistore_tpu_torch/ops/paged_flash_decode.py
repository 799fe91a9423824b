"""Paged flash-decode attention (K2): the split-K CUDA kernel
``csrc/paged_split.cu`` at m = 1, and its dispatcher.

Counterpart of ``infinistore_tpu/ops/pallas_paged_attention.py``
(``paged_flash_decode`` / ``decode_attention`` / ``decode_attention_tp``).
The plain version is
``paged_attention.paged_decode_attention``; :func:`decode_attention`
takes it for CPU tensors only. A CUDA tensor launches the kernel or
raises — there is no fallback.
"""

from . import paged_split
from .paged_attention import paged_decode_attention

# Launches of the kernel (incremented only where it is launched).
launches = 0


def reset_launches():
    global launches
    launches = 0


def paged_flash_decode(q, k_pages, v_pages, page_table, seq_lens, window=0):
    """Launch the CUDA paged decode kernel.

    q: [batch, n_heads, hd]; k_pages/v_pages: [n_pages, page, n_kv, hd];
    page_table: int32 [batch, max_pages] (padded arbitrarily: ids are
    clamped into the pool); seq_lens: int32 [batch], tokens per sequence
    including the current one. All on one CUDA device, contiguous and
    16-byte aligned; q and the pages bf16 or float32; hd a multiple of 8
    up to 256, any GQA group. Returns [batch, n_heads, hd]; a sequence
    with no token gets zeros."""
    global launches
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [batch, n_heads, hd] and the pages "
                         "[n_pages, page, n_kv, hd]")
    paged_split.check_args("paged_decode", q, k_pages, v_pages, page_table,
                           seq_lens)
    if q.shape[0] == 0:
        return q.new_empty(q.shape)
    out = paged_split.launch("istpu_paged_decode", q, k_pages, v_pages,
                             page_table, seq_lens, window, 1)
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


def decode_attention_tp(tp, q, k_pages, v_pages, page_table, seq_lens,
                        window=0):
    """:func:`decode_attention` under tensor parallelism, every one of
    the ``tp`` ranks' slices in this process: kv heads cut into tp
    slices, q heads with them (each slice keeps its kv heads' whole GQA
    group), the table and lengths whole. Decode attention is
    head-parallel, so there is no collective: each slice launches K2 on
    its heads (the plain version for CPU tensors), as each device of the
    JAX wrapper's ``shard_map`` does on its own heads, and the outputs
    are joined on heads (see ``parallel.mesh.head_parallel``). A rank
    that holds only its own heads calls :func:`decode_attention` on
    them. Requires n_kv_heads % tp == 0."""
    from ..parallel.mesh import head_parallel

    return head_parallel(decode_attention, tp, q, (k_pages, v_pages),
                         (page_table, seq_lens), window=window)

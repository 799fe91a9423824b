"""Flash prefill attention: the CUDA kernel ``csrc/flash_prefill.cu`` and
its dispatcher.

Counterpart of ``infinistore_tpu/ops/pallas_flash_attention.py`` (the
forward: ``flash_prefill_attention`` / ``flash_prefill``). The plain
version of the same function is ``paged_attention.prefill_attention``;
:func:`flash_prefill` takes it for CPU tensors only. A CUDA tensor
launches the kernel or raises — there is no fallback.
"""

import torch

from . import _kernels
from .paged_attention import prefill_attention

# Launches of the kernel (incremented only where it is launched).
launches = 0

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
_HEAD_DIMS = (32, 64, 128)


def reset_launches():
    global launches
    launches = 0


def flash_prefill_attention(q, k, v, causal=True, window=0):
    """Launch the CUDA flash prefill kernel.

    q: [batch, s_q, n_heads, hd]; k/v: [batch, s_kv, n_kv, hd], CUDA,
    contiguous, bf16 or float32, n_heads a multiple of n_kv, hd in
    (32, 64, 128). s_kv may exceed s_q (suffix over a cached prefix: the
    causal diagonal shifts by s_kv - s_q). Returns [batch, s_q, n_heads,
    hd] in q's dtype."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
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
    s_kv, n_kv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != batch or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if n_heads % n_kv:
        raise ValueError(f"n_heads {n_heads} not a multiple of n_kv {n_kv}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if causal and s_kv < s_q:
        raise ValueError(
            f"causal attention needs kv_len >= q_len, got {s_kv} < {s_q}"
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _kernels.lib()
    err = lib.istpu_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], batch, s_q, s_kv, n_heads, n_kv, hd,
        int(bool(causal)), int(window), _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_prefill")
    launches += 1
    return out


def flash_prefill(q, k, v, causal=True, window=0):
    """Prefill attention: the CUDA kernel for CUDA tensors, the plain
    PyTorch version for CPU tensors; anything else raises."""
    if q.device.type == "cuda":
        return flash_prefill_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return prefill_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_prefill: unsupported device {q.device}")

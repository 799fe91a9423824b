"""Int8 KV-page quantization, in PyTorch.

The counterpart of ``infinistore_tpu/ops/kv_quant.py``, with its exact
math: symmetric absmax over the head dim in float32, one scale per
(token, kv head), ``scale = max(absmax / 127, 1e-8)`` (zero pages
quantize to zero), round half to even, clip to +-127. The division by
127 is a multiplication by float32(1 / 127), as XLA compiles the JAX
package's jitted ``absmax / 127.0``: so the int8 values and the scales
are bit-identical to the JAX package's. Quantizing and packing run on the tensors' own device, so only the packed int8 bytes
cross to the host (or, on SHM, straight into the store's pool).

Wire format of one packed page (one store block):
    [page * n_kv * hd]  int8 values
    [page * n_kv]       f32 scales
both C-order, concatenated; :func:`packed_page_bytes` gives the block
size (16896 bytes at page 16, 8 kv heads, head dim 128: 0.516x the
32768-byte bf16 page).
"""

import numpy as np
import torch

# XLA turns a division by a constant into a multiplication by its float32
# reciprocal; multiplying by this Python float does the same in torch.
INV_127 = 1.0 / 127.0


def packed_page_bytes(page_shape):
    """Store block size of one packed page. page_shape = (page, n_kv, hd)."""
    page, n_kv, hd = page_shape
    return page * n_kv * hd + page * n_kv * 4


def quantize_kv_pages(pages):
    """pages: [n, page, n_kv, hd] float -> (int8 [same shape], f32 scales
    [n, page, n_kv]), on the pages' device."""
    pf = pages.float()
    scales = torch.clamp_min(pf.abs().amax(dim=-1) * INV_127, 1e-8)
    q = torch.round(pf / scales[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scales


def dequantize_kv_pages(q, scales, dtype):
    """Inverse of :func:`quantize_kv_pages`."""
    return (q.float() * scales[..., None]).to(dtype)


def pack_pages(q, scales):
    """Device-side pack: int8 values + f32 scale bytes per page -> uint8
    [n, packed_page_bytes] on the tensors' device (no host staging)."""
    n = q.shape[0]
    vals = q.contiguous().reshape(n, -1).view(torch.uint8)
    sc = scales.float().contiguous().reshape(n, -1).view(torch.uint8)
    return torch.cat([vals, sc], dim=1)


def unpack_pages(packed, page_shape):
    """Inverse of :func:`pack_pages`: uint8 [n, packed_page_bytes] ->
    (int8 [n, *page_shape], f32 scales [n, page, n_kv]), both contiguous,
    on ``packed``'s device."""
    page, n_kv, hd = page_shape
    n = packed.shape[0]
    nv = page * n_kv * hd
    q = packed[:, :nv].contiguous().view(torch.int8)
    scales = packed[:, nv:].contiguous().view(torch.float32)
    return q.reshape(n, page, n_kv, hd), scales.reshape(n, page, n_kv)


def pack_pages_host(q, scales):
    """Host-side pack (numpy): int8 values + f32 scale bytes per page ->
    uint8 [n, packed_page_bytes]."""
    q = np.asarray(q)
    scales = np.asarray(scales, dtype=np.float32)
    n = q.shape[0]
    vals = q.reshape(n, -1).view(np.uint8)
    sc = scales.reshape(n, -1).view(np.uint8)
    return np.concatenate([vals, sc], axis=1)


def unpack_pages_host(packed, page_shape):
    """Inverse of :func:`pack_pages_host`: uint8 [n, packed_page_bytes] ->
    (int8 [n, *page_shape], f32 scales [n, page, n_kv])."""
    page, n_kv, hd = page_shape
    n = packed.shape[0]
    nv = page * n_kv * hd
    q = packed[:, :nv].view(np.int8).reshape(n, page, n_kv, hd)
    scales = packed[:, nv:].copy().view(np.float32).reshape(n, page, n_kv)
    return q, scales

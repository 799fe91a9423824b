"""The decode step's KV write with a fixed shape: the CUDA kernel
``csrc/kv_write.cu``, its plain version and its dispatcher.

Each batch row's new k and v row goes to its (page, slot) of one layer's
pools, with JAX's scatter ``mode="drop"``: a page or slot in [-size, -1]
wraps, any other outside the pool writes nothing, and of rows that land
on one target the last writes. ``paged_attention.drop_mode_rows`` +
``scatter_rows`` do the same with a ``torch.nonzero`` (a host sync, and a
shape that depends on the data); this write has neither, so every
decode step takes it, and a CUDA graph can hold it
(``models.llama.DecodeGraph``). :func:`kv_write_plain` is its
plain version, which the CPU tests hold to ``drop_mode_rows`` +
``scatter_rows``; :func:`write_kv_rows` takes it for CPU tensors only.
"""

import torch

from . import _kernels

# Launches of the kernel (incremented only where it is launched).
launches = 0


def reset_launches():
    global launches
    launches = 0


def _rows(new, pages):
    """[B, (1,) n_kv, hd] -> [B, n_kv, hd] in the pages' dtype."""
    return new.reshape(new.shape[0], *pages.shape[2:]).to(pages.dtype)


def kv_write_plain(k_pages, v_pages, k, v, page, slot):
    """The kernel's arithmetic, row by row: k, v [B, (1,) n_kv, hd] into
    k_pages, v_pages [N, P, n_kv, hd] at (page[b], slot[b]), IN PLACE."""
    n, p = k_pages.shape[:2]
    k, v = _rows(k, k_pages), _rows(v, v_pages)
    for b, (pg, sl) in enumerate(zip(page.tolist(), slot.tolist())):
        pg += n if pg < 0 else 0
        sl += p if sl < 0 else 0
        if 0 <= pg < n and 0 <= sl < p:
            k_pages[pg, sl] = k[b]
            v_pages[pg, sl] = v[b]


def kv_write(k_pages, v_pages, k, v, page, slot):
    """Launch the CUDA KV write (see the module's docstring). All on one
    CUDA device; k, v and the pages contiguous and 16-byte aligned, one
    row (n_kv x hd) a whole number of 16-byte vectors; page and slot int64
    [B]."""
    global launches
    k, v = _rows(k, k_pages), _rows(v, v_pages)
    b = k.shape[0]
    n, p = k_pages.shape[:2]
    row_bytes = k[0].numel() * k.element_size() if b else 16
    dev = k_pages.device
    for name, t in (("k", k), ("v", v), ("k_pages", k_pages),
                    ("v_pages", v_pages), ("page", page), ("slot", slot)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k", k), ("v", v), ("k_pages", k_pages),
                    ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in shape or dtype")
    if v.shape != k.shape:
        raise ValueError("k and v differ in shape")
    if row_bytes % 16:
        raise ValueError(f"a row of {row_bytes} bytes is not a whole "
                         "number of 16-byte vectors")
    if page.dtype != torch.int64 or slot.dtype != torch.int64 \
            or page.shape != (b,) or slot.shape != (b,):
        raise ValueError("page and slot must be int64 [batch]")
    err = _kernels.lib().istpu_kv_write(
        k.data_ptr(), v.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page.data_ptr(), slot.data_ptr(), b, n, p, row_bytes,
        _kernels.stream_handle(dev))
    _kernels.check(err, "istpu_kv_write")
    launches += 1


def write_kv_rows(k_pages, v_pages, k, v, page, slot):
    """The fixed-shape KV write: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; anything else raises."""
    if k_pages.device.type == "cuda":
        return kv_write(k_pages, v_pages, k, v, page, slot)
    if k_pages.device.type == "cpu":
        return kv_write_plain(k_pages, v_pages, k, v, page, slot)
    raise ValueError(f"write_kv_rows: unsupported device {k_pages.device}")

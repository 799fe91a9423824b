"""Ring attention: exact attention with the sequence sharded over ranks.

Counterpart of ``infinistore_tpu/ops/ring_attention.py``. Each rank of
the ``sp`` group holds one contiguous block of the sequence, q, k and v
as [batch, blk, heads, hd]. Step t attends the rank's q block to the KV
block that started on rank idx - t, while k and v move on to rank
idx + 1 (``parallel.transport.exchange``: the send and the receive of a
step are posted together, before the block is computed, so the transfer
runs beside it). The blocks' results are merged by online softmax in
float32 and cast to q's dtype once, at the end.

Each block is one call of K1 (``ops.flash_attention``'s
``flash_prefill_attention`` with ``with_lse=True``) on the card and of
its plain version with lse on the CPU: the normalized output of the block
and the row logsumexp of its scaled logits. The diagonal block (s_q ==
s_kv) is causal, earlier blocks are not, and with ``causal`` a block from
a later rank is skipped: the JAX ring masks it whole, so it adds zero
weight there. K1 takes GQA as it is, so the ring rotates the n_kv heads
(the JAX ring repeats k and v to full heads first; the result is the
same). Forward only, as the JAX ring is used.
"""

import torch
import torch.distributed as dist

from ..parallel import transport
from ..parallel.mesh import device_mesh
from . import flash_attention as fa


def _block(q, k, v, causal):
    """(out, lse [batch, heads, s_q] float32) of one block: K1 on the card,
    its plain version on the CPU."""
    if q.device.type == "cuda":
        return fa.flash_prefill_attention(q, k, v, causal=causal,
                                          with_lse=True)
    if q.device.type != "cpu":
        raise ValueError(f"ring_attention: unsupported device {q.device}")
    return fa.flash_forward_lse_plain(q, k, v, causal=causal)


def ring_attention(q, k, v, group=None, causal=True):
    """Attention of this rank's sequence block over the whole sequence.

    q: [batch, blk, n_heads, hd], k/v: [batch, blk, n_kv, hd]: this
    rank's block, block i of the sequence on rank i of ``group`` (a
    ProcessGroup, a 1-D DeviceMesh such as :func:`make_sp_mesh` gives,
    or None for the world). Every rank of the group calls it. Returns
    [batch, blk, n_heads, hd] in q's dtype: rows idx * blk ... of the
    whole attention."""
    group = transport.group_of(group)
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    nxt, prv = (idx + 1) % n, (idx - 1) % n
    q = q.contiguous()
    k_cur, v_cur = k.contiguous(), v.contiguous()
    acc = acc_lse = None
    for t in range(n):
        src = (idx - t) % n
        if t < n - 1:
            k_nxt, v_nxt = torch.empty_like(k_cur), torch.empty_like(v_cur)
            xfer = transport.exchange([(k_cur, nxt), (v_cur, nxt)],
                                      [(k_nxt, prv), (v_nxt, prv)], group)
        if not causal or src <= idx:
            out, lse = _block(q, k_cur, v_cur, causal and src == idx)
            # Merge on K1's convention: out_i is normalized and lse_i is
            # the row logsumexp of the scaled logits, so the whole row is
            # sum_i exp(lse_i - L) out_i with L = logsumexp_i lse_i.
            lse = lse.transpose(1, 2)[..., None]  # [batch, blk, heads, 1]
            if acc is None:
                acc, acc_lse = out.float(), lse
            else:
                new = torch.logaddexp(acc_lse, lse)
                acc = (acc * torch.exp(acc_lse - new)
                       + out.float() * torch.exp(lse - new))
                acc_lse = new
        if t < n - 1:
            xfer.wait()
            k_cur, v_cur = k_nxt, v_nxt
    return acc.to(q.dtype)


def ring_attention_global(q, k, v, mesh=None, causal=True):
    """The JAX signature: q [batch, seq, n_heads, hd], k/v [batch, seq,
    n_kv, hd] whole on every rank of ``mesh`` (a DeviceMesh
    from :func:`make_sp_mesh`, or None for the world). seq must divide
    by the group's size. Each rank takes its block, runs
    :func:`ring_attention`, and the blocks are all-gathered: returns the
    whole [batch, seq, n_heads, hd] on every rank."""
    group = transport.group_of(mesh)
    n = dist.get_world_size(group)
    b, s, h, d = q.shape
    if s % n:
        raise ValueError(f"seq {s} not divisible by sp={n}")
    blk = s // n
    idx = dist.get_rank(group)
    cut = slice(idx * blk, (idx + 1) * blk)
    out = ring_attention(q[:, cut], k[:, cut], v[:, cut], group, causal)
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out, group=group)
    return torch.cat(parts, dim=1)


def make_sp_mesh(n=None, device="cuda", backend=None):
    """A 1-D sequence-parallel DeviceMesh ("sp",) over the ``n`` ranks
    (default: all) that joined with ``parallel.mesh.init_process_group``;
    the card unless ``device="cpu"``."""
    n = dist.get_world_size() if n is None else n
    return device_mesh((n,), ("sp",), device, backend)

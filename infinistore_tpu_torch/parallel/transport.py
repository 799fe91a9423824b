"""Point-to-point transport of the port's parallel modules: the sequence
ring (``ops/ring_attention.py``), the pipeline's hops
(``parallel/pipeline.py``) and the device KV pool's handoff and reads
(``parallel/ici_handoff.py``) all move tensors through here.

:func:`exchange` posts a rank's sends and receives of one step together
(``dist.batch_isend_irecv``), so no rank waits on a pairing whatever
order its peers post in; :func:`broadcast` copies one rank's tensor to
the group. With NCCL (a card per rank) CUDA tensors go to the peer
directly. gloo documents its point-to-point calls for CPU tensors only,
so a CUDA tensor on a gloo group (ranks that share one card) is staged
explicitly: copied to pinned host memory, sent, and copied back to the
card on arrival. ``counters`` counts the bytes each way, the staged ones
apart, so a reading names its transport.
"""

import torch
import torch.distributed as dist

# Calls and bytes since the last reset_counters(): exchanges posted,
# bytes sent and received, bytes staged through host memory (both
# directions), broadcasts.
counters = {"exchanges": 0, "sent_bytes": 0, "recv_bytes": 0,
            "staged_bytes": 0, "broadcasts": 0}


def reset_counters():
    for k in counters:
        counters[k] = 0


def group_of(mesh=None):
    """The process group of ``mesh`` (a 1-D DeviceMesh), the group
    itself (a ProcessGroup), or the world group (None)."""
    if mesh is None:
        return dist.group.WORLD
    if hasattr(mesh, "get_group"):
        return mesh.get_group()
    return mesh


def staged(group, tensor):
    """Whether ``tensor`` travels through host memory on ``group``."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def _host_copy(t):
    # A copy into pageable or pinned host memory without non_blocking
    # waits for the card's pending work on t first.
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    counters["staged_bytes"] += t.numel() * t.element_size()
    return host


class Exchange:
    """The handle of one :func:`exchange`: :meth:`wait` blocks until every
    send and receive is done and the staged receives are on the card."""

    def __init__(self, works, copy_back):
        self._works, self._copy_back = works, copy_back

    def wait(self):
        for w in self._works:
            w.wait()
        for dst, host in self._copy_back:
            dst.copy_(host)
            counters["staged_bytes"] += host.numel() * host.element_size()
        self._works = self._copy_back = ()


def exchange(sends=(), recvs=(), group=None):
    """Post ``sends`` [(tensor, peer)] and ``recvs`` [(tensor to fill,
    peer)] together and return their :class:`Exchange`; peers are ranks
    of ``group`` (default: the world). Between two ranks the n-th send
    of one to the other meets the other's n-th receive from it. A rank
    with nothing to send or receive posts nothing."""
    group = group_of(group)
    ops, copy_back = [], []
    # The n-th message between two ranks carries tag n (gloo matches by
    # tag; NCCL by order).
    n_sent, n_recv = {}, {}

    def tag(seen, peer):
        seen[peer] = seen.get(peer, -1) + 1
        return seen[peer]

    for t, peer in sends:
        src = t.contiguous()
        if staged(group, src):
            src = _host_copy(src)
        counters["sent_bytes"] += src.numel() * src.element_size()
        ops.append(dist.P2POp(dist.isend, src,
                              dist.get_global_rank(group, peer), group,
                              tag=tag(n_sent, peer)))
    for t, peer in recvs:
        if not t.is_contiguous():
            raise ValueError("a receive buffer must be contiguous")
        dst = t
        if staged(group, t):
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            copy_back.append((t, dst))
        counters["recv_bytes"] += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.irecv, dst,
                              dist.get_global_rank(group, peer), group,
                              tag=tag(n_recv, peer)))
    works = dist.batch_isend_irecv(ops) if ops else []
    if ops:
        counters["exchanges"] += 1
    return Exchange(works, copy_back)


def broadcast(tensor, src, group=None):
    """Copy group rank ``src``'s ``tensor`` into ``tensor`` on every rank
    of ``group`` (in place; returns it), staged through host memory as
    :func:`exchange` stages."""
    group = group_of(group)
    counters["broadcasts"] += 1
    nbytes = tensor.numel() * tensor.element_size()
    root = dist.get_global_rank(group, src)
    if not staged(group, tensor):
        dist.broadcast(tensor, root, group=group)
        return tensor
    if dist.get_rank(group) == src:
        dist.broadcast(_host_copy(tensor), root, group=group)
        counters["sent_bytes"] += nbytes
    else:
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        dist.broadcast(host, root, group=group)
        tensor.copy_(host)
        counters["staged_bytes"] += nbytes
        counters["recv_bytes"] += nbytes
    return tensor

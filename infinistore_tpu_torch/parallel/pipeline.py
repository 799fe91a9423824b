"""GPipe pipeline parallelism over the ranks of a ``pp`` group.

Counterpart of ``infinistore_tpu/parallel/pipeline.py``. The layer stack
is cut into S stages, one per rank of the group; stacked parameters carry
a leading [S, ...] axis and rank i computes with index i. The schedule is
the JAX package's: n_micro + S - 1 ticks; at tick t stage i applies
``stage_fn`` to microbatch t - i (stage 0 takes it from the input, later
stages what arrived last tick) and hands its activation to stage i + 1;
the last stage banks microbatch t - (S - 1); at the end the last stage
broadcasts the bank, the counterpart of the masked psum that replicates
it. A stage with no microbatch at a tick computes nothing (eager torch),
but the tick still passes: the schedule is always n_micro + S - 1 ticks
(:func:`n_ticks`), so the bubble is (S - 1) / (n_micro + S - 1).

The schedule is differentiable. Each tick's hop is a
``torch.autograd.Function``: forward, the stage's send of its activation
and receive of the next input, posted together
(``parallel.transport.exchange``); backward, the same two in reverse:
the gradient of what was received goes back to the stage before, the
gradient of what was sent comes from the stage after. A zero-size token
threads every hop of a rank into one chain, so every rank's backward
walks its hops in reverse tick order and the ranks' transfers pair up.
The final broadcast's backward gives the bank's gradient to the last
stage alone, once (every rank computes the same loss on the replicated
output; adding their gradients would count it S times).
"""

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from . import transport
from .mesh import device_mesh, tree_map


def make_pp_mesh(n_stages=None, device="cuda", backend=None):
    """A 1-D DeviceMesh ("pp",) over the ``n_stages`` ranks (default: all) that
    joined with ``mesh.init_process_group``; the card unless
    ``device="cpu"``."""
    n = dist.get_world_size() if n_stages is None else n_stages
    return device_mesh((n,), ("pp",), device, backend)


def stack_stage_params(per_stage_params):
    """[tree, ...] (one per stage, one structure) -> one tree whose
    leaves carry a leading [S, ...] axis, the layout
    :func:`pipeline_apply` takes."""
    return tree_map(lambda _, *leaves: torch.stack(leaves),
                    per_stage_params[0], *per_stage_params[1:])


def stage_shardings(stacked_params):
    """Placements of each leaf on the pp mesh: its leading stage axis
    sharded (the JAX ``stage_shardings(mesh, stacked, axis)``; the mesh
    goes to ``mesh.shard_params`` with these)."""
    return tree_map(lambda _, leaf: (Shard(0),), stacked_params)


def n_ticks(n_stages, n_micro):
    """Ticks of the schedule: n_micro + S - 1."""
    return n_micro + n_stages - 1


def _active(stage, tick, n_micro):
    return 0 <= tick - stage < n_micro


def _stage_params(stacked, idx):
    """This stage's parameters: a DTensor leaf placed by
    :func:`stage_shardings` holds [1, ...] here, a plain leaf the whole
    [S, ...] stack."""
    def one(_, leaf):
        if isinstance(leaf, DTensor):
            return leaf.to_local()[0]
        return leaf[idx]
    return tree_map(one, stacked)


class _Hop(torch.autograd.Function):
    """One tick's transfers on one rank: send ``out`` to ``send_to``
    (None: nothing to send) and receive the next input, of ``spec``
    (shape, dtype, device), from ``recv_from`` (None: an empty tensor).
    Returns (the next token, the received tensor)."""

    @staticmethod
    def forward(ctx, token, out, send_to, recv_from, spec, group):
        ctx.send_to, ctx.recv_from, ctx.spec, ctx.group = (
            send_to, recv_from, spec, group)
        shape, dtype, device = spec
        buf = torch.empty(shape if recv_from is not None else (0,),
                          dtype=dtype, device=device)
        transport.exchange(
            [(out, send_to)] if send_to is not None else [],
            [(buf, recv_from)] if recv_from is not None else [],
            group).wait()
        return token.clone(), buf

    @staticmethod
    def backward(ctx, g_token, g_buf):
        shape, dtype, device = ctx.spec
        g_out = (torch.empty(shape, dtype=dtype, device=device)
                 if ctx.send_to is not None else None)
        transport.exchange(
            [(g_buf, ctx.recv_from)] if ctx.recv_from is not None else [],
            [(g_out, ctx.send_to)] if ctx.send_to is not None else [],
            ctx.group).wait()
        return g_token, g_out, None, None, None, None


class _Replicate(torch.autograd.Function):
    """The last stage's bank, [n_micro, *shape], broadcast to every rank
    of the group (``bank``: the last stage's outputs in microbatch order;
    empty elsewhere). Backward: the bank's gradient goes to the last
    stage's outputs alone; the token's to the chain."""

    @staticmethod
    def forward(ctx, token, spec, n_micro, root, group, *bank):
        shape, dtype, device = spec
        ctx.banked = bool(bank)
        out = (torch.stack(bank) if bank else
               torch.empty((n_micro, *shape), dtype=dtype, device=device))
        return transport.broadcast(out, root, group)

    @staticmethod
    def backward(ctx, g_out):
        return ((torch.zeros(0, device=g_out.device), None, None, None,
                 None) + (tuple(g_out.unbind(0)) if ctx.banked else ()))


def pipeline_apply(stage_fn, stacked_params, x_micro, mesh=None):
    """Run microbatches through the S-stage pipeline over ``mesh`` (a
    DeviceMesh from :func:`make_pp_mesh`, a ProcessGroup, or None for
    the world), S its size. Every rank of the group calls it.

    ``stage_fn(params_of_one_stage, x) -> y``, y of x's shape and dtype;
    ``stacked_params``: a tree with a leading [S, ...] axis
    (:func:`stack_stage_params`; or DTensors placed by
    :func:`stage_shardings`, each rank holding its stage);
    ``x_micro``: [n_micro, mb, ...], the same on every rank (stage 0
    reads it).

    Returns [n_micro, mb, ...] = stage_{S-1}(... stage_0(x) ...) on every
    rank, differentiable in the stage parameters and ``x_micro``."""
    group = transport.group_of(mesh)
    n_stages = dist.get_world_size(group)
    idx = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    params = _stage_params(stacked_params, idx)
    spec = (tuple(x_micro.shape[1:]), x_micro.dtype, x_micro.device)
    leaves = []
    tree_map(lambda _, leaf: leaves.append(leaf), params)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves + [x_micro])
    token = torch.zeros(0, device=x_micro.device, requires_grad=grad)
    buf, bank = None, []
    for t in range(n_ticks(n_stages, n_micro)):
        out = None
        if _active(idx, t, n_micro):
            out = stage_fn(params, x_micro[t] if idx == 0 else buf)
            if (tuple(out.shape), out.dtype) != spec[:2]:
                raise ValueError(f"stage_fn gave {tuple(out.shape)} "
                                 f"{out.dtype}, not its input's {spec[:2]}")
            if idx == n_stages - 1:
                bank.append(out)
        send_to = idx + 1 if out is not None and idx < n_stages - 1 else None
        recv_from = (idx - 1 if idx > 0 and _active(idx - 1, t, n_micro)
                     else None)
        if send_to is not None or recv_from is not None:
            token, buf = _Hop.apply(token, out, send_to, recv_from, spec,
                                    group)
    return _Replicate.apply(token, spec, n_micro, n_stages - 1, group,
                            *bank)


__all__ = [
    "make_pp_mesh", "stack_stage_params", "stage_shardings",
    "pipeline_apply", "n_ticks",
]

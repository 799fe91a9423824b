"""The (dp, tp) device mesh, Megatron tensor parallelism and FSDP.

Counterpart of ``infinistore_tpu/parallel/mesh.py``. The JAX package
annotates shardings and lets XLA insert the collectives. The port's model
is a function over a params dict that calls ctypes kernels, which take
no DTensor, so here the collectives are explicit. They live in
:class:`TensorParallel`, which ``models/llama.py`` takes as its optional
``tp`` argument:

- column-parallel inputs (before wq/wk/wv, w_gate/w_up and lm_head):
  identity forward, all-reduce of the gradient backward;
- row-parallel outputs (after wo and w_down): all-reduce forward,
  identity backward, once per block; a bias on them (``bo``) is added
  once, after the reduction;
- the embedding (sharded over d_model) and lm_head (sharded over vocab):
  all-gathered along the last dim; the gradient is this rank's slice;
- FSDP: a leaf that is also sharded over dp is all-gathered over dp when
  it is used, and its gradient is reduce-scattered back.

Parameters are DTensors on the mesh, placed by the JAX package's
leaf-name rules (:func:`param_sharding_rules`; an int8 weight by its
parent's rule, where the JAX rules replicate it). The model computes on
their local tensors (:meth:`TensorParallel.local`), and
``torch.optim.AdamW`` steps the DTensors, so its moments take each
leaf's shard, as ``optimizer.init`` on the sharded tree does in JAX.

One rank is one process. :func:`init_process_group` joins them and
chooses the backend explicitly: gloo on the CPU; NCCL on the card, where
each rank owns a card; gloo on the card only when the caller asks for
it, for ranks that share one card.
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .._device import resolve_device

AXES = ("dp", "tp")


@dataclass
class MeshConfig:
    dp: int = 1  # data parallel (outer axis)
    tp: int = 1  # tensor parallel (inner axis)

    @property
    def n_devices(self):
        return self.dp * self.tp


def init_process_group(rank, world_size, port, device="cuda", backend=None,
                       host="localhost"):
    """Join rank ``rank`` of ``world_size`` processes at
    ``tcp://host:port`` and return this rank's device. On the CPU the
    backend is gloo. On the card it is NCCL, and rank r takes card r; a
    card per rank is required. ``backend="gloo"`` on the card lets
    several ranks share cards (rank r on card r % count); its
    collectives stage through host memory."""
    device = resolve_device(device)
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo")
        backend = "gloo"
    else:
        backend = backend or "nccl"
        n_cards = torch.cuda.device_count()
        if backend == "nccl":
            if n_cards < world_size:
                raise RuntimeError(
                    f"NCCL needs a card per rank: {world_size} ranks, "
                    f"{n_cards} cards (backend='gloo' shares cards)")
            torch.cuda.set_device(rank)
        elif backend == "gloo":
            torch.cuda.set_device(rank % n_cards)
        else:
            raise ValueError(f"backend {backend!r} on the card: nccl or gloo")
        device = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            rank=rank, world_size=world_size)
    return device


def make_mesh(config: MeshConfig = None, device="cuda", backend=None):
    """The (dp, tp) DeviceMesh over every rank, dp outermost (a
    multi-host mesh maps dp across hosts and tp within one). With no
    config, all ranks are tp. The ranks must have joined with
    :func:`init_process_group` over the backend this device takes: gloo
    on the CPU, NCCL on the card unless ``backend="gloo"`` is asked."""
    if config is None:
        config = MeshConfig(dp=1, tp=_world())
    return device_mesh((config.dp, config.tp), AXES, device, backend)


def _world():
    if not dist.is_initialized():
        raise RuntimeError("join the ranks first: init_process_group")
    return dist.get_world_size()


def device_mesh(dims, names, device="cuda", backend=None):
    """A DeviceMesh of shape ``dims`` with dim names ``names`` over every
    rank (first dim outermost): the mesh behind :func:`make_mesh` and the
    sp, pp, ep and pool meshes. The ranks must have joined over the
    backend this device takes (as :func:`make_mesh` says)."""
    world = _world()
    n = 1
    for d in dims:
        n *= d
    if n != world:
        raise ValueError(f"mesh {'x'.join(map(str, dims))} needs {n} ranks, "
                         f"got {world}")
    device = resolve_device(device)
    want = "gloo" if device.type == "cpu" else (backend or "nccl")
    if dist.get_backend() != want:
        raise ValueError(f"the ranks joined over {dist.get_backend()}; a "
                         f"{device.type} mesh here takes {want}")
    return init_device_mesh(device.type, tuple(dims),
                            mesh_dim_names=tuple(names))


_REP = (Replicate(), Replicate())
_COL = (Replicate(), Shard(1))   # [in, out]: tp over the output columns
_ROW = (Replicate(), Shard(0))   # [in, out]: tp over the input rows
_VEC = (Replicate(), Shard(0))   # a column-parallel projection's bias


def param_sharding_rules():
    """Placements per parameter leaf name, one per mesh dim (dp, tp):
    the JAX package's ``param_sharding_rules`` table, where
    ``P(None, "tp")`` becomes ``(Replicate(), Shard(1))``.

    Megatron TP: attention q/k/v and MLP gate/up are column-parallel over
    heads and ffn, attention-out and MLP down row-parallel (one
    all-reduce per block), the embedding split over d_model and lm_head
    over vocab; norms replicated. The biases of the column-parallel
    projections (Qwen2's bq/bk/bv) split with their columns: the JAX
    rules leave them replicated and GSPMD splits them inside the program.
    ``bo`` stays replicated and is added after the reduction. Leaves
    without a rule (the MoE's experts and router) are replicated, as in
    the JAX package. An int8 weight (an ``{"int8", "scale"}`` leaf) is
    placed by its parent's rule (:func:`param_shardings`)."""
    return {
        "embed": _COL,     # [vocab, d_model]: tp over d_model
        "wq": _COL, "wk": _COL, "wv": _COL,
        "wo": _ROW,        # [n_heads * hd, d_model]
        "w_gate": _COL, "w_up": _COL,
        "w_down": _ROW,    # [d_ff, d_model]
        "lm_head": _COL,   # [d_model, vocab]: tp over vocab
        "ln1": _REP, "ln2": _REP, "final_ln": _REP,
        "bq": _VEC, "bk": _VEC, "bv": _VEC,
        "bo": _REP,
    }


def tree_map(fn, tree, *others, name=None):
    """fn(leaf name, leaf, *other trees' leaves) over a params tree
    (dicts and lists; the name is the nearest dict key)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others), name=k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(o[i] for o in others), name=name)
                for i, v in enumerate(tree)]
    return fn(name, tree, *others)


def _is_int8_leaf(x):
    """An int8 weight-only leaf: {"int8": int8 [in, out], "scale": ...}."""
    return isinstance(x, dict) and set(x) == {"int8", "scale"}


def _int8_placements(name, rule):
    """An int8 leaf's placements under its parent ``name``'s ``rule``:
    the int8 block as the parent's weight; a per-output-column scale
    with its columns (column-parallel weights and lm_head), every other
    scale replicated: a row-parallel weight's (its output columns are
    whole on every rank) and the embedding's per-row [vocab] scale."""
    by_column = rule[1] == Shard(1) and name != "embed"
    return {"int8": rule, "scale": _VEC if by_column else _REP}


def param_shardings(mesh, params):
    """A tree of placements matching ``params`` by leaf name. The JAX
    rules give an int8 leaf's ``int8`` and ``scale`` no rule, so GSPMD
    replicates them and computes each rank's columns from the whole
    leaf; here each rank holds only the block it computes on
    (:func:`_int8_placements`): the same columns, 1/tp of the int8
    bytes."""
    rules = param_sharding_rules()

    def walk(tree, name=None):
        if _is_int8_leaf(tree):
            return _int8_placements(name, rules.get(name, _REP))
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name) for v in tree]
        return rules.get(name, _REP)

    return walk(params)


def fsdp_param_shardings(mesh, params):
    """FSDP (ZeRO-3) placements: the tp rules, plus dp on the first axis
    of every weight matrix that the tp rule leaves free and that divides
    by dp, so each dp rank holds 1/dp of the leaf (and of its AdamW
    moments). Leaves with fewer than 2 dims stay unsharded over dp. The
    JAX package's ``fsdp_param_shardings`` rule."""
    dp = mesh.size(0)

    def spec(_, leaf, tp_rule):
        pl = list(tp_rule)
        if leaf.ndim < 2:
            return tuple(pl)
        taken = {p.dim for p in pl if isinstance(p, Shard)}
        for ax in range(leaf.ndim):
            if ax not in taken and leaf.shape[ax] % dp == 0:
                pl[0] = Shard(ax)
                break
        return tuple(pl)

    return tree_map(spec, params, param_shardings(mesh, params))


def data_sharding(mesh):
    """Batch-dim placements for inputs: rows over dp."""
    return (Shard(0), Replicate())


def replicated(mesh):
    """Placements of a leaf every rank holds whole."""
    return _REP


def local_shard(mesh, tensor, placements):
    """This rank's block of the whole ``tensor`` under ``placements`` (a
    contiguous copy, so the whole tensor can be freed). Every sharded
    axis must divide by its mesh dim's size."""
    out = tensor
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if out.shape[pl.dim] % n:
                raise ValueError(f"axis {pl.dim} of {tuple(tensor.shape)} "
                                 f"does not divide by {n}")
            out = out.chunk(n, dim=pl.dim)[mesh.get_local_rank(i)]
    return out.clone(memory_format=torch.contiguous_format)


def distribute(mesh, tensor, placements):
    """The whole ``tensor``, which every rank holds alike, as a DTensor
    that keeps only this rank's block (no communication)."""
    return DTensor.from_local(local_shard(mesh, tensor, placements), mesh,
                              placements, run_check=False)


def block_of(leaf):
    """A DTensor's local block as (tensor, its offset in the whole leaf
    along each dim, whether this rank counts it): of the ranks that hold
    the same block (they differ only on mesh dims that replicate the
    leaf), the one at local rank 0 on each of those dims counts it, so
    a sum over the mesh counts every block once. Blocks are chunked
    along the mesh dims in order, as :func:`local_shard` cuts them."""
    mesh = leaf.device_mesh
    size, offset, counts = list(leaf.shape), [0] * leaf.ndim, True
    for i, pl in enumerate(leaf.placements):
        r = mesh.get_local_rank(i)
        if isinstance(pl, Shard):
            size[pl.dim] //= mesh.size(i)
            offset[pl.dim] += r * size[pl.dim]
        elif r:
            counts = False
    return leaf.to_local(), offset, counts


@torch.no_grad()
def full_tensor(t):
    """A DTensor's whole value, on every rank of its mesh, gathered with
    c10d all-gathers (DTensor's own ``full_tensor`` runs functional
    collectives, which segfault over gloo on CUDA tensors in torch
    2.11). A plain tensor is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    out, mesh = t.to_local(), t.device_mesh
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            out = out.contiguous()
            parts = [torch.empty_like(out) for _ in range(mesh.size(i))]
            dist.all_gather(parts, out, group=mesh.get_group(i))
            out = torch.cat(parts, dim=pl.dim)
    return out


def shard_params(mesh, params, shardings=None):
    """The whole parameter tree (the same on every rank) -> this rank's
    DTensors, placed by ``shardings`` (default :func:`param_shardings`).
    The whole tree is not referenced afterwards."""
    if shardings is None:
        shardings = param_shardings(mesh, params)
    return tree_map(lambda _, leaf, pl: distribute(mesh, leaf, pl), params,
                    shardings)


def head_parallel(fn, tp, q, pages, rest, **kw):
    """Run a head-parallel attention ``fn(q, *pages, *rest, **kw)`` as
    ``tp`` tensor-parallel ranks would, every rank's slice in this
    process (as on the JAX package's one-host mesh), with no collective:
    the kv heads (dim 2 of every tensor in ``pages``) are cut into tp
    slices, q's heads (dim 1) with them so each slice keeps its kv
    heads' whole GQA group, and ``rest`` is passed whole to every slice.
    The slices run in turn; returns their outputs joined on heads."""
    n_kv = pages[0].shape[2]
    if n_kv % tp or q.shape[1] % tp:
        raise ValueError(f"n_kv_heads {n_kv} not divisible by tp={tp}")
    hq, hk = q.shape[1] // tp, n_kv // tp
    outs = [fn(q[:, r * hq:(r + 1) * hq].contiguous(),
               *(p[:, :, r * hk:(r + 1) * hk].contiguous() for p in pages),
               *rest, **kw) for r in range(tp)]
    return torch.cat(outs, dim=1)


class _Enter(torch.autograd.Function):
    """Column-parallel input: identity forward, all-reduce of the
    gradient backward (each rank's columns give a partial input grad)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """Row-parallel output: all-reduce forward, identity backward (the
    output's gradient is the same on every rank). Not the autograd-aware
    all-reduce of ``torch.distributed.nn``, whose backward all-reduces
    the gradient too and so scales every upstream grad by tp."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``. Backward, with ``reduce_grad`` False (tp:
    the gathered tensor's gradient is the same on every rank) this
    rank's slice; with True (FSDP over dp: each rank's gradient is its
    own rows' part) the slices reduce-scattered, summed."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank, reduce_grad):
        ctx.dim, ctx.group, ctx.n, ctx.rank = dim, group, n, rank
        ctx.reduce_grad = reduce_grad
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        parts = [p.contiguous() for p in g.chunk(ctx.n, dim=ctx.dim)]
        if ctx.reduce_grad:
            out = torch.empty_like(parts[ctx.rank])
            dist.reduce_scatter(out, parts, group=ctx.group)
        else:
            out = parts[ctx.rank]
        return out, None, None, None, None, None


class _SumBoth(torch.autograd.Function):
    """All-reduce forward and backward: a term of the loss that every rank
    computes whole from its rows' part (the MoE aux loss's mean
    probabilities), so each rank's gradient of it is summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class TensorParallel:
    """The collectives a model needs on a (dp, tp) mesh from
    :func:`make_mesh`, for this rank. ``models/llama.py`` takes one as
    its ``tp`` argument; ``None`` there is the single-device path.
    ``axes`` names the mesh's dims: a subclass renames the inner one
    (``models/moe.ExpertParallel``: ep), whose group the ``tp``
    attributes then hold."""

    axes = AXES
    # The pool of an engine on this mesh holds this rank's kv heads.
    split_heads = True

    def __init__(self, mesh, replicas=False):
        if tuple(mesh.mesh_dim_names or ()) != self.axes:
            raise ValueError(f"need a mesh with dims {self.axes}")
        self.mesh = mesh
        # With ``replicas`` the dp ranks are separate replicas (serving
        # engines, each running its own requests): the routing's dp sum
        # is this rank's own count, so a MoE routes each replica's tokens
        # alone, as one device would, and no other dp sum is reached.
        self.replicas = replicas
        self.tp_group = mesh.get_group(self.axes[1])
        self.tp = mesh.size(1)
        self.tp_rank = mesh.get_local_rank(self.axes[1])
        self.dp_group = mesh.get_group("dp")
        self.dp = mesh.size(0)
        self.dp_rank = mesh.get_local_rank("dp")

    @property
    def leader(self):
        """Rank 0 of this rank's inner (tp or ep) group: the one that
        writes to a store."""
        return self.tp_rank == 0

    def heads(self, n, what="heads"):
        """Local count of ``n`` heads (n must divide by tp)."""
        if n % self.tp:
            raise ValueError(f"{what} {n} not divisible by tp={self.tp}")
        return n // self.tp

    def check(self, cfg):
        """What tensor parallelism takes: head counts that divide by tp."""
        self.heads(cfg.n_heads, "n_heads")
        self.heads(cfg.n_kv_heads, "n_kv_heads")

    def local(self, leaf):
        """A leaf's tp-local tensor: a DTensor's local block, gathered
        over dp (differentiably: the backward reduce-scatters the grads)
        where FSDP shards it; a plain tensor as it is; an int8 leaf as
        the pair of its parts' local blocks."""
        if isinstance(leaf, dict):
            return {k: self.local(v) for k, v in leaf.items()}
        if not isinstance(leaf, DTensor):
            return leaf
        pl = leaf.placements[0]
        loc = leaf.to_local()
        if isinstance(pl, Shard) and self.dp > 1:
            return _Gather.apply(loc, pl.dim, self.dp_group, self.dp,
                                 self.dp_rank, True)
        return loc

    def layer(self, layer):
        return {k: self.local(v) for k, v in layer.items()}

    @torch.no_grad()
    def local_tree(self, params):
        """Every leaf's tp-local tensor, for inference (gathered once)."""
        return tree_map(lambda _, leaf: self.local(leaf), params)

    def enter(self, x):
        return x if self.tp == 1 else _Enter.apply(x, self.tp_group)

    def reduce(self, x):
        return x if self.tp == 1 else _Reduce.apply(x, self.tp_group)

    def gather(self, x, dim=-1):
        if self.tp == 1:
            return x
        return _Gather.apply(x, dim % x.dim(), self.tp_group, self.tp,
                             self.tp_rank, False)

    @torch.no_grad()
    def gather_heads(self, pages):
        """[..., kv_local, hd] pages -> [..., n_kv, hd] on every rank."""
        return self.gather(pages, -2)

    def head_slice(self, pages):
        """This rank's kv heads of whole [..., n_kv, hd] pages."""
        n = self.heads(pages.shape[-2], "n_kv_heads")
        return pages.narrow(-2, self.tp_rank * n, n).contiguous()

    def agree(self, value, largest=False):
        """The smallest (or largest) of every tp rank's int ``value``, so
        all ranks take the same branch."""
        if self.tp == 1:
            return value
        t = torch.tensor([value], dtype=torch.int64,
                         device=self.mesh.device_type)
        op = dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN
        dist.all_reduce(t, op=op, group=self.tp_group)
        return int(t.item())

    def dp_sum(self, x, grad=False):
        """The sum of ``x`` over the dp ranks (with ``grad``, summed in
        the backward too)."""
        if grad:
            return _SumBoth.apply(x, self.dp_group)
        x = x.detach().clone()
        dist.all_reduce(x, group=self.dp_group)
        return x

    def dp_sum_int(self, n):
        """The sum of the int ``n`` over the dp ranks (``n`` itself
        between replicas)."""
        if self.dp == 1 or self.replicas:
            return n
        t = torch.tensor([n], dtype=torch.int64, device=self.mesh.device_type)
        dist.all_reduce(t, group=self.dp_group)
        return int(t.item())

    def dp_lower_sum(self, x):
        """The sum of ``x`` over the dp ranks below this one."""
        parts = [torch.empty_like(x) for _ in range(self.dp)]
        dist.all_gather(parts, x.detach().contiguous(), group=self.dp_group)
        return sum(parts[:self.dp_rank], torch.zeros_like(x))

    def dp_mean(self, value):
        """The mean of a tensor over the dp ranks."""
        if self.dp == 1:
            return value
        v = value.detach().clone()
        dist.all_reduce(v, group=self.dp_group)
        return v / self.dp

    @torch.no_grad()
    def reduce_grads(self, params):
        """Sum over dp the grads of every leaf that dp does not shard
        (FSDP leaves were reduce-scattered in the backward)."""
        if self.dp == 1:
            return

        def one(_, leaf):
            sharded = (isinstance(leaf, DTensor)
                       and isinstance(leaf.placements[0], Shard))
            if leaf.grad is None or sharded:
                return
            g = leaf.grad
            dist.all_reduce(g.to_local() if isinstance(g, DTensor) else g,
                            group=self.dp_group)

        tree_map(one, params)

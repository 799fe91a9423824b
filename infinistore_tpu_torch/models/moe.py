"""Mixtral-style sparse-MoE decoder, in PyTorch: the second model family.

The counterpart of ``infinistore_tpu/models/moe.py``: the same
``MoEConfig``, the same leaf names (the attention leaves are the Llama
family's; the experts are stacked on a leading E axis) and the same
GShard routing semantics: top-k of a float32 router softmax, the selected
gates renormalised, per-expert capacity C = ceil(top_k * T / E * factor)
(at least 8, rounded up to 8) decided per forward pass, slots taken in
token order (earlier tokens win, a token at slot >= C is dropped), and
the Switch load-balance auxiliary loss.

The JAX package expresses dispatch and combine as [T, E, C] one-hot
tensors. Here they are slot indices: for each (token, selected expert)
pair its slot and its gate, so memory stays linear in T; the kept tokens
are gathered into [E, C, d] (empty slots zero), the experts run as one
batched SwiGLU product (``torch.bmm``, as the JAX package's einsums are
plain XLA products outside any Pallas kernel), and each token sums its
kept experts' outputs weighted by its gates. The slots, the drops and
the gates are the JAX package's.

The attention stack is ``models.llama``'s: prefill, prefix prefill,
decode and verify run llama's loop with :func:`_moe_mlp` in place of the
dense MLP (llama's ``ffn`` hook), so the paging, the page contract and
the attention kernels (K1, K2, K3 on the card; K5 and K6 in training)
are shared by construction. Serving passes this module as the
``ServingEngine``'s ``model``.

On a mesh, every model call takes either ``tp`` (a
``parallel.mesh.TensorParallel``: the attention Megatron-sharded by
llama's rules, the router and experts, which have no tp rule, whole on
every rank and run on the activations the attention's all-reduce left
the same on every rank) or ``ep`` (an :class:`ExpertParallel`: the
experts' E axis over ep, everything else whole; the combine is
all-reduced over ep). Both are the JAX package's placements; tp and ep
on one mesh are not (neither package has such a mesh). Every rank must
route every token alike; the tests and ``chip_smoke.py`` check that they
did (its ``RoutingCheck``).
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from .._device import disable_tf32, resolve_device
from ..parallel import mesh as _pmesh
from . import llama as _llama
from .llama import rms_norm


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 512
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256          # per-expert hidden size
    n_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.5
    max_seq: int = 256
    page_size: int = 16
    rope_theta: float = 10000.0
    rope_scaling: tuple = ()  # see LlamaConfig.rope_scaling
    window: int = 0           # see LlamaConfig.window
    norm_plus_one: bool = False  # mirror of LlamaConfig's family knobs
    embed_scale: float = 1.0     # (the expert FFN itself stays SwiGLU)
    head_dim_override: int = 0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    aux_loss_weight: float = 0.01

    @property
    def head_dim(self):
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def torch_dtype(self):
        return _llama._TORCH_DTYPES[self.dtype]

    def kv_page_shape(self):
        """Shape of one K (or V) page for ONE layer — one store block."""
        return (self.page_size, self.n_kv_heads, self.head_dim)

    def kv_page_bytes(self):
        return (int(np.prod(self.kv_page_shape()))
                * torch.empty((), dtype=self.torch_dtype).element_size())

    def capacity(self, n_tokens):
        """Per-expert token slots: ceil(top_k * T / E * factor), at
        least 8 and rounded up to 8."""
        c = int(np.ceil(self.top_k * n_tokens / self.n_experts
                        * self.capacity_factor))
        return max(8, -(-c // 8) * 8)


def init_params(generator, cfg: MoEConfig, device="cuda", place=None):
    """Random parameters (normal * d_model**-0.5, norms at one) drawn
    from ``generator``, which must live on ``device``: embed, lm_head,
    then each layer's wq, wk, wv, wo, router, e_gate, e_up, e_down. The
    router stays float32 whatever the tree's dtype, as in the JAX
    package. Same leaf names and shapes as the JAX ``init_params``; the
    numbers differ (another generator). ``place(layer)``, if given,
    takes each layer's leaves as they are drawn and returns what the
    tree keeps (a rank's shard of them, say ``shard_params(mesh,
    layer)``): a rank then never holds more than one whole layer, and
    draws the same numbers as the whole tree's."""
    device = resolve_device(device)
    scale = cfg.d_model ** -0.5
    dt = cfg.torch_dtype
    d, hq, hkv = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                  cfg.n_kv_heads * cfg.head_dim)
    e, ff = cfg.n_experts, cfg.d_ff

    def dense(shape, dtype=dt):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    def ones():
        return torch.ones(d, dtype=dt, device=device)

    embed = dense((cfg.vocab_size, d))
    lm_head = dense((d, cfg.vocab_size))
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"ln1": ones(), "wq": dense((d, hq)), "wk": dense((d, hkv)),
                 "wv": dense((d, hkv)), "wo": dense((hq, d)), "ln2": ones(),
                 "router": dense((d, e), torch.float32),
                 "e_gate": dense((e, d, ff)), "e_up": dense((e, d, ff)),
                 "e_down": dense((e, ff, d))}
        layers.append(layer if place is None else place(layer))
        del layer
    return {"embed": embed, "layers": layers, "final_ln": ones(),
            "lm_head": lm_head}


class Routing(NamedTuple):
    """One routing decision over T tokens, as slot indices. Pair (t, j)
    is token t's j-th choice (top-k order)."""
    expert: torch.Tensor    # [T, k] int64: the selected expert
    slot: torch.Tensor      # [T, k] int64: its position in that expert's
                            # slot list (>= capacity: dropped)
    gate: torch.Tensor      # [T, k] float32: the renormalised gate (zero
                            # for invalid tokens)
    selected: torch.Tensor  # [T, k] bool: the token is valid
    kept: torch.Tensor      # [T, k] bool: valid and slot < capacity
    capacity: int
    aux: torch.Tensor       # float32 scalar: the Switch load-balance loss


def _route(layer, h, cfg: MoEConfig, valid=None, choice=None, par=None):
    """Top-k routing of h [T, d] -> :class:`Routing`.

    ``valid`` ([T] bool or None) takes tokens out of routing before the
    capacity cumsum (decode rows with an empty cache, verify padding),
    so they never take a real token's slot. The router reads h as the
    model computed it (bf16-rounded in a bf16 tree) and its float32
    weights; its product accumulates in float64 and rounds to float32,
    so a token's logits do not depend on how many tokens the pass
    routes (a float32 GEMM sums in an order its shape picks, and a
    nearly-tied token would route differently on a cache hit than in
    the full prefill). TF32 stays off: it would round the weights.
    ``choice`` ([T, k] int64 or None) names the experts to take instead
    of the router's top-k, their gates still the router's probabilities
    renormalised: a recorded routing replayed on other numerics.

    Under ``par`` (the call's ``ExpertParallel`` or ``TensorParallel``)
    with dp > 1, h is this dp rank's rows and the routing is the whole
    batch's, as under ``jit`` over dp-sharded tokens: capacity from
    every rank's tokens, slots after the lower dp ranks' tokens (rows
    are dp-sharded in order), the aux loss from the whole batch's shares
    and mean probabilities."""
    disable_tf32()
    T = h.shape[0]
    E = cfg.n_experts
    T_all = T if par is None else par.dp_sum_int(T)
    C = cfg.capacity(T_all)
    logits = (h.double() @ layer["router"].double()).float()
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    if choice is None:
        top_w, top_idx = torch.topk(probs, cfg.top_k, dim=-1)
    else:
        top_idx = choice.to(device=probs.device, dtype=torch.long)
        top_w = probs.gather(1, top_idx)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    chosen = torch.zeros_like(probs).scatter_(1, top_idx, 1.0)  # [T, E]
    if valid is not None:
        keep_t = valid.reshape(T, 1).to(probs.dtype)
        chosen = chosen * keep_t
        top_w = top_w * keep_t
    # Earlier tokens win slots: position of t in e's list (float32 counts
    # are exact far past any T a pass routes).
    pos = torch.cumsum(chosen, dim=0) - chosen
    # Switch loss: E * sum_e (share of tokens choosing e) * (mean router
    # probability of e); the share counts valid tokens, the mean all.
    if T_all == T:
        aux = E * torch.sum(chosen.mean(dim=0) * probs.mean(dim=0))
    else:
        counts = chosen.sum(dim=0)
        pos = pos + par.dp_lower_sum(counts)
        aux = E * torch.sum((par.dp_sum(counts) / T_all)
                            * (par.dp_sum(probs.sum(dim=0), grad=True)
                               / T_all))
    slot = pos.gather(1, top_idx).long()
    selected = chosen.gather(1, top_idx) > 0
    kept = selected & (slot < C)
    return Routing(top_idx, slot, top_w, selected, kept, C, aux)


def _moe_mlp(layer, x, cfg: MoEConfig, valid=None, ep=None, tp=None):
    """[B, S, d] -> ([B, S, d], aux) through the routed expert FFN.
    ``valid`` ([B, S] bool or None) masks tokens out of routing. Under
    ``ep`` the expert leaves hold this rank's experts: every ep rank
    routes all its tokens (the router is replicated), computes only the
    pairs routed to its experts (the others add zero), and the float32
    sums of the gated picks are all-reduced over ep and rounded once, so
    a token's picks a + b sum as on one device. Under ``tp`` the experts
    and router are whole on every rank and x is the same on every rank:
    each computes the whole FFN, with no collective (``tp`` only sums
    the routing's counts over dp)."""
    b, s, d = x.shape
    h = rms_norm(x, layer["ln2"], cfg.norm_eps,
                 cfg.norm_plus_one).reshape(b * s, d)
    r = _route(layer, h, cfg, None if valid is None else valid.reshape(-1),
               par=ep if ep is not None else tp)
    k = cfg.top_k
    n_local = layer["e_gate"].shape[0]
    lo = 0 if ep is None else ep.ep_rank * n_local
    mine = r.kept & (r.expert >= lo) & (r.expert < lo + n_local)
    n_slots = n_local * r.capacity
    # Each kept pair's row in this rank's [E_local * C] slot grid; pairs
    # dropped or on another rank's experts aim at a spare row past it,
    # which is cut off before the experts run.
    flat = torch.where(mine, (r.expert - lo) * r.capacity + r.slot, n_slots)
    hx = h if ep is None else ep.enter(h)
    xe = hx.new_zeros(n_slots + 1, d).index_put(
        (flat.reshape(-1),), hx.repeat_interleave(k, dim=0))
    xe = xe[:n_slots].view(n_local, r.capacity, d)
    a = F.silu(torch.bmm(xe, layer["e_gate"])) * torch.bmm(xe,
                                                           layer["e_up"])
    oe = torch.bmm(a, layer["e_down"]).reshape(n_slots, d)
    # The combine weights, rounded to the model dtype as the JAX package
    # rounds its combine tensor, then summed over the kept experts in
    # float32 and rounded once. Under ep a rank weighs only its own
    # pairs, so the gates' gradient is summed over ep on the way back to
    # the replicated router.
    gate = torch.where(mine, r.gate if ep is None else ep.enter(r.gate),
                       0.0).to(oe.dtype)
    picked = oe[flat.clamp(max=n_slots - 1)]  # [T, k, d]
    out = (picked.float() * gate.float()[..., None]).sum(dim=1)
    if ep is not None:
        out = ep.reduce(out)
    return out.to(oe.dtype).reshape(b, s, d), r.aux


def _routed_ffn(cfg, valid=None, auxes=None, ep=None, tp=None):
    """llama's ``ffn`` hook for this family: the routed FFN, its aux
    loss appended to ``auxes`` when given."""
    def ffn(layer, x):
        out, aux = _moe_mlp(layer, x, cfg, valid, ep, tp)
        if auxes is not None:
            auxes.append(aux)
        return out
    return ffn


def _on_mesh(params, ep, tp):
    """The tree a call computes on: under ``ep`` this rank's local
    tensors (llama's loop then runs as on one device, the attention
    replicated); otherwise as it is (under ``tp`` llama's loop takes
    each layer's local leaves itself)."""
    if ep is not None and tp is not None:
        raise ValueError("tp and ep on one mesh are not supported: pass one")
    if ep is None:
        return params
    return _pmesh.tree_map(lambda _, t: ep.local(t), params)


def _forward_stack(params, cfg: MoEConfig, tokens, prefix_kvs=None,
                   pos0=0, ep=None, tp=None):
    """llama's decoder-stack loop with the routed FFN: (logits, per-layer
    (k, v), total aux loss, float32). Under ``ep`` ``params`` is this
    rank's shard (:func:`shard_params`), computed on as its local
    tensors, and ``tokens`` this rank's dp rows; under ``tp`` the tree
    of ``parallel.mesh.shard_params`` (attention Megatron-sharded, the
    rest replicated) and this rank's dp rows."""
    auxes = []
    params = _on_mesh(params, ep, tp)
    logits, kvs = _llama._forward_stack(params, cfg, tokens, prefix_kvs,
                                        pos0, ffn=_routed_ffn(
                                            cfg, auxes=auxes, ep=ep, tp=tp),
                                        tp=tp)
    aux_total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for aux in auxes:
        aux_total = aux_total + aux
    return logits, kvs, aux_total


def forward_dense(params, cfg: MoEConfig, tokens, ep=None, tp=None):
    """Dense causal forward. tokens [B, S] -> (logits [B, S, V] float32,
    per-layer (k, v), total aux loss). Differentiable when the leaves
    require grad. ``ep`` and ``tp`` as :func:`_forward_stack` takes
    them."""
    return _forward_stack(params, cfg, tokens, ep=ep, tp=tp)


def prefill(params, cfg: MoEConfig, tokens, ep=None, tp=None):
    logits, kvs, _ = forward_dense(params, cfg, tokens, ep, tp)
    return logits, kvs


def prefill_with_prefix(params, cfg: MoEConfig, tokens, prefix_kvs,
                        pos0=0, ep=None, tp=None):
    """Suffix prefill over a cached prefix (the cache-hit path), the
    contract of ``llama.prefill_with_prefix``. Routing sees the suffix
    tokens only, so capacity is sized for them."""
    logits, kvs, _ = _forward_stack(params, cfg, tokens, prefix_kvs,
                                    pos0=pos0, ep=ep, tp=tp)
    return logits, kvs


@torch.no_grad()
def decode_step(params, cfg: MoEConfig, token, seq_lens, k_pages, v_pages,
                page_table, ep=None, tp=None):
    """``llama.decode_step`` with the routed FFN (pages updated in place).
    Rows with an empty cache (seq_lens == 0, the engine's inactive slots)
    stay out of routing and capacity, on every rank alike (each holds
    the same seq_lens)."""
    valid = (seq_lens > 0)[:, None]
    return _llama.decode_step(_on_mesh(params, ep, tp), cfg, token,
                              seq_lens, k_pages, v_pages, page_table,
                              ffn=_routed_ffn(cfg, valid, ep=ep, tp=tp),
                              tp=tp)


@torch.no_grad()
def verify_step(params, cfg: MoEConfig, tokens, seq_lens, k_pages,
                v_pages, page_table, valid_len=None, ep=None, tp=None):
    """``llama.verify_step`` with the routed FFN (pages updated in place).
    Padded columns (j >= valid_len[b]) stay out of routing and
    capacity."""
    ok = None
    if valid_len is not None:
        m = tokens.shape[1]
        ok = (torch.arange(m, device=tokens.device)[None, :]
              < valid_len.to(tokens.device).long()[:, None])
    return _llama.verify_step(_on_mesh(params, ep, tp), cfg, tokens,
                              seq_lens, k_pages, v_pages, page_table,
                              valid_len,
                              ffn=_routed_ffn(cfg, ok, ep=ep, tp=tp), tp=tp)


def loss_fn(params, cfg: MoEConfig, tokens, ep=None, tp=None):
    """Next-token NLL of tokens [batch, seq + 1] plus aux_loss_weight x
    the summed aux loss (under ``ep`` or ``tp``: this rank's rows' NLL,
    the whole batch's aux loss)."""
    logits, _, aux = forward_dense(params, cfg, tokens[:, :-1], ep, tp)
    return (_llama.token_nll(logits, tokens[:, 1:])
            + cfg.aux_loss_weight * aux)


def train_step(params, optimizer, cfg: MoEConfig, tokens, ep=None, tp=None):
    """The shared optimizer step (``llama.train_step``; optimizer from
    ``llama.adamw``) with this family's loss. Leaves update in place;
    returns the loss before the step.

    Under ``ep`` (``params`` from :func:`shard_params`) or ``tp``
    (``params`` from ``parallel.mesh.shard_params``), ``tokens`` this
    rank's dp rows, the step follows the whole batch's loss, as
    ``llama.train_step`` under dp: each rank differentiates its loss
    over dp, the grads are summed over dp, and the mean loss is
    returned. The aux loss, the same on every rank, is counted once.
    Under tp the router's and experts' grads are the same on every tp
    rank and are not summed over tp: each rank's loss reaches them
    whole, through the x that every rank holds alike."""
    return _llama.train_step(
        params, optimizer, cfg, tokens, tp=ep if ep is not None else tp,
        loss=lambda p, c, t, **_: loss_fn(p, c, t, ep=ep, tp=tp))


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------

EP_AXES = ("dp", "ep")
_REP = (Replicate(), Replicate())
_EP_RULES = {
    # Expert-stacked leaves shard over ep on the E axis; the router and
    # everything else stay replicated (every token routes everywhere).
    "e_gate": (Replicate(), Shard(0)),
    "e_up": (Replicate(), Shard(0)),
    "e_down": (Replicate(), Shard(0)),
}


def make_ep_mesh(dp, ep, device="cuda", backend=None):
    """The (dp, ep) DeviceMesh over the dp * ep ranks that joined with
    ``parallel.mesh.init_process_group``: data parallel outer, experts
    inner; the card unless ``device="cpu"``."""
    return _pmesh.device_mesh((dp, ep), EP_AXES, device, backend)


def param_shardings(mesh, params):
    """Placements per leaf (dp, ep): the experts' E axis over ep,
    everything else replicated (the JAX package's ``_EP_RULES``)."""
    return _pmesh.tree_map(lambda name, leaf: _EP_RULES.get(name, _REP),
                           params)


def shard_params(mesh, params):
    """The whole tree (the same on every rank) -> this rank's DTensors
    under :func:`param_shardings` (no communication)."""
    return _pmesh.shard_params(mesh, params, param_shardings(mesh, params))


class ExpertParallel(_pmesh.TensorParallel):
    """The collectives of the routed FFN on a (dp, ep) mesh from
    :func:`make_ep_mesh`, for this rank: ``TensorParallel``'s over ep in
    tp's place. The experts' input and the gates enter through the
    Megatron pair's identity (all-reduce of the gradient over ep: each
    rank's experts and pairs give part of it), the float32 combine is
    all-reduced over ep (identity backward), the grads are summed over
    dp (every leaf is replicated over dp), and the routing's counts are
    summed over dp."""

    axes = EP_AXES

    split_heads = False  # the attention is whole on every ep rank

    def __init__(self, mesh, replicas=False):
        super().__init__(mesh, replicas)
        self.ep, self.ep_group, self.ep_rank = (self.tp, self.tp_group,
                                                self.tp_rank)


__all__ = [
    "MoEConfig", "init_params", "forward_dense", "prefill",
    "prefill_with_prefix", "decode_step", "verify_step", "loss_fn",
    "train_step", "make_ep_mesh", "param_shardings", "shard_params",
    "ExpertParallel",
]

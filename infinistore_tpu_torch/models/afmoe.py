"""AFMoE (Arcee's Trinity models, ``model_type`` ``afmoe``), in PyTorch:
the third model family, with no counterpart in the JAX package.

Per layer, as the public ``modeling_afmoe.py`` computes it (the points
marked * are recalled from that file and were not checked against it
when this module was written):

    x0     = embed[ids] * embed_scale            (sqrt(d) under muP *)
    h      = RMSNorm_in(x)
    q, k   = RMSNorm_q(h Wq), RMSNorm_k(h Wk)    per head, weight [hd]
    v      = h Wv
    q, k   = RoPE(q, k) on sliding layers only; full layers take no
             positional encoding *
    a      = causal GQA attention; keys i - window < j <= i on sliding
             layers
    a      = a * sigmoid(h Wg) *                 Wg: d x (heads x hd)
    x      = x + RMSNorm_post_attn(a Wo) *
    u      = RMSNorm_pre_mlp(x)
    f      = SwiGLU(u)                           the first n_dense_layers
    f      = SwiGLU_shared(u) + sum_{e in E} w_e SwiGLU_e(u)   the others:
             s = sigmoid(u Wr) (float32), E = top_k(s + expert_bias),
             w_e = s_e / (sum_{E} s + 1e-20) * route_scale
    x      = x + RMSNorm_post_mlp(f) *
    logits = RMSNorm(x) W_head

The attention, the paging and the kernels are ``models.llama``'s one
loop: the config's ``layer_windows`` / ``layer_rope`` give each layer
its kind, and the layer's ``q_norm``, ``k_norm``, ``wg``,
``ln_post_attn`` and ``ln_post_mlp`` leaves add the rest. The feed-
forward block enters through llama's ``ffn`` hook: llama's SwiGLU for
the dense layers, :func:`_routed` for the others.

The expert block is dropless: every (token, expert) pair is computed.
The pairs are sorted by expert on the device, each expert's end in the
sorted order found by ``searchsorted``, and each projection is one
grouped product over the sorted rows (``torch._grouped_mm`` with device
offsets). No per-expert Python loop, no host sync, nothing sized from
the data on the host. Pairs taken out of routing (a decode row with an
empty cache, verify padding) sort past the last expert: no expert
counts or computes them.

An engine makes :class:`LayerSpans` over its ``stats`` and passes it
to every model call as ``spans=``: the routed block's host time then
shows as ``moe.route`` and ``moe.experts``.

One device only: no tp or ep, no training, no int8 tree.
"""

import contextlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import disable_tf32, resolve_device
from ..utils.profiling import Span
from . import llama as _llama
from .llama import rms_norm

# Added to the chosen scores' sum before it divides them (route_norm).
ROUTE_NORM_EPS = 1e-20


@dataclass(frozen=True)
class AfmoeConfig:
    vocab_size: int = 512
    d_model: int = 128
    n_layers: int = 4
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256           # the dense layers' SwiGLU width
    d_expert: int = 64        # each routed expert's width
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 1         # shared experts: one SwiGLU n_shared x wider
    n_dense_layers: int = 1   # the first layers, with a dense SwiGLU
    route_scale: float = 1.0
    route_norm: bool = True
    # Per layer: its sliding window (0: full) and whether q and k take
    # RoPE (layer_pattern makes both from HF layer_types).
    layer_windows: tuple = (8, 8, 8, 0)
    layer_rope: tuple = (True, True, True, False)
    max_seq: int = 256
    page_size: int = 16
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    embed_scale: float = 1.0  # sqrt(d_model) under muP
    head_dim_override: int = 0
    dtype: str = "bfloat16"
    # What llama's loop reads and this family runs at one value only:
    # unscaled RoPE, SwiGLU dense layers, norms that multiply by w.
    rope_scaling = ()
    act = "silu"
    norm_plus_one = False

    def __post_init__(self):
        if not (len(self.layer_windows) == len(self.layer_rope)
                == self.n_layers):
            raise ValueError("layer_windows and layer_rope need one entry "
                             f"per layer ({self.n_layers})")
        if not 0 <= self.n_dense_layers <= self.n_layers:
            raise ValueError(f"n_dense_layers {self.n_dense_layers} of "
                             f"{self.n_layers} layers")
        if not 0 < self.top_k <= self.n_experts:
            raise ValueError(f"top_k {self.top_k} of {self.n_experts} "
                             "experts")

    @property
    def window(self):
        """The stack's widest window, which the serving engine's page
        skipping and windowed release go by: 0 (none) where any layer
        attends every position, so the engine keeps every page."""
        return 0 if 0 in self.layer_windows else max(self.layer_windows)

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


def layer_pattern(layer_types, sliding_window):
    """(layer_windows, layer_rope) from HF ``layer_types``: a
    ``sliding_attention`` layer at ``sliding_window`` with RoPE, a
    ``full_attention`` layer at 0 without."""
    kinds = {"sliding_attention": (int(sliding_window or 0), True),
             "full_attention": (0, False)}
    unknown = sorted(set(layer_types) - set(kinds))
    if unknown:
        raise ValueError(f"unknown layer types {unknown}")
    if "sliding_attention" in layer_types and not sliding_window:
        raise ValueError("sliding_attention layers need a sliding_window")
    return (tuple(kinds[t][0] for t in layer_types),
            tuple(kinds[t][1] for t in layer_types))


def init_params(generator, cfg: AfmoeConfig, device="cuda"):
    """Random parameters drawn from ``generator`` (on ``device``): every
    matrix normal * d_model**-0.5, the router float32 whatever the tree's
    dtype (as the MoE family's), norms at one, ``expert_bias`` zeros.
    Each layer: ln1, wq, wk, wv, wg, wo, q_norm, k_norm, ln_post_attn,
    ln2 (the pre-MLP norm), ln_post_mlp; then w_gate, w_up, w_down (a
    dense layer) or router, expert_bias, e_gate, e_up, e_down [E, ...]
    and the shared expert's s_gate, s_up, s_down."""
    device = resolve_device(device)
    scale = cfg.d_model ** -0.5
    dt = cfg.torch_dtype
    d, hd, e, de = cfg.d_model, cfg.head_dim, cfg.n_experts, cfg.d_expert
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def dense(shape, dtype=dt):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    def ones(n=d):
        return torch.ones(n, dtype=dt, device=device)

    embed = dense((cfg.vocab_size, d))
    lm_head = dense((d, cfg.vocab_size))
    layers = []
    for li in range(cfg.n_layers):
        layer = {"ln1": ones(), "wq": dense((d, hq)), "wk": dense((d, hkv)),
                 "wv": dense((d, hkv)), "wg": dense((d, hq)),
                 "wo": dense((hq, d)), "q_norm": ones(hd), "k_norm": ones(hd),
                 "ln_post_attn": ones(), "ln2": ones(), "ln_post_mlp": ones()}
        if li < cfg.n_dense_layers:
            ff = cfg.d_ff
            layer.update(w_gate=dense((d, ff)), w_up=dense((d, ff)),
                         w_down=dense((ff, d)))
        else:
            layer.update(router=dense((d, e), torch.float32),
                         expert_bias=torch.zeros(e, dtype=torch.float32,
                                                 device=device),
                         e_gate=dense((e, d, de)), e_up=dense((e, d, de)),
                         e_down=dense((e, de, d)))
            if cfg.n_shared:
                ds = cfg.n_shared * de
                layer.update(s_gate=dense((d, ds)), s_up=dense((d, ds)),
                             s_down=dense((ds, d)))
        layers.append(layer)
    return {"embed": embed, "layers": layers, "final_ln": ones(),
            "lm_head": lm_head}


class LayerSpans:
    """The routed block's spans over ``stats`` (an engine's; it passes
    this object to every model call as ``spans=``): ``moe.route`` ->
    ``moe_route_ns`` / ``_n`` (router product, sigmoid, top-k, weights)
    and ``moe.experts`` -> ``moe_experts_ns`` / ``_n`` (sort, grouped
    products, shared expert, combine), once per routed layer of a call.
    They time the host queueing the block's kernels, which the card runs
    later."""

    def __init__(self, stats):
        self.route = Span(stats, "moe.route", "moe_route")
        self.experts = Span(stats, "moe.experts", "moe_experts")


_NO_SPAN = contextlib.nullcontext()


class Routing(NamedTuple):
    expert: torch.Tensor  # [T, k] int64: the chosen experts, best first
    weight: torch.Tensor  # [T, k] float32: their combine weights


def _route(layer, h, cfg: AfmoeConfig, choice=None):
    """Sigmoid top-k routing of h [T, d] -> :class:`Routing`.

    The scores are sigmoid(h @ router) in float32, the product summed in
    float64 and rounded (as ``moe._route``: a token routes alike however
    many tokens the call holds). ``expert_bias`` ([E] float32) takes part
    in the choice only; the weights are the chosen scores, divided by
    their sum (``route_norm``) and times ``route_scale``. ``choice``
    ([T, k] int64) names the experts to take instead of the top-k: a
    recorded routing replayed, weighted by this call's scores."""
    disable_tf32()
    scores = torch.sigmoid((h.double() @ layer["router"].double()).float())
    if choice is None:
        expert = torch.topk(scores + layer["expert_bias"], cfg.top_k,
                            dim=-1).indices
    else:
        expert = choice.to(device=scores.device, dtype=torch.long)
    weight = scores.gather(1, expert)
    if cfg.route_norm:
        weight = weight / (weight.sum(dim=-1, keepdim=True) + ROUTE_NORM_EPS)
    return Routing(expert, weight * cfg.route_scale)


def _swiglu(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def _experts(layer, h, r, valid=None):
    """float32 [T, d]: each token's sum over its chosen experts of
    weight x SwiGLU_e(h), every pair computed. ``valid`` ([T] bool or
    None) takes tokens out: their pairs sort past the last expert, no
    group holds them, and they add zero."""
    t, d = h.shape
    k = r.expert.shape[1]
    n_experts = layer["e_gate"].shape[0]
    expert = r.expert.reshape(-1)
    if valid is not None:
        expert = torch.where(valid[:, None].expand(t, k).reshape(-1),
                             expert, n_experts)
    order = torch.argsort(expert, stable=True)
    ranked = expert[order]
    # Group e's rows end where the sorted experts pass e.
    ends = torch.searchsorted(
        ranked, torch.arange(n_experts, device=h.device), right=True,
        out_int32=True)
    xs = h.index_select(0, order // k)
    a = (F.silu(torch._grouped_mm(xs, layer["e_gate"], offs=ends))
         * torch._grouped_mm(xs, layer["e_up"], offs=ends))
    ys = torch._grouped_mm(a, layer["e_down"], offs=ends)
    # Rows past the last group are left unwritten: select, not multiply.
    picked = torch.where((ranked < n_experts)[:, None],
                         ys.float() * r.weight.reshape(-1)[order][:, None],
                         0.0)
    pairs = torch.empty_like(picked).index_copy_(0, order, picked)
    return pairs.view(t, k, d).sum(dim=1)


def _routed(layer, x, cfg: AfmoeConfig, valid=None, spans=None):
    """[B, S, d] -> [B, S, d]: the shared expert plus each token's
    weighted top-k experts, summed in float32 and rounded once.
    ``valid`` ([B, S] bool or None) takes tokens out of the experts."""
    b, s, d = x.shape
    h = rms_norm(x, layer["ln2"], cfg.norm_eps,
                 cfg.norm_plus_one).reshape(b * s, d)
    with _NO_SPAN if spans is None else spans.route:
        r = _route(layer, h, cfg)
    with _NO_SPAN if spans is None else spans.experts:
        out = _experts(layer, h, r,
                       None if valid is None else valid.reshape(-1))
        if "s_gate" in layer:
            out = out + _swiglu(h, layer["s_gate"], layer["s_up"],
                                layer["s_down"]).float()
    return out.to(h.dtype).reshape(b, s, d)


def _ffn(cfg, valid=None, spans=None):
    """llama's ``ffn`` hook: llama's SwiGLU on a dense layer, the routed
    block on a layer with a router."""
    def ffn(layer, x):
        if "router" not in layer:
            return _llama._mlp(layer, x, cfg)
        return _routed(layer, x, cfg, valid, spans)
    return ffn


def prefill(params, cfg: AfmoeConfig, tokens, spans=None):
    """tokens [batch, seq] -> (logits [batch, seq, vocab] float32,
    per-layer (k, v) [batch, seq, n_kv, hd]): ``llama.prefill``'s
    contract."""
    return _llama._forward_stack(params, cfg, tokens,
                                 ffn=_ffn(cfg, spans=spans))


def prefill_with_prefix(params, cfg: AfmoeConfig, tokens, prefix_kvs,
                        pos0=0, spans=None):
    """Suffix prefill over a cached prefix: the contract of
    ``llama.prefill_with_prefix``."""
    return _llama._forward_stack(params, cfg, tokens, prefix_kvs, pos0,
                                 ffn=_ffn(cfg, spans=spans))


@torch.no_grad()
def decode_step(params, cfg: AfmoeConfig, token, seq_lens, k_pages,
                v_pages, page_table, spans=None):
    """``llama.decode_step`` with this family's feed-forward blocks
    (pages updated in place). Rows with an empty cache (seq_lens == 0,
    the engine's inactive slots) stay out of the experts."""
    valid = (seq_lens > 0)[:, None]
    return _llama.decode_step(params, cfg, token, seq_lens, k_pages,
                              v_pages, page_table,
                              ffn=_ffn(cfg, valid, spans))


@torch.no_grad()
def verify_step(params, cfg: AfmoeConfig, tokens, seq_lens, k_pages,
                v_pages, page_table, valid_len=None, spans=None):
    """``llama.verify_step`` with this family's feed-forward blocks
    (pages updated in place). Padded columns (j >= valid_len[b]) stay
    out of the experts."""
    ok = None
    if valid_len is not None:
        ok = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
              < valid_len.to(tokens.device).long()[:, None])
    return _llama.verify_step(params, cfg, tokens, seq_lens, k_pages,
                              v_pages, page_table, valid_len,
                              ffn=_ffn(cfg, ok, spans))


__all__ = [
    "AfmoeConfig", "layer_pattern", "init_params", "LayerSpans",
    "prefill", "prefill_with_prefix", "decode_step", "verify_step",
]

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
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import disable_tf32, resolve_device
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


def init_params(generator, cfg: MoEConfig, device="cuda"):
    """Random parameters (normal * d_model**-0.5, norms at one) drawn
    from ``generator``, which must live on ``device``: embed, lm_head,
    then each layer's wq, wk, wv, wo, router, e_gate, e_up, e_down. The
    router stays float32 whatever the tree's dtype, as in the JAX
    package. Same leaf names and shapes as the JAX ``init_params``; the
    numbers differ (another generator)."""
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
    layers = [{"ln1": ones(), "wq": dense((d, hq)), "wk": dense((d, hkv)),
               "wv": dense((d, hkv)), "wo": dense((hq, d)), "ln2": ones(),
               "router": dense((d, e), torch.float32),
               "e_gate": dense((e, d, ff)), "e_up": dense((e, d, ff)),
               "e_down": dense((e, ff, d))}
              for _ in range(cfg.n_layers)]
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


def _route(layer, h, cfg: MoEConfig, valid=None, choice=None):
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
    renormalised: a recorded routing replayed on other numerics."""
    disable_tf32()
    T = h.shape[0]
    E = cfg.n_experts
    C = cfg.capacity(T)
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
    slot = pos.gather(1, top_idx).long()
    selected = chosen.gather(1, top_idx) > 0
    kept = selected & (slot < C)
    # Switch loss: E * sum_e (share of tokens choosing e) * (mean router
    # probability of e); the share counts valid tokens, the mean all.
    aux = E * torch.sum(chosen.mean(dim=0) * probs.mean(dim=0))
    return Routing(top_idx, slot, top_w, selected, kept, C, aux)


def _moe_mlp(layer, x, cfg: MoEConfig, valid=None):
    """[B, S, d] -> ([B, S, d], aux) through the routed expert FFN.
    ``valid`` ([B, S] bool or None) masks tokens out of routing."""
    b, s, d = x.shape
    h = rms_norm(x, layer["ln2"], cfg.norm_eps,
                 cfg.norm_plus_one).reshape(b * s, d)
    r = _route(layer, h, cfg, None if valid is None else valid.reshape(-1))
    k = cfg.top_k
    n_slots = cfg.n_experts * r.capacity
    # Each kept pair's row in the [E * C] slot grid; dropped pairs aim at
    # a spare row past it, which is cut off before the experts run.
    flat = torch.where(r.kept, r.expert * r.capacity + r.slot, n_slots)
    xe = h.new_zeros(n_slots + 1, d).index_put(
        (flat.reshape(-1),), h.repeat_interleave(k, dim=0))
    xe = xe[:n_slots].view(cfg.n_experts, r.capacity, d)
    a = F.silu(torch.bmm(xe, layer["e_gate"])) * torch.bmm(xe,
                                                           layer["e_up"])
    oe = torch.bmm(a, layer["e_down"]).reshape(n_slots, d)
    # The combine weights, rounded to the model dtype as the JAX package
    # rounds its combine tensor, then summed over the kept experts in
    # float32 and rounded once.
    gate = torch.where(r.kept, r.gate, 0.0).to(oe.dtype)
    picked = oe[flat.clamp(max=n_slots - 1)]  # [T, k, d]
    out = (picked.float() * gate.float()[..., None]).sum(dim=1)
    return out.to(oe.dtype).reshape(b, s, d), r.aux


def _routed_ffn(cfg, valid=None, auxes=None):
    """llama's ``ffn`` hook for this family: the routed FFN, its aux
    loss appended to ``auxes`` when given."""
    def ffn(layer, x):
        out, aux = _moe_mlp(layer, x, cfg, valid)
        if auxes is not None:
            auxes.append(aux)
        return out
    return ffn


def _forward_stack(params, cfg: MoEConfig, tokens, prefix_kvs=None,
                   pos0=0):
    """llama's decoder-stack loop with the routed FFN: (logits, per-layer
    (k, v), total aux loss, float32)."""
    auxes = []
    logits, kvs = _llama._forward_stack(params, cfg, tokens, prefix_kvs,
                                        pos0, ffn=_routed_ffn(cfg,
                                                              auxes=auxes))
    aux_total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for aux in auxes:
        aux_total = aux_total + aux
    return logits, kvs, aux_total


def forward_dense(params, cfg: MoEConfig, tokens):
    """Dense causal forward. tokens [B, S] -> (logits [B, S, V] float32,
    per-layer (k, v), total aux loss). Differentiable when the leaves
    require grad."""
    return _forward_stack(params, cfg, tokens)


def prefill(params, cfg: MoEConfig, tokens):
    logits, kvs, _ = forward_dense(params, cfg, tokens)
    return logits, kvs


def prefill_with_prefix(params, cfg: MoEConfig, tokens, prefix_kvs,
                        pos0=0):
    """Suffix prefill over a cached prefix (the cache-hit path), the
    contract of ``llama.prefill_with_prefix``. Routing sees the suffix
    tokens only, so capacity is sized for them."""
    logits, kvs, _ = _forward_stack(params, cfg, tokens, prefix_kvs,
                                    pos0=pos0)
    return logits, kvs


@torch.no_grad()
def decode_step(params, cfg: MoEConfig, token, seq_lens, k_pages, v_pages,
                page_table):
    """``llama.decode_step`` with the routed FFN (pages updated in place).
    Rows with an empty cache (seq_lens == 0, the engine's inactive slots)
    stay out of routing and capacity."""
    valid = (seq_lens > 0)[:, None]
    return _llama.decode_step(params, cfg, token, seq_lens, k_pages,
                              v_pages, page_table,
                              ffn=_routed_ffn(cfg, valid))


@torch.no_grad()
def verify_step(params, cfg: MoEConfig, tokens, seq_lens, k_pages,
                v_pages, page_table, valid_len=None):
    """``llama.verify_step`` with the routed FFN (pages updated in place).
    Padded columns (j >= valid_len[b]) stay out of routing and
    capacity."""
    ok = None
    if valid_len is not None:
        m = tokens.shape[1]
        ok = (torch.arange(m, device=tokens.device)[None, :]
              < valid_len.to(tokens.device).long()[:, None])
    return _llama.verify_step(params, cfg, tokens, seq_lens, k_pages,
                              v_pages, page_table, valid_len,
                              ffn=_routed_ffn(cfg, ok))


def loss_fn(params, cfg: MoEConfig, tokens):
    """Next-token NLL of tokens [batch, seq + 1] plus aux_loss_weight x
    the summed aux loss."""
    logits, _, aux = forward_dense(params, cfg, tokens[:, :-1])
    return (_llama.token_nll(logits, tokens[:, 1:])
            + cfg.aux_loss_weight * aux)


def train_step(params, optimizer, cfg: MoEConfig, tokens):
    """The shared optimizer step (``llama.train_step``; optimizer from
    ``llama.adamw``) with this family's loss. Leaves update in place;
    returns the loss before the step."""
    return _llama.train_step(params, optimizer, cfg, tokens, loss=loss_fn)


__all__ = [
    "MoEConfig", "init_params", "forward_dense", "prefill",
    "prefill_with_prefix", "decode_step", "verify_step", "loss_fn",
    "train_step",
]

"""Llama-style decoder with a paged KV cache, in PyTorch.

The counterpart of ``infinistore_tpu/models/llama.py``: the same
``LlamaConfig``, the same parameter leaf names (a plain dict), the same
GQA + RoPE (with Llama-3.1 scaling) + SwiGLU stack, and the same page
layout the store moves. Attention goes only through the dispatchers of
``ops.flash_attention``, ``ops.paged_flash_decode`` and
``ops.paged_flash_verify``: the CUDA kernels for tensors on the card,
their plain versions for CPU tensors.

Training (``loss_fn``, ``train_step``) differentiates the dense forward
with autograd: parameters stay a plain dict whose leaves require grad
(:func:`trainable`), attention's gradient is ``ops.flash_attention``'s
recompute backward (kernels K5 and K6 on the card), and the optimizer is
``torch.optim.AdamW`` with optax's ``adamw`` defaults (:func:`adamw`).
``decode_step`` and ``verify_step`` run without grad.

Int8 weight-only quantization (``quantize_params``,
``init_params_quantized``): every 2-D matmul weight becomes an
``{"int8", "scale"}`` leaf (per output column; per row for the
embedding), which ``_matmul`` and ``_embed`` dequantize at use. Each
call builds the weight in the compute dtype first (``int8.to(dtype)``):
the semantics of the JAX package, whose XLA fuses that convert into the
matmul's operand fetch; a GEMM that dequantizes its tiles is not written
yet. Training over int8 leaves is not supported (:func:`trainable`
raises), as in the JAX package.

Tensor parallelism: every model call takes an optional ``tp`` (a
``parallel.mesh.TensorParallel``) and then computes this rank's heads
and ffn columns of a Megatron-sharded tree, with the collectives
explicit (the JAX package lets GSPMD insert them); KV and pages hold
this rank's kv heads. ``tp=None`` is the single-device path. Under tp
an int8 tree computes on each rank's int8 block through ``_matmul`` and
the int8 embedding lookup, as one device does (a row-parallel weight's
scale multiplies once, after the all-reduce), and a routed FFN (the
MoE's ``ffn`` hook) runs on the replicated experts. Training over int8
leaves stays refused, under tp and FSDP too (:func:`trainable`).
"""

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .._device import disable_tf32, resolve_device
from ..ops.flash_attention import flash_prefill
from ..ops.paged_attention import drop_mode_rows, scatter_rows
from ..ops.paged_flash_decode import decode_attention
from ..ops.paged_flash_verify import verify_attention

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 512
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256
    max_seq: int = 256
    page_size: int = 16  # tokens per KV page (the store's transfer unit)
    rope_theta: float = 10000.0
    # (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings) of Llama-3.1 "llama3" RoPE
    # scaling; () = unscaled.
    rope_scaling: tuple = ()
    window: int = 0  # sliding-window width; 0 = full causal attention
    norm_eps: float = 1e-5
    act: str = "silu"            # "silu" | "gelu" (tanh) | "gelu_exact"
    norm_plus_one: bool = False  # rms_norm multiplies by (1 + w)
    embed_scale: float = 1.0     # embedding output multiplier
    head_dim_override: int = 0   # 0 = d_model // n_heads
    dtype: str = "bfloat16"

    @property
    def head_dim(self):
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def torch_dtype(self):
        return _TORCH_DTYPES[self.dtype]

    def kv_page_shape(self):
        """Shape of one K (or V) page for ONE layer — one store block:
        [page_size, n_kv_heads, head_dim]."""
        return (self.page_size, self.n_kv_heads, self.head_dim)

    def kv_page_bytes(self):
        return (int(np.prod(self.kv_page_shape()))
                * torch.empty((), dtype=self.torch_dtype).element_size())


# meta-llama/Llama-3.1-8B config.json geometry (bf16, 16-token pages).
LLAMA31_8B = LlamaConfig(
    vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_ff=14336, max_seq=8192, page_size=16, rope_theta=500000.0,
    rope_scaling=(8.0, 1.0, 4.0, 8192), norm_eps=1e-5, dtype="bfloat16",
)


def _layer_shapes(cfg):
    """The 2-D weights of one layer and their shapes, in draw order."""
    d, q, kv = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                cfg.n_kv_heads * cfg.head_dim)
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d)}


def _random_tree(cfg, device, weight):
    """A parameter dict of ``cfg``'s leaves: norms at one, each 2-D
    weight from ``weight(shape, per_row)`` (per_row for the embedding,
    which is consumed by gather), drawn embed, lm_head, then each layer's
    in ``_layer_shapes`` order."""
    def ones():
        return torch.ones(cfg.d_model, dtype=cfg.torch_dtype, device=device)

    embed = weight((cfg.vocab_size, cfg.d_model), True)
    lm_head = weight((cfg.d_model, cfg.vocab_size), False)
    layers = [{**{name: weight(shape, False)
                  for name, shape in _layer_shapes(cfg).items()},
               "ln1": ones(), "ln2": ones()} for _ in range(cfg.n_layers)]
    return {"embed": embed, "layers": layers, "final_ln": ones(),
            "lm_head": lm_head}


def init_params(generator, cfg: LlamaConfig, device="cuda"):
    """Random parameters (normal * d_model**-0.5, norms at one) drawn
    from ``generator``, which must live on ``device``. Same leaf names
    and shapes as the JAX package's ``init_params``; the numbers differ
    (another generator)."""
    device = resolve_device(device)
    scale = cfg.d_model ** -0.5

    def dense(shape, _per_row):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(cfg.torch_dtype)

    return _random_tree(cfg, device, dense)


# 2-D matmul weights eligible for int8 weight-only quantization; norms
# and biases (1-D, negligible bytes) stay in the compute dtype.
_QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_leaf(w, dtype, axis=0):
    """Symmetric absmax int8: {"int8": int8 [in, out], "scale": dtype}.

    axis=0: per-OUTPUT-column scales [out], the matmul form, where
    (x @ int8) * scale is exact with respect to the quantized weights.
    axis=1: per-ROW scales [in], the gather form of the embedding
    table, where each token's row is its own quantization unit.
    All-zero groups get scale 0 (their values are 0 anyway)."""
    wf = w.float()
    scale = wf.abs().amax(dim=axis) / 127.0
    denom = torch.where(scale > 0, scale, torch.ones_like(scale))
    denom = denom[None, :] if axis == 0 else denom[:, None]
    q = torch.round(wf / denom).clamp_(-127, 127)
    return {"int8": q.to(torch.int8), "scale": scale.to(dtype)}


def quantize_params(params, cfg: LlamaConfig):
    """Weight-only int8 quantization of a bf16/f32 parameter dict: every
    2-D matmul weight (attention, MLP, embed, lm_head) becomes an
    {"int8", "scale"} leaf; norms and biases stay. The embedding, which
    is consumed by gather, gets per-row scales."""
    dt = cfg.torch_dtype
    layers = [{name: _quantize_leaf(w, dt) if name in _QUANT_LEAVES else w
               for name, w in layer.items()} for layer in params["layers"]]
    return {
        "embed": _quantize_leaf(params["embed"], dt, axis=1),
        "layers": layers,
        "final_ln": params["final_ln"],
        "lm_head": _quantize_leaf(params["lm_head"], dt),
    }


def init_params_quantized(generator, cfg: LlamaConfig, device="cuda"):
    """Random int8-quantized parameters drawn from ``generator`` (on
    ``device``) without ever building the dense tree: weights draw
    uniform int8 in [-127, 127] (std 127 / sqrt(3)), so the scale
    sqrt(3) * d_model**-0.5 / 127 matches init_params' normal(0,
    d_model**-0.5) std. Same leaves as quantize_params' output."""
    device = resolve_device(device)
    col_scale = (3.0 ** 0.5) * cfg.d_model ** -0.5 / 127.0

    def qdense(shape, per_row):
        q = torch.randint(-127, 128, shape, generator=generator,
                          device=device, dtype=torch.int8)
        return {"int8": q, "scale": torch.full(
            (shape[0 if per_row else 1],), col_scale, dtype=cfg.torch_dtype,
            device=device)}

    return _random_tree(cfg, device, qdense)


def param_bytes(params):
    """Total bytes of every tensor leaf (int8 trees count int8)."""
    return sum(t.numel() * t.element_size() for t in param_leaves(params))


def _leaf_from_numpy(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        # bf16 travels as its 16 raw bits (no numpy bf16 dtype needed).
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(tree, device="cuda"):
    """The JAX package's parameter tree, as numpy arrays (bf16 leaves as
    their uint16 bits, or arrays whose dtype is named bfloat16), turned
    into this module's dict on ``device`` (the card unless
    ``device="cpu"``) — so both packages compute the same function on the
    same weights. Quantized trees carry their {"int8", "scale"} leaves
    across unchanged."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _leaf_from_numpy(x, device)

    return conv(tree)


def rms_norm(x, w, eps=1e-5, plus_one=False):
    """plus_one: stored weights are zero-centered, applied as (1 + w)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    xn = x * torch.rsqrt(var + eps).to(x.dtype)
    return xn * (1.0 + w) if plus_one else xn * w


def _llama3_scale_freqs(freqs, scaling):
    """Llama-3.1 frequency-dependent RoPE rescale (HF
    ``_compute_llama3_parameters``)."""
    factor, low_f, high_f, orig_max = scaling
    wavelen = 2.0 * math.pi / freqs
    low_wl = orig_max / low_f
    high_wl = orig_max / high_f
    smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
    mid = (1.0 - smooth) * freqs / factor + smooth * freqs
    return torch.where(
        wavelen > low_wl, freqs / factor,
        torch.where(wavelen < high_wl, freqs, mid),
    )


@functools.lru_cache(maxsize=16)
def _rope_freqs(half, theta, scaling, device):
    """Rotary frequencies, computed once per (width, theta, scaling,
    device): rebuilding them on the host every call would copy them to
    the card twice per layer and step."""
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(
        -log_theta * torch.arange(0, half, dtype=torch.float32) / half)
    if scaling:
        freqs = _llama3_scale_freqs(freqs, scaling)
    return freqs.to(device)


def rope(x, positions, theta, scaling=()):
    """x: [..., seq, heads, hd]; positions broadcastable to [..., seq]."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), tuple(scaling), x.device)
    angles = positions[..., None].float() * freqs  # [..., s, half]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _matmul(h, w):
    """h @ W, where W is a dense tensor or an int8 weight-only leaf
    {"int8": [in, out] int8, "scale": [out]}: then (h @ int8) * scale in
    h's dtype, equal to h @ (int8 * scale) because the scale is per
    output column."""
    if isinstance(w, dict):
        return (h @ w["int8"].to(h.dtype)) * w["scale"].to(h.dtype)
    return h @ w


def _row_parallel(h, w, tp):
    """h @ W of a row-parallel weight (wo, w_down) under ``tp``: each
    rank's product over its rows, summed over tp. An int8 leaf's scale
    (per output column, whole on every rank) multiplies once, after the
    sum, as one device's (h @ int8) * scale applies it to the finished
    sum: the tp result then differs from one device's only in how the
    sum is grouped, as a dense weight's does, and the multiply runs
    once, not on each rank's partial."""
    if isinstance(w, dict):
        return tp.reduce(h @ w["int8"].to(h.dtype)) * w["scale"].to(h.dtype)
    return tp.reduce(h @ w)


def _proj(h, layer, w, b_, shape=None):
    """_matmul with an optional bias leaf (bq/bk/bv/bo)."""
    out = _matmul(h, layer[w])
    bias = layer.get(b_)
    if bias is not None:
        out = out + bias
    return out if shape is None else out.reshape(shape)


def _qkv(layer, x, cfg, positions, tp=None):
    """q, k, v of this rank's heads (all heads without ``tp``)."""
    b, s = x.shape[0], x.shape[1]
    h = rms_norm(x, layer["ln1"], cfg.norm_eps, cfg.norm_plus_one)
    n_heads, n_kv = cfg.n_heads, cfg.n_kv_heads
    if tp is not None:
        h = tp.enter(h)
        n_heads, n_kv = n_heads // tp.tp, n_kv // tp.tp
    q = _proj(h, layer, "wq", "bq", (b, s, n_heads, cfg.head_dim))
    k = _proj(h, layer, "wk", "bk", (b, s, n_kv, cfg.head_dim))
    v = _proj(h, layer, "wv", "bv", (b, s, n_kv, cfg.head_dim))
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    return q, k, v


def _attn_out(layer, attn_flat, tp=None):
    """The attention output projection; under ``tp`` row-parallel: the
    partial products are summed over tp, then ``bo`` is added once."""
    if tp is None:
        return _proj(attn_flat, layer, "wo", "bo")
    out = _row_parallel(attn_flat, layer["wo"], tp)
    bias = layer.get("bo")
    return out if bias is None else out + bias


def _act(cfg, x):
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu_exact":
        return F.gelu(x)
    return F.gelu(x, approximate="tanh")


def _mlp(layer, x, cfg, tp=None):
    """SwiGLU MLP; under ``tp`` gate/up column- and down row-parallel."""
    h = rms_norm(x, layer["ln2"], cfg.norm_eps, cfg.norm_plus_one)
    if tp is not None:
        h = tp.enter(h)
    gated = _act(cfg, _matmul(h, layer["w_gate"])) * _matmul(h, layer["w_up"])
    if tp is None:
        return _matmul(gated, layer["w_down"])
    return _row_parallel(gated, layer["w_down"], tp)


def _embed(params, tokens, cfg=None, tp=None):
    """Token embedding gather; an int8 embedding gathers its int8 rows
    and their per-row scales (the scale leaf carries the compute
    dtype). Under ``tp`` each rank gathers its d_model columns (of the
    int8 rows, times the whole per-row scale) and the rows are
    all-gathered."""
    idx = tokens.long()
    if tp is None:
        return _scale_embed(_embed_rows(params["embed"], idx), cfg)
    return _scale_embed(
        tp.gather(_embed_rows(tp.local(params["embed"]), idx)), cfg)


def _embed_rows(e, idx):
    """Rows ``idx`` of an embedding table, dense or int8."""
    if isinstance(e, dict):
        row_scale = e["scale"][idx]
        return e["int8"][idx].to(row_scale.dtype) * row_scale[..., None]
    return e[idx]


def _scale_embed(out, cfg):
    if cfg is not None and cfg.embed_scale != 1.0:
        out = out * torch.tensor(cfg.embed_scale, dtype=out.dtype)
    return out


def _logits(params, x, tp=None):
    """Final projection to vocab, float32 output; under ``tp`` each rank
    projects onto its vocab columns and the columns are all-gathered
    (in the compute dtype, then widened, as the single-device path)."""
    if tp is None:
        return _matmul(x, params["lm_head"]).float()
    return tp.gather(_matmul(tp.enter(x),
                             tp.local(params["lm_head"]))).float()


def _tp_begin(params, cfg, tp):
    """Checks of a tensor-parallel call; returns the final norm's leaf."""
    if tp is None:
        return params["final_ln"]
    tp.check(cfg)
    return tp.local(params["final_ln"])


def _layers(params, tp):
    """The layers' leaves as the model computes on them: tp-local (and
    gathered over dp where FSDP shards them) one layer at a time."""
    for layer in params["layers"]:
        yield layer if tp is None else tp.layer(layer)


def _forward_stack(params, cfg: LlamaConfig, tokens, prefix_kvs=None,
                   pos0=0, ffn=None, tp=None):
    """The one decoder-stack loop shared by dense prefill and prefix-
    cached prefill. With ``prefix_kvs`` (per-layer (k, v), each
    [batch, P, n_kv, hd], post-RoPE) positions shift by P and each layer
    attends over prefix + suffix KV (the rectangular causal diagonal);
    ``pos0`` shifts every absolute rope position. ``ffn(layer, x)``
    replaces the dense MLP: another family's feed-forward block
    (``models.moe`` passes its routed experts). ``tp``, a
    ``parallel.mesh.TensorParallel``, runs the stack Megatron-sharded:
    each rank computes its heads and ffn columns (KV of its kv heads)
    and the logits are gathered whole on every rank. An ``ffn`` under
    ``tp`` takes the rank's local leaves of the layer and the x that the
    attention's all-reduce left the same on every rank, and adds no
    collective: its leaves have no tp rule, so they are whole on every
    rank (the JAX placement of the MoE's router and experts)."""
    disable_tf32()
    final_ln = _tp_begin(params, cfg, tp)
    b, s = tokens.shape
    prefix_len = 0 if prefix_kvs is None else prefix_kvs[0][0].shape[1]
    x = _embed(params, tokens, cfg, tp)
    positions = (pos0 + prefix_len
                 + torch.arange(s, device=tokens.device))[None].expand(b, s)
    kvs = []
    for li, layer in enumerate(_layers(params, tp)):
        x, kv = decoder_layer(layer, x, cfg, positions,
                              None if prefix_kvs is None else prefix_kvs[li],
                              ffn, tp)
        kvs.append(kv)
    x = rms_norm(x, final_ln, cfg.norm_eps, cfg.norm_plus_one)
    return _logits(params, x, tp), kvs


def decoder_layer(layer, x, cfg: LlamaConfig, positions, prefix_kv=None,
                  ffn=None, tp=None):
    """One layer of the dense decoder stack: x [batch, s, d_model] at rope
    ``positions`` [batch, s] -> (x after the layer, its (k, v)). With
    ``prefix_kv`` ((k, v) [batch, P, n_kv, hd], post-RoPE) attention
    covers prefix + suffix; ``ffn`` and ``tp`` as :func:`_forward_stack`
    takes them. The pipeline's stages run layers through it."""
    b, s = x.shape[:2]
    q, k, v = _qkv(layer, x, cfg, positions, tp)
    if prefix_kv is None:
        k_full, v_full = k, v
    else:
        pk, pv = prefix_kv
        k_full = torch.cat([pk.to(k.dtype), k], dim=1)
        v_full = torch.cat([pv.to(v.dtype), v], dim=1)
    attn = flash_prefill(q.contiguous(), k_full.contiguous(),
                         v_full.contiguous(), causal=True, window=cfg.window)
    x = x + _attn_out(layer, attn.reshape(b, s, -1), tp)
    x = x + (_mlp(layer, x, cfg, tp) if ffn is None else ffn(layer, x))
    return x, (k, v)


def forward_dense(params, cfg: LlamaConfig, tokens, tp=None):
    """Dense causal forward (training and prefill compute): tokens
    [batch, seq] -> (logits [batch, seq, vocab] float32, per-layer (k, v)
    [batch, seq, n_kv, hd]). Differentiable when the leaves require
    grad. Under ``tp`` the KV is this rank's kv heads'."""
    return _forward_stack(params, cfg, tokens, tp=tp)


def prefill(params, cfg: LlamaConfig, tokens, tp=None):
    """tokens [batch, seq] -> (logits [batch, seq, vocab] float32,
    per-layer (k, v) [batch, seq, n_kv, hd]) — the KV to page out."""
    return forward_dense(params, cfg, tokens, tp=tp)


def prefill_with_prefix(params, cfg: LlamaConfig, tokens, prefix_kvs,
                        pos0=0, tp=None):
    """Suffix prefill over a cached prefix — the store's cache-hit path.

    tokens: [batch, s_new], the tokens that are not cached; prefix_kvs:
    per-layer (k, v) [batch, P, n_kv, hd], post-RoPE (as ``prefill``
    made them, or restored through ``pages_to_kv``). Only the suffix runs
    through the QKV/MLP matmuls; attention covers prefix + suffix.
    Returns (logits [batch, s_new, vocab] float32, per-layer suffix
    (k, v))."""
    return _forward_stack(params, cfg, tokens, prefix_kvs, pos0=pos0, tp=tp)


@torch.no_grad()
def decode_step(params, cfg: LlamaConfig, token, seq_lens, k_pages, v_pages,
                page_table, ffn=None, tp=None):
    """One decode step over paged KV.

    token:      [batch] int — current input token
    seq_lens:   [batch] int32 — tokens already in cache (excl. current)
    k_pages/v_pages: [n_layers, n_pages, page, n_kv, hd]
    page_table: [batch, max_pages] int32

    The new token's KV is scattered into its page IN PLACE: ``k_pages``
    and ``v_pages`` are updated and returned (the JAX version returns new
    arrays). Attention covers seq_lens + 1 tokens. ``ffn(layer, x)``
    replaces the dense MLP, as in :func:`_forward_stack`. Under ``tp``
    the pages hold this rank's kv heads and each rank's attention is the
    rank-local launch over them. Returns (logits [batch, vocab] float32,
    k_pages, v_pages)."""
    disable_tf32()
    final_ln = _tp_begin(params, cfg, tp)
    b = token.shape[0]
    n_pages = k_pages.shape[1]
    x = _embed(params, token[:, None], cfg, tp)  # [b, 1, d]
    positions = seq_lens[:, None]
    page_idx = (seq_lens // cfg.page_size).long()
    in_table = page_idx < page_table.shape[1]
    target_page = page_table.gather(
        1, page_idx.clamp(max=page_table.shape[1] - 1)[:, None])[:, 0]
    # A position past the table has no page: aim it outside the pool so
    # the scatter drops it.
    target_page = torch.where(in_table, target_page.long(), n_pages)
    slot = seq_lens % cfg.page_size
    lens = (seq_lens + 1).to(torch.int32)
    # Every layer writes the same (page, slot): find the targets once
    # (the scatter drops those outside the pool, as JAX's mode="drop").
    entries, rows = drop_mode_rows(target_page[:, None], slot[:, None],
                                   n_pages, cfg.page_size)

    for li, layer in enumerate(_layers(params, tp)):
        q, k, v = _qkv(layer, x, cfg, positions, tp)
        kp = scatter_rows(k_pages[li], k, entries, rows)
        vp = scatter_rows(v_pages[li], v, entries, rows)
        attn = decode_attention(q[:, 0].contiguous(), kp, vp, page_table,
                                lens, window=cfg.window)
        x = x + _attn_out(layer, attn.reshape(b, 1, -1), tp)
        x = x + (_mlp(layer, x, cfg, tp) if ffn is None else ffn(layer, x))
    x = rms_norm(x, final_ln, cfg.norm_eps, cfg.norm_plus_one)
    return _logits(params, x[:, 0], tp), k_pages, v_pages


@torch.no_grad()
def verify_step(params, cfg: LlamaConfig, tokens, seq_lens, k_pages,
                v_pages, page_table, valid_len=None, ffn=None, tp=None):
    """m-token decode over paged KV: speculative decoding's verify step
    and the chunked-prefill inner step. Consumes m tokens per sequence in
    one pass and returns next-token logits at every one of the m
    positions, as if ``decode_step`` had run m times.

    tokens:     [batch, m] int — token j lands at position seq_lens[b] + j
    seq_lens:   [batch] int32 — tokens already in cache (excl. these m)
    k_pages/v_pages: [n_layers, n_pages, page, n_kv, hd]
    page_table: [batch, max_pages] int32
    valid_len:  [batch] int or None — real tokens per row; padded columns
                (j >= valid_len[b]) write their KV into page 0 (the
                engine's scratch page) at slot j % page_size. None: all m
                are real.

    The m tokens' KV is scattered into the pages IN PLACE: ``k_pages``
    and ``v_pages`` are updated and returned (the JAX version returns new
    arrays). A position past the page table is dropped. ``ffn(layer,
    x)`` replaces the dense MLP, as in :func:`_forward_stack`. Under
    ``tp`` the pages hold this rank's kv heads, as in
    :func:`decode_step`. Returns (logits [batch, m, vocab] float32,
    k_pages, v_pages)."""
    disable_tf32()
    final_ln = _tp_begin(params, cfg, tp)
    b, m = tokens.shape
    n_pages = k_pages.shape[1]
    page = cfg.page_size
    x = _embed(params, tokens, cfg, tp)  # [b, m, d]
    cols = torch.arange(m, device=tokens.device)
    positions = seq_lens.long()[:, None] + cols[None, :]
    page_idx = positions // page
    in_table = page_idx < page_table.shape[1]
    target_page = page_table.gather(
        1, page_idx.clamp(max=page_table.shape[1] - 1)).long()
    # A position past the table has no page: aim it outside the pool so
    # the scatter drops it.
    target_page = torch.where(in_table, target_page, n_pages)
    slot = positions % page
    if valid_len is not None:
        ok = cols[None, :] < valid_len.to(tokens.device).long()[:, None]
        target_page = torch.where(ok, target_page, 0)
        slot = torch.where(ok, slot, (cols % page)[None, :])
    # Every layer writes the same (page, slot) targets: find them once.
    entries, rows = drop_mode_rows(target_page, slot, n_pages, page)
    lens = seq_lens.to(torch.int32)

    for li, layer in enumerate(_layers(params, tp)):
        q, k, v = _qkv(layer, x, cfg, positions, tp)
        kp = scatter_rows(k_pages[li], k, entries, rows)
        vp = scatter_rows(v_pages[li], v, entries, rows)
        attn = verify_attention(q.contiguous(), kp, vp, page_table, lens,
                                window=cfg.window)
        x = x + _attn_out(layer, attn.reshape(b, m, -1), tp)
        x = x + (_mlp(layer, x, cfg, tp) if ffn is None else ffn(layer, x))
    x = rms_norm(x, final_ln, cfg.norm_eps, cfg.norm_plus_one)
    return _logits(params, x, tp), k_pages, v_pages


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def token_nll(logits, targets):
    """Mean next-token NLL (float32 log-softmax) — shared by every model
    family's loss."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def loss_fn(params, cfg: LlamaConfig, tokens, tp=None):
    """Next-token cross-entropy (float32 accumulation) of tokens [batch,
    seq + 1] (under ``tp`` this rank's rows: the mean over them)."""
    logits, _ = forward_dense(params, cfg, tokens[:, :-1], tp=tp)
    return token_nll(logits, tokens[:, 1:])


def param_leaves(params):
    """Every parameter tensor of the dict, in sorted-key order (as JAX
    flattens a dict)."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in param_leaves(v)]
    return [params]


def trainable(params):
    """Make every leaf require grad (in place) and return the leaves, the
    list an optimizer takes. Int8 leaves (``quantize_params``) cannot be
    trained: train the dense tree and quantize it afterwards."""
    leaves = param_leaves(params)
    if any(not t.is_floating_point() for t in leaves):
        raise TypeError(
            "training over int8 weight leaves is not supported: train the "
            "dense parameters and quantize_params them afterwards")
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def adamw(params, lr):
    """The counterpart of ``optax.adamw(lr)``: AdamW over every leaf with
    optax's defaults (b1 0.9, b2 0.999, eps 1e-8 added to the bias-
    corrected root, decoupled weight decay 1e-4). Moments take each
    leaf's dtype, as optax's do (bf16 leaves keep bf16 moments)."""
    return torch.optim.AdamW(trainable(params), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def train_step(params, optimizer, cfg, tokens, loss=None, tp=None):
    """One optimizer step: zero the grads, forward, backward, step. The
    ONE optimizer-step implementation for all model families — pass
    ``loss`` (called as loss(params, cfg, tokens)) to train another. The
    leaves of ``params`` are updated IN PLACE (the JAX version returns
    new ones). Returns the loss (detached, before the step).

    Under ``tp`` (a ``parallel.mesh.TensorParallel``; ``params`` the
    DTensors of ``shard_params``, ``tokens`` this rank's dp rows) the
    step follows the global mean loss, as ``jax.jit`` over dp-sharded
    tokens does: each rank differentiates its own mean over dp, the grads are
    summed over dp (reduce-scattered in the backward for FSDP leaves),
    and the global loss is returned."""
    loss_f = loss_fn if loss is None else loss
    optimizer.zero_grad(set_to_none=True)
    if tp is None:
        value = loss_f(params, cfg, tokens)
        value.backward()
        optimizer.step()
        return value.detach()
    value = loss_f(params, cfg, tokens, tp=tp)
    (value / tp.dp).backward()
    tp.reduce_grads(params)
    optimizer.step()
    return tp.dp_mean(value.detach())


# ---------------------------------------------------------------------------
# KV paging helpers: model pages <-> store pages
# ---------------------------------------------------------------------------

def kv_to_pages(cfg: LlamaConfig, k, v):
    """Prefill KV [batch, seq, n_kv, hd] -> (k_pages, v_pages)
    [batch, n_pages, page, n_kv, hd], zero-padded in the tail page."""
    b, s, n_kv, hd = k.shape
    n_pages = -(-s // cfg.page_size)
    pad = n_pages * cfg.page_size - s
    shape = (b, n_pages, cfg.page_size, n_kv, hd)
    k = F.pad(k, (0, 0, 0, 0, 0, pad))
    v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k.reshape(shape), v.reshape(shape)


def pages_to_kv(cfg: LlamaConfig, k_pages, v_pages, length):
    """Inverse of :func:`kv_to_pages`: [batch, n_pages, page, n_kv, hd]
    -> (k, v) [batch, length, n_kv, hd]."""
    b, n_pages, page, n_kv, hd = k_pages.shape
    k = k_pages.reshape(b, n_pages * page, n_kv, hd)[:, :length]
    v = v_pages.reshape(b, n_pages * page, n_kv, hd)[:, :length]
    return k, v


def page_keys(prefix, layer, kind, n_pages):
    """Store keys for a sequence's pages, one namespace per (layer,
    k/v) — the same keys the JAX package writes."""
    return [f"{prefix}/L{layer}/{kind}/p{i}" for i in range(n_pages)]


def restore_prefix_pages(store, cfg: LlamaConfig, key_fn, n_pages,
                         getter=None):
    """Restore a matched prefix in page form with ONE batched store call
    over every (layer, kind). ``key_fn(layer, kind)`` gives that pair's
    n_pages keys; ``getter`` overrides ``store.get_kv_pages``. Returns
    (k_pages, v_pages) [n_layers, n_pages, page, n_kv, hd] on the
    store's device."""
    get = getter if getter is not None else store.get_kv_pages
    keys = []
    for li in range(cfg.n_layers):
        keys.extend(key_fn(li, "k"))
        keys.extend(key_fn(li, "v"))
    flat = get(keys, cfg.kv_page_shape(), cfg.torch_dtype)
    both = flat.reshape(cfg.n_layers, 2, n_pages, *cfg.kv_page_shape())
    return both[:, 0], both[:, 1]


def restore_prefix_kvs(store, cfg: LlamaConfig, seq_id, n_pages):
    """Restore a matched prefix into the per-layer contiguous (k, v) list
    that :func:`prefill_with_prefix` takes (batch 1), after
    ``store.cached_prefix_len`` reported ``n_pages`` hits for
    ``seq_id``."""
    kp, vp = restore_prefix_pages(
        store, cfg, lambda li, kind: page_keys(seq_id, li, kind, n_pages),
        n_pages,
    )
    return [
        pages_to_kv(cfg, kp[li][None], vp[li][None],
                    n_pages * cfg.page_size)
        for li in range(cfg.n_layers)
    ]

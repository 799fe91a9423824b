"""Llama-style decoder with a paged KV cache, in PyTorch.

The counterpart of ``infinistore_tpu/models/llama.py``: the same
``LlamaConfig``, the same parameter leaf names (a plain dict), the same
GQA + RoPE (with Llama-3.1 scaling) + SwiGLU stack, and the same page
layout the store moves. Attention goes only through the dispatchers of
``ops.flash_attention`` and ``ops.paged_flash_decode``: the CUDA kernels
for tensors on the card, their plain versions for CPU tensors.

Not in this module yet: ``verify_step``, ``loss_fn``/``train_step`` and
int8 weights (``quantize_params``).
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


def init_params(generator, cfg: LlamaConfig, device="cuda"):
    """Random parameters (normal * d_model**-0.5, norms at one) drawn
    from ``generator``, which must live on ``device``. Same leaf names
    and shapes as the JAX package's ``init_params``; the numbers differ
    (another generator)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    scale = cfg.d_model ** -0.5

    def dense(shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dt)

    def ones():
        return torch.ones(cfg.d_model, dtype=dt, device=device)

    embed = dense((cfg.vocab_size, cfg.d_model))
    lm_head = dense((cfg.d_model, cfg.vocab_size))
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": ones(),
            "wq": dense((cfg.d_model, cfg.n_heads * cfg.head_dim)),
            "wk": dense((cfg.d_model, cfg.n_kv_heads * cfg.head_dim)),
            "wv": dense((cfg.d_model, cfg.n_kv_heads * cfg.head_dim)),
            "wo": dense((cfg.n_heads * cfg.head_dim, cfg.d_model)),
            "ln2": ones(),
            "w_gate": dense((cfg.d_model, cfg.d_ff)),
            "w_up": dense((cfg.d_model, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, cfg.d_model)),
        })
    return {"embed": embed, "layers": layers, "final_ln": ones(),
            "lm_head": lm_head}


def _leaf_from_numpy(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        # bf16 travels as its 16 raw bits (no numpy bf16 dtype needed).
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(tree, device="cpu"):
    """The JAX package's parameter tree, as numpy arrays (bf16 leaves as
    their uint16 bits, or arrays whose dtype is named bfloat16), turned
    into this module's dict on ``device`` — so both packages compute the
    same function on the same weights."""
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


def _proj(h, layer, w, b_, shape=None):
    """h @ W with an optional bias leaf (bq/bk/bv/bo)."""
    out = h @ layer[w]
    bias = layer.get(b_)
    if bias is not None:
        out = out + bias
    return out if shape is None else out.reshape(shape)


def _qkv(layer, x, cfg, positions):
    b, s = x.shape[0], x.shape[1]
    h = rms_norm(x, layer["ln1"], cfg.norm_eps, cfg.norm_plus_one)
    q = _proj(h, layer, "wq", "bq", (b, s, cfg.n_heads, cfg.head_dim))
    k = _proj(h, layer, "wk", "bk", (b, s, cfg.n_kv_heads, cfg.head_dim))
    v = _proj(h, layer, "wv", "bv", (b, s, cfg.n_kv_heads, cfg.head_dim))
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    return q, k, v


def _attn_out(layer, attn_flat):
    return _proj(attn_flat, layer, "wo", "bo")


def _act(cfg, x):
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu_exact":
        return F.gelu(x)
    return F.gelu(x, approximate="tanh")


def _mlp(layer, x, cfg):
    h = rms_norm(x, layer["ln2"], cfg.norm_eps, cfg.norm_plus_one)
    return (_act(cfg, h @ layer["w_gate"]) * (h @ layer["w_up"])) \
        @ layer["w_down"]


def _embed(params, tokens, cfg=None):
    out = params["embed"][tokens.long()]
    if cfg is not None and cfg.embed_scale != 1.0:
        out = out * torch.tensor(cfg.embed_scale, dtype=out.dtype)
    return out


def _logits(params, x):
    """Final projection to vocab, float32 output."""
    return (x @ params["lm_head"]).float()


def _forward_stack(params, cfg: LlamaConfig, tokens, prefix_kvs=None,
                   pos0=0):
    """The one decoder-stack loop shared by dense prefill and prefix-
    cached prefill. With ``prefix_kvs`` (per-layer (k, v), each
    [batch, P, n_kv, hd], post-RoPE) positions shift by P and each layer
    attends over prefix + suffix KV (the rectangular causal diagonal);
    ``pos0`` shifts every absolute rope position."""
    disable_tf32()
    b, s = tokens.shape
    prefix_len = 0 if prefix_kvs is None else prefix_kvs[0][0].shape[1]
    x = _embed(params, tokens, cfg)
    positions = (pos0 + prefix_len
                 + torch.arange(s, device=tokens.device))[None].expand(b, s)
    kvs = []
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, positions)
        if prefix_kvs is None:
            k_full, v_full = k, v
        else:
            pk, pv = prefix_kvs[li]
            k_full = torch.cat([pk.to(k.dtype), k], dim=1)
            v_full = torch.cat([pv.to(v.dtype), v], dim=1)
        attn = flash_prefill(q.contiguous(), k_full.contiguous(),
                             v_full.contiguous(), causal=True,
                             window=cfg.window)
        x = x + _attn_out(layer, attn.reshape(b, s, -1))
        x = x + _mlp(layer, x, cfg)
        kvs.append((k, v))
    x = rms_norm(x, params["final_ln"], cfg.norm_eps, cfg.norm_plus_one)
    return _logits(params, x), kvs


def prefill(params, cfg: LlamaConfig, tokens):
    """tokens [batch, seq] -> (logits [batch, seq, vocab] float32,
    per-layer (k, v) [batch, seq, n_kv, hd]) — the KV to page out."""
    return _forward_stack(params, cfg, tokens)


def prefill_with_prefix(params, cfg: LlamaConfig, tokens, prefix_kvs,
                        pos0=0):
    """Suffix prefill over a cached prefix — the store's cache-hit path.

    tokens: [batch, s_new], the tokens that are not cached; prefix_kvs:
    per-layer (k, v) [batch, P, n_kv, hd], post-RoPE (as ``prefill``
    made them, or restored through ``pages_to_kv``). Only the suffix runs
    through the QKV/MLP matmuls; attention covers prefix + suffix.
    Returns (logits [batch, s_new, vocab] float32, per-layer suffix
    (k, v))."""
    return _forward_stack(params, cfg, tokens, prefix_kvs, pos0=pos0)


@torch.no_grad()
def decode_step(params, cfg: LlamaConfig, token, seq_lens, k_pages, v_pages,
                page_table):
    """One decode step over paged KV.

    token:      [batch] int — current input token
    seq_lens:   [batch] int32 — tokens already in cache (excl. current)
    k_pages/v_pages: [n_layers, n_pages, page, n_kv, hd]
    page_table: [batch, max_pages] int32

    The new token's KV is scattered into its page IN PLACE: ``k_pages``
    and ``v_pages`` are updated and returned (the JAX version returns new
    arrays). Attention covers seq_lens + 1 tokens. Returns (logits
    [batch, vocab] float32, k_pages, v_pages)."""
    disable_tf32()
    b = token.shape[0]
    n_pages = k_pages.shape[1]
    x = _embed(params, token[:, None], cfg)  # [b, 1, d]
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

    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, x, cfg, positions)
        kp = scatter_rows(k_pages[li], k, entries, rows)
        vp = scatter_rows(v_pages[li], v, entries, rows)
        attn = decode_attention(q[:, 0].contiguous(), kp, vp, page_table,
                                lens, window=cfg.window)
        x = x + _attn_out(layer, attn.reshape(b, 1, -1))
        x = x + _mlp(layer, x, cfg)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps, cfg.norm_plus_one)
    return _logits(params, x[:, 0]), k_pages, v_pages


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

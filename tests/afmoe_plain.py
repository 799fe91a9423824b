"""A plain float32 AFMoE forward pass: the oracle of
``tests/test_torch_afmoe.py``. It imports neither JAX nor anything of
``infinistore_tpu_torch``: one sequence, one layer at a time, no cache,
no kernel, each routed token's experts in a Python loop.

It reads a parameter dict with the port's leaf names and [in, out]
layout, and ``spec``, a plain dict of the sizes (:func:`spec_of` builds
one from any object carrying the port's config fields). The equations
are those of ``models/afmoe.py``'s docstring.
"""

import torch
import torch.nn.functional as F

ROUTE_NORM_EPS = 1e-20


def spec_of(cfg):
    """The sizes :func:`forward` reads, from a config's attributes."""
    return {
        "n_heads": cfg.n_heads, "n_kv": cfg.n_kv_heads, "hd": cfg.head_dim,
        "eps": cfg.norm_eps, "theta": cfg.rope_theta,
        "windows": list(cfg.layer_windows), "rope": list(cfg.layer_rope),
        "top_k": cfg.top_k, "route_scale": cfg.route_scale,
        "route_norm": cfg.route_norm, "embed_scale": cfg.embed_scale,
    }


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """Rotate-half RoPE of x [s, heads, hd]."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = positions.double()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window):
    """Causal GQA attention; query i sees keys j with i - window < j <= i
    (every j <= i at window 0)."""
    s, heads, hd = q.shape
    group = heads // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    mask = j > i
    if window:
        mask |= j <= i - window
    scores = scores.masked_fill(mask[None], float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)


def swiglu(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate.float()) * (h @ w_up.float())) @ w_down.float()


def routed(layer, u, spec):
    """The shared expert plus each token's top-k experts by sigmoid
    score + bias, weighted by the scores alone."""
    scores = torch.sigmoid(
        (u.double() @ layer["router"].double()).float())
    chosen = torch.topk(scores + layer["expert_bias"].float(),
                        spec["top_k"], dim=-1).indices
    weight = scores.gather(1, chosen)
    if spec["route_norm"]:
        weight = weight / (weight.sum(-1, keepdim=True) + ROUTE_NORM_EPS)
    weight = weight * spec["route_scale"]
    out = torch.zeros_like(u)
    if "s_gate" in layer:
        out = out + swiglu(u, layer["s_gate"], layer["s_up"],
                           layer["s_down"])
    for t in range(u.shape[0]):
        for j in range(chosen.shape[1]):
            e = int(chosen[t, j])
            out[t] += weight[t, j] * swiglu(
                u[t:t + 1], layer["e_gate"][e], layer["e_up"][e],
                layer["e_down"][e])[0]
    return out


@torch.no_grad()
def forward(params, spec, tokens):
    """Logits [len(tokens), vocab] float32 of one sequence."""
    ids = torch.as_tensor(tokens, dtype=torch.long)
    s, hd, eps = len(ids), spec["hd"], spec["eps"]
    pos = torch.arange(s)
    x = params["embed"].float()[ids] * spec["embed_scale"]
    for li, layer in enumerate(params["layers"]):
        w = {name: t.float() for name, t in layer.items()}
        h = rms_norm(x, w["ln1"], eps)
        q = rms_norm((h @ w["wq"]).view(s, spec["n_heads"], hd),
                     w["q_norm"], eps)
        k = rms_norm((h @ w["wk"]).view(s, spec["n_kv"], hd),
                     w["k_norm"], eps)
        v = (h @ w["wv"]).view(s, spec["n_kv"], hd)
        if spec["rope"][li]:
            q, k = rope(q, pos, spec["theta"]), rope(k, pos, spec["theta"])
        a = attention(q, k, v, spec["windows"][li]).reshape(s, -1)
        a = a * torch.sigmoid(h @ w["wg"])
        x = x + rms_norm(a @ w["wo"], w["ln_post_attn"], eps)
        u = rms_norm(x, w["ln2"], eps)
        if "router" in layer:
            f = routed(layer, u, spec)
        else:
            f = swiglu(u, w["w_gate"], w["w_up"], w["w_down"])
        x = x + rms_norm(f, w["ln_post_mlp"], eps)
    x = rms_norm(x, params["final_ln"].float(), eps)
    return x @ params["lm_head"].float()

"""The plain reference of the ``llama`` and ``moe`` families
(``families/``): their forward pass, written from the published model
descriptions (Hugging Face ``MistralForCausalLM`` and
``MixtralForCausalLM``), in float32 with TF32 off, one sequence at a
time and one layer at a time, with no kernel, no cache and no batching.
It imports nothing of the program.

It reads the weights the benchmark drew (``harness.model.draw``:
the same leaf names and [in, out] layout) and widens each layer's
matrices to float32 as it reaches them, so it fits beside them.

``quant="int8"`` is the control: every matrix rounded to int8 with a
scale per output column (per row for the embedding, by absolute maximum,
as weight-only int8 serving does) before it is widened; the router
stays float32.

``routes`` makes a routed layer (those of ``g["routed"]``) follow given
choices: the experts a served sequence's tokens were sent to ([routed
layers, tokens, top_k], row i for layer ``g["routed"][i]``), with
the gates still this reference's router probabilities, renormalised.
Which experts a token goes to is a discrete decision that rounding can
flip where two experts nearly tie, and a flip sends every later layer
down another path; so the reference follows the program's choices, and
reads how far each token's choices lie below its own k-th best router
logit (its routing margin, 0 where they agree) to check the decisions
themselves.
"""

import torch
import torch.nn.functional as F

ROWS = 512  # query rows per attention block


def _plain_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def widen(w, quant=None, axis=-2):
    """A weight in float32; with ``quant="int8"`` rounded first to int8
    with one scale per slice along ``axis`` (the input axis: a scale per
    output column)."""
    w = w.float()
    if quant is None:
        return w
    if quant != "int8":
        raise ValueError(f"unknown quantization {quant!r}")
    scale = w.abs().amax(dim=axis, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(w / scale).clamp_(-127, 127) * scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """Rotary embedding of x [s, heads, hd] (rotate-half form)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = positions.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window):
    """Causal (sliding-window) attention of q [s, H, hd] over k, v
    [s, KV, hd]: query i sees keys j with i - window < j <= i."""
    s, heads, hd = q.shape
    group = heads // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    keys = torch.arange(s, device=q.device)
    for lo in range(0, s, ROWS):
        qi = torch.arange(lo, min(s, lo + ROWS), device=q.device)
        scores = torch.einsum("qhd,khd->hqk", q[qi], k) * hd ** -0.5
        mask = keys[None, :] > qi[:, None]
        if window:
            mask |= keys[None, :] <= qi[:, None] - window
        scores.masked_fill_(mask[None], float("-inf"))
        out[qi] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return out


def dense_ffn(layer, h, quant):
    gate = h @ widen(layer["w_gate"], quant)
    up = h @ widen(layer["w_up"], quant)
    return (F.silu(gate) * up) @ widen(layer["w_down"], quant)


def moe_ffn(layer, h, top_k, quant, choice=None):
    """Top-k of the router's softmax (or the experts in ``choice``
    [tokens, top_k]), the chosen gates renormalised, each token the
    gated sum of its experts' SwiGLU outputs. Returns (output, each
    token's routing margin: zeros without ``choice``)."""
    logits = (h.double() @ layer["router"].double()).float()
    probs = torch.softmax(logits, dim=-1)
    if choice is None:
        gates, experts = torch.topk(probs, top_k, dim=-1)
        margin = torch.zeros(h.shape[0], device=h.device)
    else:
        experts = choice.to(device=h.device, dtype=torch.long)
        gates = probs.gather(1, experts)
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1]
        worst = logits.gather(1, experts).min(dim=-1).values
        margin = (kth - worst).clamp(min=0)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(probs.shape[-1]):
        rows, slot = torch.nonzero(experts == e, as_tuple=True)
        if len(rows) == 0:
            continue
        x = h[rows]
        y = (F.silu(x @ widen(layer["e_gate"][e], quant))
             * (x @ widen(layer["e_up"][e], quant))) @ widen(
                 layer["e_down"][e], quant)
        out.index_add_(0, rows, y * gates[rows, slot][:, None])
    return out, margin


@torch.no_grad()
def logits(weights, g, tokens, positions, quant=None, routes=None):
    """(logits [len(positions), vocab] float32, the routing margins of
    every token at every routed layer, [routed layers, tokens]) of one
    sequence ``tokens`` (a list of ids, position 0 first) at
    ``positions``. ``g`` is the configuration's sizes
    (``harness.model.geometry``)."""
    _plain_matmuls()
    dev = weights["embed"].device
    ids = torch.as_tensor(tokens, device=dev)
    x = widen(weights["embed"], quant, axis=-1)[ids]
    pos = torch.arange(len(tokens), device=dev)
    s, hd, eps = len(tokens), g["hd"], g["eps"]
    routed = {li: i for i, li in enumerate(g["routed"])}
    margins = []
    for li, layer in enumerate(weights["layers"]):
        h = rms_norm(x, layer["ln1"].float(), eps)
        q = (h @ widen(layer["wq"], quant)).view(s, g["n_heads"], hd)
        k = (h @ widen(layer["wk"], quant)).view(s, g["n_kv"], hd)
        v = (h @ widen(layer["wv"], quant)).view(s, g["n_kv"], hd)
        q, k = rope(q, pos, g["theta"]), rope(k, pos, g["theta"])
        a = attention(q, k, v, g["window"]).reshape(s, -1)
        x = x + a @ widen(layer["wo"], quant)
        h = rms_norm(x, layer["ln2"].float(), eps)
        if li in routed:
            out, m = moe_ffn(layer, h, g["top_k"], quant, None
                             if routes is None else routes[routed[li], :s])
            margins.append(m)
            x = x + out
        else:
            x = x + dense_ffn(layer, h, quant)
    rows = rms_norm(x[torch.as_tensor(positions, device=dev)],
                    weights["final_ln"].float(), eps)
    margins = (torch.stack(margins) if margins
               else torch.zeros((0, s), device=dev))
    return rows @ widen(weights["lm_head"], quant), margins.cpu()

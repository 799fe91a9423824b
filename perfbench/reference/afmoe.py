"""The plain reference of the ``afmoe`` family (``families/afmoe.py``):
an Arcee Trinity forward pass written from the public
``modeling_afmoe.py`` as recalled (the points the configuration's
``assumed`` lists were not checked against that file offline), in
float32 with TF32 off, one sequence and one layer at a time, with no
kernel, no cache and no batching. It imports nothing of the program,
and reuses ``reference/plain.py``'s norm, RoPE, attention, int8 widening
and SwiGLU.

Per layer: h = RMSNorm(x); q, k = per-head RMSNorm(h Wq), RMSNorm(h Wk);
RoPE on sliding layers only; causal GQA attention (window on sliding
layers); a * sigmoid(h Wg); x += RMSNorm(a Wo); u = RMSNorm(x); f = the
dense SwiGLU, or the shared expert plus the top-k experts of sigmoid(u
Wr) + expert_bias, weighted by the scores alone (divided by their sum
with ``route_norm``, times ``route_scale``); x += RMSNorm(f). The
embedding is scaled by ``embed_scale`` (sqrt(d) under muP).

``quant="int8"`` and ``routes`` as in ``reference/plain.py``: with
``routes`` a routed layer takes the program's experts, weighted by this
reference's scores, and reads each token's routing margin: its k-th best
biased score minus the lowest biased score among the experts it was
given (0 where they agree).
"""

import importlib.util
import os

import torch


def _sibling(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_reference_{name}_of_afmoe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_plain = _sibling("plain")
widen, rms_norm, rope, attention = (_plain.widen, _plain.rms_norm,
                                    _plain.rope, _plain.attention)

# Added to the chosen scores' sum before it divides them (route_norm).
ROUTE_NORM_EPS = 1e-20


def _swiglu(h, w_gate, w_up, w_down, quant):
    return (torch.nn.functional.silu(h @ widen(w_gate, quant))
            * (h @ widen(w_up, quant))) @ widen(w_down, quant)


def routed_ffn(layer, u, g, quant, choice=None):
    """(shared expert + the weighted top-k experts of u [s, d], each
    token's routing margin: zeros without ``choice``)."""
    scores = torch.sigmoid((u.double() @ layer["router"].double()).float())
    biased = scores + layer["expert_bias"].float()
    k = g["top_k"]
    if choice is None:
        experts = torch.topk(biased, k, dim=-1).indices
        margin = torch.zeros(u.shape[0], device=u.device)
    else:
        experts = choice.to(device=u.device, dtype=torch.long)
        kth = torch.topk(biased, k, dim=-1).values[:, -1]
        worst = biased.gather(1, experts).min(dim=-1).values
        margin = (kth - worst).clamp(min=0)
    weight = scores.gather(1, experts)
    if g["route_norm"]:
        weight = weight / (weight.sum(-1, keepdim=True) + ROUTE_NORM_EPS)
    weight = weight * g["route_scale"]
    out = torch.zeros_like(u)
    if "s_gate" in layer:
        out += _swiglu(u, layer["s_gate"], layer["s_up"], layer["s_down"],
                       quant)
    for e in range(layer["e_gate"].shape[0]):
        rows, slot = torch.nonzero(experts == e, as_tuple=True)
        if len(rows) == 0:
            continue
        y = _swiglu(u[rows], layer["e_gate"][e], layer["e_up"][e],
                    layer["e_down"][e], quant)
        out.index_add_(0, rows, y * weight[rows, slot][:, None])
    return out, margin


@torch.no_grad()
def logits(weights, g, tokens, positions, quant=None, routes=None):
    """(logits [len(positions), vocab] float32, the routing margins of
    every token at every routed layer, [routed layers, tokens]) of one
    sequence ``tokens`` at ``positions``; ``g`` is the configuration's
    sizes (``families/afmoe.py`` ``geometry``)."""
    _plain._plain_matmuls()
    dev = weights["embed"].device
    ids = torch.as_tensor(tokens, device=dev)
    x = widen(weights["embed"], quant, axis=-1)[ids] * g["embed_scale"]
    pos = torch.arange(len(tokens), device=dev)
    s, hd, eps = len(tokens), g["hd"], g["eps"]
    routed = {li: i for i, li in enumerate(g["routed"])}
    margins = []
    for li, layer in enumerate(weights["layers"]):
        window = g["windows"][li]
        h = rms_norm(x, layer["ln1"].float(), eps)
        q = rms_norm((h @ widen(layer["wq"], quant)).view(s, g["n_heads"],
                                                         hd),
                     layer["q_norm"].float(), eps)
        k = rms_norm((h @ widen(layer["wk"], quant)).view(s, g["n_kv"], hd),
                     layer["k_norm"].float(), eps)
        v = (h @ widen(layer["wv"], quant)).view(s, g["n_kv"], hd)
        if window:  # sliding layers rotate; full layers take no RoPE
            q, k = rope(q, pos, g["theta"]), rope(k, pos, g["theta"])
        a = attention(q, k, v, window).reshape(s, -1)
        a = a * torch.sigmoid(h @ widen(layer["wg"], quant))
        x = x + rms_norm(a @ widen(layer["wo"], quant),
                         layer["ln_post_attn"].float(), eps)
        u = rms_norm(x, layer["ln2"].float(), eps)
        if li in routed:
            f, m = routed_ffn(layer, u, g, quant, None if routes is None
                              else routes[routed[li], :s])
            margins.append(m)
        else:
            f = _swiglu(u, layer["w_gate"], layer["w_up"], layer["w_down"],
                        quant)
        x = x + rms_norm(f, layer["ln_post_mlp"].float(), eps)
    rows = rms_norm(x[torch.as_tensor(positions, device=dev)],
                    weights["final_ln"].float(), eps)
    margins = (torch.stack(margins) if margins
               else torch.zeros((0, s), device=dev))
    return rows @ widen(weights["lm_head"], quant), margins.cpu()

"""The AFMoE family: ``infinistore_tpu_torch.models.afmoe`` as an
Arcee Trinity ``config.json`` (``model_type`` ``afmoe``) gives it:
``layer_types`` of sliding (RoPE) and full (no positional encoding)
layers, each with q/k norms, a sigmoid output gate and sandwich norms;
``num_dense_layers`` dense SwiGLU layers, then layers of
``num_experts`` experts with a sigmoid top-k router, an expert bias that
only selects, and shared experts. Judged by ``reference/afmoe.py``
following the program's routing. What the contract of a family file is:
``harness/model.py``."""

import os

import torch

from harness import catalog, model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_reference = catalog.reference("afmoe", ROOT)

# Keys read besides ``model.COMMON`` (``load_balance_coeff`` acts only in
# training, ``use_grouped_mm`` names the modeling code's expert kernel),
# and keys run at one value only: one expert group, unscaled RoPE,
# SwiGLU, sigmoid scores, the head drawn apart from the embedding.
READS = ("sliding_window", "layer_types", "global_attn_every_n_layers",
         "num_dense_layers", "moe_intermediate_size", "num_experts",
         "num_experts_per_tok", "num_shared_experts", "route_scale",
         "route_norm", "mup_enabled", "load_balance_coeff",
         "use_grouped_mm")
FIXED = {"n_group": 1, "num_expert_groups": 1, "num_limited_groups": 1,
         "topk_group": 1, "rope_scaling": None, "hidden_act": "silu",
         "tie_word_embeddings": False, "score_func": "sigmoid"}
# The expert bias's draw: normal, this std, from its own stream of the
# seed (model.draw's generator draws the matrices and routers).
BIAS_STD = 0.1
BIAS_STREAM = 0xB1A5

# The program's routing function, wrapped to record every choice.
route_attr = "_route"


def _layer_types(conf):
    """Each layer's kind: ``layer_types``, which has to agree with
    ``global_attn_every_n_layers`` (every n-th layer full)."""
    n, every = conf["num_hidden_layers"], conf["global_attn_every_n_layers"]
    derived = ["full_attention" if (i + 1) % every == 0
               else "sliding_attention" for i in range(n)]
    types = conf.get("layer_types") or derived
    if list(types) != derived:
        raise ValueError("layer_types disagree with "
                         f"global_attn_every_n_layers={every}")
    return types


def _token_flops(g, routed):
    """Operations of one token through one layer's weights: q, k, v, the
    output gate and o; then the dense SwiGLU, or the router, the shared
    expert and ``top_k`` experts."""
    d, q, kv = g["d"], g["n_heads"] * g["hd"], g["n_kv"] * g["hd"]
    attn = 2 * d * q + 2 * d * kv + q * d
    if routed:
        ffn = (d * g["experts"] + 3 * d * g["ff_expert"] * g["shared"]
               + g["top_k"] * 3 * d * g["ff_expert"])
    else:
        ffn = 3 * d * g["ff"]
    return 2.0 * (attn + ffn)


def geometry(conf):
    model.check_keys(conf, READS, FIXED)
    types = _layer_types(conf)
    window = conf["sliding_window"]
    n_dense = conf["num_dense_layers"]
    g = {**model.common(conf), "window": 0,
         "windows": [window if t == "sliding_attention" else 0
                     for t in types],
         "experts": conf["num_experts"],
         "top_k": conf["num_experts_per_tok"],
         "ff_expert": conf["moe_intermediate_size"],
         "shared": conf["num_shared_experts"],
         "route_scale": float(conf["route_scale"]),
         "route_norm": bool(conf["route_norm"]),
         "embed_scale": (float(conf["hidden_size"]) ** 0.5
                         if conf["mup_enabled"] else 1.0),
         "routed": list(range(n_dense, conf["num_hidden_layers"]))}
    plan = []
    for li, w in enumerate(g["windows"]):
        routed = li >= n_dense
        if plan and plan[-1]["window"] == w and plan[-1]["_routed"] == routed:
            plan[-1]["count"] += 1
            continue
        plan.append({"count": 1, "window": w, "n_heads": g["n_heads"],
                     "n_kv": g["n_kv"], "hd": g["hd"],
                     "token_flops": _token_flops(g, routed),
                     "_routed": routed})
    g["plan"] = [{k: v for k, v in grp.items() if k != "_routed"}
                 for grp in plan]
    return g


def program_config(conf):
    from infinistore_tpu_torch.models import afmoe

    g = geometry(conf)
    sizes = model.program_sizes(g, conf)
    del sizes["window"]  # the config derives it from layer_windows
    windows, rope_on = afmoe.layer_pattern(_layer_types(conf),
                                           conf["sliding_window"])
    return afmoe, afmoe.AfmoeConfig(
        d_expert=g["ff_expert"], n_experts=g["experts"], top_k=g["top_k"],
        n_shared=g["shared"], n_dense_layers=g["layers"] - len(g["routed"]),
        route_scale=g["route_scale"], route_norm=g["route_norm"],
        layer_windows=windows, layer_rope=rope_on,
        embed_scale=g["embed_scale"], **sizes)


def layer_shapes(g, li):
    """The matrices of layer ``li``, {leaf: shape} in draw order."""
    d, q, kv = g["d"], g["n_heads"] * g["hd"], g["n_kv"] * g["hd"]
    shapes = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wg": (d, q),
              "wo": (q, d)}
    if li in g["routed"]:
        e, fe, fs = g["experts"], g["ff_expert"], g["ff_expert"] * g["shared"]
        shapes.update(e_gate=(e, d, fe), e_up=(e, d, fe), e_down=(e, fe, d))
        if fs:
            shapes.update(s_gate=(d, fs), s_up=(d, fs), s_down=(fs, d))
    else:
        ff = g["ff"]
        shapes.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
    return shapes


def make_weights(g, seed, device):
    """``model.draw``'s matrices, routers, ln1 (input) and ln2 (pre-MLP)
    norms; then the q/k norms ([hd]) and the post-attention and post-MLP
    norms at one, and each routed layer's expert bias, normal with std
    ``BIAS_STD`` from a generator of its own on the seed."""
    tree = model.draw(g, seed, device,
                      [layer_shapes(g, li) for li in range(g["layers"])])
    dt = getattr(torch, g["dtype"])
    n = len(tree["layers"])
    heads = torch.ones((2 * n, g["hd"]), dtype=dt, device=device)
    posts = torch.ones((2 * n, g["d"]), dtype=dt, device=device)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) + BIAS_STREAM) % (1 << 63))
    biases = torch.empty((len(g["routed"]), g["experts"]),
                         dtype=torch.float32, device=device)
    biases.normal_(0.0, BIAS_STD, generator=gen)
    routed = {li: i for i, li in enumerate(g["routed"])}
    for li, layer in enumerate(tree["layers"]):
        layer["q_norm"], layer["k_norm"] = heads[2 * li], heads[2 * li + 1]
        layer["ln_post_attn"] = posts[2 * li]
        layer["ln_post_mlp"] = posts[2 * li + 1]
        if li in routed:
            layer["expert_bias"] = biases[routed[li]]
    return tree


logits = _reference.logits

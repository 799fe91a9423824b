"""The routed family: ``infinistore_tpu_torch.models.moe`` as a
Mixtral-style ``config.json`` gives it, every layer alike (one window,
``num_local_experts`` SwiGLU experts, softmax top-k, no shared expert),
judged by ``reference/plain.py`` following the program's routing. What
the contract of a family file is: ``harness/model.py``."""

import os

from harness import catalog, model, work

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_reference = catalog.reference("plain", ROOT)

# Keys read besides ``model.COMMON``; keys of training only; keys run at
# one value only (SwiGLU experts; the head drawn apart from the
# embedding).
READS = ("sliding_window", "layer_types", "num_local_experts",
         "num_experts_per_tok", "output_router_logits",
         "router_aux_loss_coef")
FIXED = {"hidden_act": "silu", "tie_word_embeddings": False}

# The program's routing function, wrapped to record every choice.
route_attr = "_route"


def geometry(conf):
    model.check_keys(conf, READS, FIXED)
    g = {**model.common(conf), "window": model.one_window(conf),
         "experts": conf["num_local_experts"],
         "top_k": conf["num_experts_per_tok"],
         "routed": list(range(conf["num_hidden_layers"]))}
    g["plan"] = work.uniform_plan(g)
    return g


def program_config(conf):
    from infinistore_tpu_torch.models import moe

    g = geometry(conf)
    return moe, moe.MoEConfig(
        n_experts=g["experts"], top_k=g["top_k"],
        capacity_factor=conf["assumed"]["capacity_factor"],
        **model.program_sizes(g, conf))


def make_weights(g, seed, device):
    d, q, kv, ff, e = (g["d"], g["n_heads"] * g["hd"],
                       g["n_kv"] * g["hd"], g["ff"], g["experts"])
    layer = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
             "e_gate": (e, d, ff), "e_up": (e, d, ff), "e_down": (e, ff, d)}
    return model.draw(g, seed, device, [layer] * g["layers"])


logits = _reference.logits

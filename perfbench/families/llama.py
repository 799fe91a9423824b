"""The dense family: ``infinistore_tpu_torch.models.llama`` as a
Mistral- or Llama-style ``config.json`` gives it, every layer alike (one
window, a SwiGLU MLP), judged by ``reference/plain.py``. What the
contract of a family file is: ``harness/model.py``."""

import os

from harness import catalog, model, work

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_reference = catalog.reference("plain", ROOT)

# Keys read besides ``model.COMMON``, and keys run at one value only
# (the reference's MLP is SwiGLU; the head is drawn apart from the
# embedding).
READS = ("sliding_window", "layer_types")
FIXED = {"hidden_act": "silu", "tie_word_embeddings": False}

route_attr = None


def geometry(conf):
    model.check_keys(conf, READS, FIXED)
    g = {**model.common(conf), "window": model.one_window(conf),
         "experts": 0, "top_k": 0, "routed": []}
    g["plan"] = work.uniform_plan(g)
    return g


def program_config(conf):
    from infinistore_tpu_torch.models import llama

    g = geometry(conf)
    return llama, llama.LlamaConfig(act=conf["hidden_act"],
                                    **model.program_sizes(g, conf))


def make_weights(g, seed, device):
    d, q, kv, ff = (g["d"], g["n_heads"] * g["hd"], g["n_kv"] * g["hd"],
                    g["ff"])
    layer = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
             "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    return model.draw(g, seed, device, [layer] * g["layers"])


logits = _reference.logits

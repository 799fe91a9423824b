"""The configuration as the program runs it, its weights, and the
benchmark's counter around the model's calls.

A configuration file (``configs/<name>.json``) holds the published
``config.json`` keys, with ``family`` naming the program's model module
(``llama`` or ``moe``) and ``assumed`` the sizes the source does not
give (page size, the MoE capacity factor).
"""

import time

import torch
from torch.profiler import record_function


def geometry(conf):
    """The sizes the yardstick needs, from a configuration file."""
    moe = conf["family"] == "moe"
    return {
        "vocab": conf["vocab_size"], "d": conf["hidden_size"],
        "layers": conf["num_hidden_layers"],
        "n_heads": conf["num_attention_heads"],
        "n_kv": conf["num_key_value_heads"],
        "hd": conf.get("head_dim") or (conf["hidden_size"]
                                       // conf["num_attention_heads"]),
        "ff": conf["intermediate_size"],
        "window": conf.get("sliding_window") or 0,
        "experts": conf["num_local_experts"] if moe else 0,
        "top_k": conf["num_experts_per_tok"] if moe else 0,
        "eps": conf["rms_norm_eps"], "theta": float(conf["rope_theta"]),
        "page": conf["assumed"]["page_size"],
        "dtype": conf["torch_dtype"],
    }


def program_config(conf):
    """(the program's model module, its config) for a configuration."""
    from infinistore_tpu_torch.models import llama, moe

    g = geometry(conf)
    common = dict(
        vocab_size=g["vocab"], d_model=g["d"], n_layers=g["layers"],
        n_heads=g["n_heads"], n_kv_heads=g["n_kv"], d_ff=g["ff"],
        max_seq=conf["max_position_embeddings"], page_size=g["page"],
        rope_theta=g["theta"], window=g["window"], norm_eps=g["eps"],
        dtype=g["dtype"],
        head_dim_override=0 if g["hd"] == g["d"] // g["n_heads"] else g["hd"])
    if g["experts"]:
        return moe, moe.MoEConfig(
            n_experts=g["experts"], top_k=g["top_k"],
            capacity_factor=conf["assumed"]["capacity_factor"], **common)
    return llama, llama.LlamaConfig(act=conf["hidden_act"], **common)


def _shapes(g):
    """Each layer's matrices in draw order, and the router's shape."""
    d, q, kv, ff, e = (g["d"], g["n_heads"] * g["hd"],
                       g["n_kv"] * g["hd"], g["ff"], g["experts"])
    layer = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)}
    if e:
        layer.update(e_gate=(e, d, ff), e_up=(e, d, ff), e_down=(e, ff, d))
    else:
        layer.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
    return layer


CHUNK = 1 << 30  # elements per generator call


def make_weights(g, seed, device):
    """The tree the program serves, drawn on ``device`` from ``seed`` in
    a few large calls: every matrix a view of one buffer in the served
    dtype, normal with std d**-0.5; a MoE router float32 (one buffer);
    norms at one."""
    dt = getattr(torch, g["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    std = g["d"] ** -0.5
    shapes = _shapes(g)
    per_layer = sum(int(torch.Size(s).numel()) for s in shapes.values())
    total = 2 * g["vocab"] * g["d"] + g["layers"] * per_layer
    buf = torch.empty(total, dtype=dt, device=device)
    for lo in range(0, total, CHUNK):
        buf[lo:lo + CHUNK].normal_(0.0, std, generator=gen)
    at = 0

    def take(shape):
        nonlocal at
        n = int(torch.Size(shape).numel())
        view = buf[at:at + n].view(shape)
        at += n
        return view

    ones = torch.ones((2 * g["layers"] + 1, g["d"]), dtype=dt,
                      device=device)
    routers = None
    if g["experts"]:
        routers = torch.empty((g["layers"], g["d"], g["experts"]),
                              dtype=torch.float32, device=device)
        routers.normal_(0.0, std, generator=gen)
    embed = take((g["vocab"], g["d"]))
    lm_head = take((g["d"], g["vocab"]))
    layers = []
    for li in range(g["layers"]):
        layer = {name: take(shape) for name, shape in shapes.items()}
        layer["ln1"], layer["ln2"] = ones[2 * li], ones[2 * li + 1]
        if routers is not None:
            layer["router"] = routers[li]
        layers.append(layer)
    return {"embed": embed, "layers": layers, "final_ln": ones[-1],
            "lm_head": lm_head}


class ModelSpy:
    """The model module as the engine calls it, with each prefill and
    decode step recorded: (host time, "prefill", new tokens, cached
    tokens attended) or (host time, "decode", the live rows' attended
    lengths). The engine is attached after it is built, for the live
    rows' lengths (host state: no device read).

    With ``routing`` (a routed family), the module's ``_route`` is
    wrapped for the spy's life (``close`` puts it back) so that the
    experts chosen for every token of every call are kept, by request
    and position, for the reference to follow (``routes``)."""

    def __init__(self, module, routing=False):
        self._m = module
        self.calls = []
        self.engine = None
        self.entries = []  # (rows, per-layer [tokens, top_k] experts)
        self._current = None
        self._route = None
        if routing:
            self._route = module._route

            def route(*args, **kw):
                r = self._route(*args, **kw)
                if self._current is not None:
                    self._current[1].append(r.expert)
                return r

            module._route = route

    def close(self):
        if self._route is not None:
            self._m._route = self._route
            self._route = None

    def _begin(self, rows):
        if self._route is not None:
            self._current = (rows, [])
            self.entries.append(self._current)

    def prefill(self, params, cfg, tokens, **kw):
        n = int(tokens.shape[1])
        self.calls.append((time.perf_counter(), "prefill", n, 0))
        # The engine admits the head of its queue.
        self._begin(("prefill", self.engine.queue[0].req.request_id, 0, n))
        with record_function("model.prefill"):
            out = self._m.prefill(params, cfg, tokens, **kw)
        self._current = None
        return out

    def prefill_with_prefix(self, params, cfg, tokens, prefix_kvs, **kw):
        n, cached = int(tokens.shape[1]), int(prefix_kvs[0][0].shape[1])
        self.calls.append((time.perf_counter(), "prefill", n, cached))
        self._begin(("prefill", self.engine.queue[0].req.request_id,
                     kw.get("pos0", 0) + cached, n))
        with record_function("model.prefill"):
            out = self._m.prefill_with_prefix(params, cfg, tokens,
                                              prefix_kvs, **kw)
        self._current = None
        return out

    def decode_step(self, params, cfg, *args, **kw):
        live = [(i, s) for i, s in enumerate(self.engine.slots)
                if s is not None]
        self.calls.append((time.perf_counter(), "decode",
                           [s.seq_len + 1 for _, s in live]))
        self._begin(("decode", [(i, s.work.req.request_id, s.seq_len)
                                for i, s in live]))
        with record_function("model.decode"):
            out = self._m.decode_step(params, cfg, *args, **kw)
        self._current = None
        return out

    def routes(self, rid, length):
        """[layers, length, top_k] experts the program chose for
        positions 0..length-1 of request ``rid``, or None where a
        position went unrecorded (its pages came from the store)."""
        table = None
        for rows, experts in self.entries:
            if rows[0] == "prefill":
                if rows[1] != rid:
                    continue
                picks = [(p, i) for i, p in
                         enumerate(range(rows[2], rows[2] + rows[3]))]
            else:
                picks = [(p, i) for i, r, p in rows[1] if r == rid]
            picks = [(p, i) for p, i in picks if p < length]
            if not picks:
                continue
            stacked = torch.stack(experts)  # [layers, tokens, top_k]
            if table is None:
                table = torch.full((stacked.shape[0], length,
                                    stacked.shape[2]), -1, dtype=torch.long)
            pos = torch.tensor([p for p, _ in picks])
            idx = torch.tensor([i for _, i in picks],
                               device=stacked.device)
            table[:, pos] = stacked[:, idx].cpu()
        if table is None or bool((table < 0).any()):
            return None
        return table

    def __getattr__(self, name):
        return getattr(self._m, name)

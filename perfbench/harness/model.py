"""The configuration as the program runs it, its weights, and the
benchmark's counter around the model's calls.

A configuration file (``configs/<name>.json``) holds the published
``config.json`` keys, with ``family`` naming its model family and
``assumed`` the sizes the source does not give (the page size, and what
its family needs besides). The family is a file of its own,
``families/<family>.py`` (``catalog.family``), which defines:

- ``geometry(conf)``: the sizes the yardstick and the reference need
  (:func:`common`'s keys and ``window``, ``experts``, ``top_k``), with
  ``plan``, the layers in groups in layer order (each group's ``count``,
  ``window``, ``n_heads``, ``n_kv``, ``hd`` and ``token_flops``, the
  operations of one token through one of its layers' weights:
  ``harness.work``), and ``routed``, the indices of the layers whose
  routing is recorded. It raises on a key that changes the model and
  that the family does not run (:func:`check_keys`);
- ``program_config(conf)``: (the program's model module, its config);
- ``make_weights(g, seed, device)``: the tree the program serves;
- ``logits(weights, g, tokens, positions, quant=None, routes=None)``:
  its plain reference (``reference/<name>.py``, ``catalog.reference``);
- ``route_attr``: the program module's routing function that
  :class:`ModelSpy` wraps, or None.

The functions below of those names find the family by the file's
``family`` key (and a geometry's).
"""

import time

import torch
from torch.profiler import record_function

from . import catalog

# Keys of a configuration file that do not change the model as served:
# the benchmark's own, the published file's names and token ids, and
# settings that act only in training.
INERT = frozenset({
    "source", "family", "reduced", "published", "assumed", "deployment",
    "architectures", "model_type", "bos_token_id", "eos_token_id",
    "initializer_range", "use_cache", "attention_dropout"})

# The config.json keys :func:`common` and :func:`program_sizes` read.
COMMON = frozenset({
    "vocab_size", "hidden_size", "num_hidden_layers",
    "num_attention_heads", "num_key_value_heads", "head_dim",
    "intermediate_size", "rms_norm_eps", "rope_theta", "torch_dtype",
    "max_position_embeddings"})


def check_keys(conf, reads, fixed):
    """Raise ValueError on a key of ``conf`` that is neither inert, nor
    read by the family (``reads``), nor at the one value the family runs
    (``fixed``: key -> value)."""
    unknown = sorted(set(conf) - INERT - COMMON - set(reads) - set(fixed))
    if unknown:
        raise ValueError(f"family {conf['family']!r} does not run "
                         f"{', '.join(unknown)}")
    for key, value in fixed.items():
        if key in conf and conf[key] != value:
            raise ValueError(f"family {conf['family']!r} runs only "
                             f"{key}={value!r}, not {conf[key]!r}")


def one_window(conf):
    """The window every layer shares, ``sliding_window`` (0: none).
    ``layer_types``, where given, has to name the one kind of layer that
    this window makes."""
    window = conf.get("sliding_window") or 0
    kinds = set(conf.get("layer_types") or ())
    if kinds and kinds != {"sliding_attention" if window
                           else "full_attention"}:
        raise ValueError(
            f"family {conf['family']!r} runs one window on every layer, "
            f"not layer_types {sorted(kinds)} with sliding_window {window}")
    return window


def common(conf):
    """The sizes every family reads from a configuration file."""
    return {
        "vocab": conf["vocab_size"], "d": conf["hidden_size"],
        "layers": conf["num_hidden_layers"],
        "n_heads": conf["num_attention_heads"],
        "n_kv": conf["num_key_value_heads"],
        "hd": conf.get("head_dim") or (conf["hidden_size"]
                                       // conf["num_attention_heads"]),
        "ff": conf["intermediate_size"],
        "eps": conf["rms_norm_eps"], "theta": float(conf["rope_theta"]),
        "page": conf["assumed"]["page_size"],
        "dtype": conf["torch_dtype"],
    }


def program_sizes(g, conf):
    """The fields every program config takes, from geometry ``g``."""
    return dict(
        vocab_size=g["vocab"], d_model=g["d"], n_layers=g["layers"],
        n_heads=g["n_heads"], n_kv_heads=g["n_kv"], d_ff=g["ff"],
        max_seq=conf["max_position_embeddings"], page_size=g["page"],
        rope_theta=g["theta"], window=g["window"], norm_eps=g["eps"],
        dtype=g["dtype"],
        head_dim_override=0 if g["hd"] == g["d"] // g["n_heads"] else g["hd"])


def family(g):
    """The family module of geometry ``g``."""
    return catalog.family(g["family"], g["root"])


def geometry(conf, root=catalog.ROOT):
    """The sizes the yardstick needs, from a configuration file (its
    family's ``geometry``, with the family's name and root)."""
    return {**catalog.family(conf["family"], root).geometry(conf),
            "family": conf["family"], "root": root}


def program_config(conf, root=catalog.ROOT):
    """(the program's model module, its config) for a configuration."""
    return catalog.family(conf["family"], root).program_config(conf)


def make_weights(g, seed, device):
    """The tree the program serves, drawn by ``g``'s family."""
    return family(g).make_weights(g, seed, device)


CHUNK = 1 << 30  # elements per generator call


def draw(g, seed, device, layers):
    """The tree the program serves, drawn on ``device`` from ``seed`` in
    a few large calls: every matrix (the embedding, the output head,
    then each layer's ``layers[i]``, {leaf: shape} in draw order) a view
    of one buffer in the served dtype, normal with std d**-0.5; then a
    float32 router [d, experts] for each layer in ``g["routed"]`` (one
    buffer); norms at one."""
    dt = getattr(torch, g["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    std = g["d"] ** -0.5
    total = 2 * g["vocab"] * g["d"] + sum(
        int(torch.Size(s).numel()) for shapes in layers
        for s in shapes.values())
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

    ones = torch.ones((2 * len(layers) + 1, g["d"]), dtype=dt,
                      device=device)
    routed = {li: i for i, li in enumerate(g["routed"])}
    routers = None
    if routed:
        routers = torch.empty((len(routed), g["d"], g["experts"]),
                              dtype=torch.float32, device=device)
        routers.normal_(0.0, std, generator=gen)
    embed = take((g["vocab"], g["d"]))
    lm_head = take((g["d"], g["vocab"]))
    tree = []
    for li, shapes in enumerate(layers):
        layer = {name: take(shape) for name, shape in shapes.items()}
        layer["ln1"], layer["ln2"] = ones[2 * li], ones[2 * li + 1]
        if li in routed:
            layer["router"] = routers[routed[li]]
        tree.append(layer)
    return {"embed": embed, "layers": tree, "final_ln": ones[-1],
            "lm_head": lm_head}


class ModelSpy:
    """The model module as the engine calls it, with each prefill and
    decode step recorded: (host time, "prefill", new tokens, cached
    tokens attended) or (host time, "decode", the live rows' attended
    lengths). The engine is attached after it is built, for the live
    rows' lengths (host state: no device read).

    With ``route_attr`` (a routed family's), that routing function of
    the module is wrapped for the spy's life (``close`` puts it back) so
    that the experts chosen for every token of every call at each of the
    ``routed`` layers are kept, by request and position, for the
    reference to follow (``routes``)."""

    def __init__(self, module, route_attr=None, routed=()):
        self._m = module
        self.calls = []
        self.engine = None
        self.entries = []  # (rows, per routed layer [tokens, top_k])
        self.routed = list(routed)
        self._current = None
        self._attr = route_attr
        self._route = None
        if route_attr is not None:
            self._route = getattr(module, route_attr)

            def route(*args, **kw):
                r = self._route(*args, **kw)
                if self._current is not None:
                    self._current[1].append(r.expert)
                return r

            setattr(module, route_attr, route)

    def close(self):
        if self._route is not None:
            setattr(self._m, self._attr, self._route)
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
        """[routed layers, length, top_k] experts the program chose for
        positions 0..length-1 of request ``rid`` (row i: layer
        ``routed[i]``), or None where a position went unrecorded (its
        pages came from the store)."""
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
            stacked = torch.stack(experts)  # [routed, tokens, top_k]
            if stacked.shape[0] != len(self.routed):
                raise RuntimeError(
                    f"{stacked.shape[0]} routing calls in one model call "
                    f"of {len(self.routed)} routed layers")
            if table is None:
                table = torch.full((len(self.routed), length,
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

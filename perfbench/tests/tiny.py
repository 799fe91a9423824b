"""A tiny stand-in of the benchmark for the CPU tests: a copy of
``perfbench/``'s data files, readers, families and references in a
temporary directory, with a tiny dense and a tiny MoE configuration,
tiny mixes and two cells, and a ``BENCHMARK.json`` naming them (the
real one's metrics on the backlog cell, the chat metrics of ``SERVE`` on
the sessions cell)."""

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REPO = os.path.dirname(ROOT)
for path in (ROOT, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY = {
    "family": "llama", "hidden_act": "silu", "hidden_size": 128,
    "intermediate_size": 256, "max_position_embeddings": 512,
    "num_attention_heads": 2, "num_hidden_layers": 2,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "sliding_window": 160, "torch_dtype": "bfloat16", "vocab_size": 384,
    "source": "a tiny test configuration", "reduced": [],
    "assumed": {"page_size": 16},
}
# float32, so the reference routes every token as the program does and
# a sound run reads only float32 rounding.
TINY_MOE = {
    **TINY, "family": "moe", "num_local_experts": 4,
    "num_experts_per_tok": 2, "sliding_window": None,
    "torch_dtype": "float32",
    "assumed": {"page_size": 16, "capacity_factor": 2.0},
}
SESSIONS = {
    "kind": "sessions", "system_prompt_tokens": 64, "turns": [2, 4],
    "user_tokens": [4, 40], "output_tokens": [3, 12], "think_s_mean": 0.2,
    "context_cap": 256, "session_rate_per_s": 3.0, "sizes_seed": 5,
}
BACKLOG = {
    "kind": "backlog", "waiting": 4, "prompt_tokens": [16, 96],
    "output_tokens": [4, 24], "context_cap": 256, "sizes_seed": 6,
}
ENGINE = {"max_slots": 4, "max_pages_per_seq": 16, "total_pages": 65}
CELL = {"engine": ENGINE, "store": {"prealloc_gib": 0.0625},
        "check": {"limits": {"mean_gap": 0.02}}}
MOE_CELL = {**CELL, "check": {"limits": {"mean_gap": 0.02,
                                          "route_margin_mean": 0.05,
                                          "route_margin_layer": 0.005}}}
CELLS = {"tiny.sessions": ("tiny", "sessions", CELL),
         "tiny-moe.backlog": ("tiny-moe", "backlog", MOE_CELL)}
# The chat cell's metrics, which BENCHMARK.json does not list yet: their
# readers in ``metrics/`` stay tested on the tiny open loop.
SERVE = {"end_to_end": [("itl_p95_ms", "ms", "lower", "host_clock", None)],
         "per_layer": [
             ("engine.hit_share", "%", "higher", "program_counter", "engine"),
             ("store.restore_gbs", "GB/s", "higher", "program_span", "store"),
             ("store.offload_share.serve", "%", "lower", "program_span",
              "store"),
             ("model.mfu.serve", "%", "higher", "program_span",
              "model step"),
             ("device.idle_share.serve", "%", "lower", "device_trace",
              "device")]}


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(tmp):
    """A benchmark root under ``tmp``; returns (root, BENCHMARK dict)."""
    root = os.path.join(str(tmp), "perfbench")
    for folder in ("metrics", "families", "reference"):
        shutil.copytree(os.path.join(ROOT, folder),
                        os.path.join(root, folder))
    os.makedirs(os.path.join(root, "traffic"))
    for kind in ("sessions", "backlog"):
        shutil.copy(os.path.join(ROOT, "traffic", f"{kind}.py"),
                    os.path.join(root, "traffic"))
    _dump(os.path.join(root, "configs", "tiny.json"), TINY)
    _dump(os.path.join(root, "configs", "tiny-moe.json"), TINY_MOE)
    _dump(os.path.join(root, "traffic", "sessions.json"), SESSIONS)
    _dump(os.path.join(root, "traffic", "backlog.json"), BACKLOG)
    for name, (_, _, cell) in CELLS.items():
        _dump(os.path.join(root, "workloads", f"{name}.json"), cell)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        real = json.load(f)
    serve, batch = CELLS
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [batch]
    for kind, metrics in SERVE.items():
        for name, unit, better, source, layer in metrics:
            m = {"name": name, "unit": unit, "better": better,
                 "source": source, "workloads": [serve]}
            if layer is None:
                m["bound"] = 0.25
            else:
                m.update(layer=layer, moves="itl_p95_ms")
            real[kind].insert(0, m)
    real["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
        for n, (c, t, _) in CELLS.items()]
    _dump(os.path.join(str(tmp), "BENCHMARK.json"), real)
    return root, real

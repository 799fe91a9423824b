"""The AFMoE family (``families/afmoe.py``, ``reference/afmoe.py``) on
the CPU: its geometry refuses what it does not run, its plan is the
published stack's 17 layer groups and counts the drawn weights' work,
its draw served by the program agrees with its reference, and a tiny
AFMoE cell's check passes the sound program and flags a partial
misroute of the program's sigmoid router."""

import copy
import json
import os
import time

import pytest
import torch

import tiny
from harness import catalog, model, run_cell, work
from infinistore_tpu_torch.models import afmoe as pafmoe

CONF = catalog.config("trinity-mini")
FAM = catalog.family("afmoe")

# A tiny AFMoE: 1 dense then 4 routed layers, sliding / sliding /
# sliding / full / sliding (window 16 under contexts up to 120), 16
# experts of 32, top-4, one shared expert, float32 (4 KB pages).
TINY_AFMOE = {
    **{k: v for k, v in CONF.items() if k not in ("layer_types",)},
    "hidden_size": 128, "intermediate_size": 192,
    "max_position_embeddings": 512, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 32, "num_hidden_layers": 5,
    "num_dense_layers": 1, "moe_intermediate_size": 32, "num_experts": 16,
    "num_experts_per_tok": 4, "sliding_window": 16, "vocab_size": 384,
    "torch_dtype": "float32", "reduced": [],
    "assumed": {"page_size": 16}, "source": "a tiny test configuration"}
CELL = "tiny-afmoe.backlog"
LIMITS = {"mean_gap": 0.02, "route_margin_mean": 0.05,
          "route_margin_layer": 0.005}


@pytest.mark.parametrize("key,value", [
    ("unknown_key", 1), ("n_group", 2), ("num_expert_groups", 2),
    ("topk_group", 2), ("num_limited_groups", 2), ("score_func", "softmax"),
    ("rope_scaling", {"rope_type": "yarn", "factor": 4.0}),
    ("hidden_act", "gelu"), ("tie_word_embeddings", True)])
def test_geometry_refuses_what_the_family_does_not_run(key, value):
    with pytest.raises(ValueError, match=key):
        model.geometry(dict(CONF, **{key: value}))


def test_geometry_refuses_layer_types_off_the_pattern():
    types = list(CONF["layer_types"])
    types[0] = "full_attention"
    with pytest.raises(ValueError, match="layer_types"):
        model.geometry(dict(CONF, layer_types=types))


def test_plan_is_the_published_stack_in_17_groups():
    g = model.geometry(CONF)
    plan = [(grp["count"], grp["window"]) for grp in g["plan"]]
    assert plan == [(2, 2048), (1, 2048), (1, 0)] + [(3, 2048), (1, 0)] * 7
    assert sum(grp["count"] for grp in g["plan"]) == 32
    assert g["routed"] == list(range(2, 32))
    assert g["window"] == 0
    assert all((grp["n_heads"], grp["n_kv"], grp["hd"]) == (32, 4, 128)
               for grp in g["plan"])
    dense, routed = g["plan"][0]["token_flops"], g["plan"][1]["token_flops"]
    assert all(grp["token_flops"] == routed for grp in g["plan"][1:])
    # A routed layer's own operations: its attention with the gate, the
    # router, the shared expert and 8 of 128 experts.
    attn = 2 * 2048 * 4096 + 2 * 2048 * 512 + 4096 * 2048
    assert routed == 2.0 * (attn + 2048 * 128 + 9 * 3 * 2048 * 1024)
    assert dense == 2.0 * (attn + 3 * 2048 * 6144)


def _active(tree, g):
    """Parameters one token uses in each layer of a drawn tree: every
    matrix, with the experts' at ``top_k`` of ``experts``."""
    total = 0
    for layer in tree["layers"]:
        for name, t in layer.items():
            if t.dim() == 3:
                total += t.numel() * g["top_k"] // g["experts"]
            elif t.dim() == 2:
                total += t.numel()
    return total


@pytest.mark.parametrize("conf", [
    dict(CONF, hidden_size=64, head_dim=16, intermediate_size=96,
         moe_intermediate_size=16, num_experts=32, vocab_size=64,
         num_attention_heads=8, num_key_value_heads=2),
    TINY_AFMOE], ids=["32-layer pattern, narrow", "tiny"])
def test_plan_counts_twice_the_active_parameters_drawn(conf):
    g = model.geometry(conf)
    tree = model.make_weights(g, 5, "cpu")
    flops = sum(grp["count"] * grp["token_flops"] for grp in g["plan"])
    assert flops == 2.0 * _active(tree, g)
    # and so prefill_flops' weight term, past attention and the head.
    assert work.prefill_flops(g, 1, 0) == flops + sum(
        grp["count"] * 4.0 * grp["n_heads"] * grp["hd"]
        for grp in g["plan"]) + 2.0 * g["d"] * g["vocab"]


def test_published_size_is_26_12_billion():
    g = model.geometry(CONF)
    n = 2 * g["vocab"] * g["d"] + len(g["routed"]) * g["d"] * g["experts"]
    for li in range(g["layers"]):
        for shape in FAM.layer_shapes(g, li).values():
            n += torch.Size(shape).numel()
    assert round(n / 1e9, 2) == 26.12


def test_make_weights_draws_norms_at_one_and_a_seeded_bias():
    g = model.geometry(TINY_AFMOE)
    a, b = (model.make_weights(g, s, "cpu") for s in (7, 7))
    c = model.make_weights(g, 8, "cpu")
    for li, layer in enumerate(a["layers"]):
        for name in ("ln1", "ln2", "ln_post_attn", "ln_post_mlp"):
            assert torch.equal(layer[name], torch.ones(g["d"]))
        for name in ("q_norm", "k_norm"):
            assert torch.equal(layer[name], torch.ones(g["hd"]))
        routed = li in g["routed"]
        assert ("expert_bias" in layer) == routed == ("router" in layer)
        if routed:
            bias = layer["expert_bias"]
            assert bias.dtype == torch.float32 and bias.abs().min() > 0
            assert torch.equal(bias, b["layers"][li]["expert_bias"])
            assert not torch.equal(bias, c["layers"][li]["expert_bias"])
            assert 0.05 < float(bias.std()) < 0.2


def test_program_on_the_family_draw_matches_the_reference():
    """The program's prefill of the drawn tree against the reference:
    float32 logits 1e-5 relative L2 (summation order only), and zero
    routing margins where the reference follows the program's own
    choices."""
    g = model.geometry(TINY_AFMOE)
    module, cfg = model.program_config(TINY_AFMOE)
    assert module is pafmoe and cfg.window == 0
    assert cfg.layer_windows == (16, 16, 16, 0, 16)
    weights = model.make_weights(g, 11, "cpu")
    toks = torch.randint(0, g["vocab"], (70,),
                         generator=torch.Generator().manual_seed(12))
    picks = []
    route = pafmoe._route

    def recording(*args, **kw):
        r = route(*args, **kw)
        picks.append(r.expert)
        return r

    pafmoe._route = recording
    try:
        got, _ = module.prefill(weights, cfg, toks[None])
    finally:
        pafmoe._route = route
    pos = list(range(len(toks)))
    want, margins = FAM.logits(weights, g, toks.tolist(), pos)
    err = float((got[0] - want).norm() / want.norm())
    assert err <= 1e-5, err
    assert margins.shape == (4, 70) and float(margins.abs().max()) == 0
    routes = torch.stack(picks)
    again, margins = FAM.logits(weights, g, toks.tolist(), pos,
                                routes=routes)
    assert torch.allclose(again, want, rtol=0, atol=1e-5)
    assert float(margins.max()) <= 1e-6
    # The int8 control: another function, by more than the program.
    low, _ = FAM.logits(weights, g, toks.tolist(), pos, quant="int8",
                        routes=routes)
    assert float((low - want).norm() / want.norm()) > 100 * err


def _root(tmp):
    root, bench = tiny.make_root(tmp)
    with open(os.path.join(root, "configs", "tiny-afmoe.json"), "w") as f:
        json.dump(TINY_AFMOE, f)
    with open(os.path.join(root, "workloads", f"{CELL}.json"), "w") as f:
        json.dump({**tiny.CELL, "check": {"limits": LIMITS}}, f)
    bench = copy.deepcopy(bench)
    bench["workloads"].append({"name": CELL, "config": "tiny-afmoe",
                               "traffic": "backlog", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-moe.backlog" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    return root, bench


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _root(tmp_path_factory.mktemp("bench"))


def _run(root, traced=False, params_hook=None):
    path, bench = root
    result, _ = run_cell.run(CELL, 2**33 + 21, 2.5, traced, "cpu",
                             time.perf_counter(), bench=bench, root=path,
                             params_hook=params_hook)
    return result


def test_sound_run_is_correct_and_reads_the_moe_spans(root):
    result = _run(root, traced=True)
    assert result["correct"] is True, result["check"]
    assert result["traffic"]["sample"]["longest_context"] > 16
    share = result["metrics"]["model.moe_host_share.batch"]["value"]
    assert 0 < share < 100
    assert result["metrics"]["model.mfu.batch"]["value"] > 0


# One token in EVERY, at the middle routed layer, sent to its
# (top_k + 1)-th choice in place of its k-th.
EVERY = 4


def partial_misroute(route, weights, g):
    layer_of = {layer["router"].data_ptr(): li
                for li, layer in enumerate(weights["layers"])
                if "router" in layer}
    target = g["routed"][len(g["routed"]) // 2]
    calls = [0]

    def misrouted(layer, h, cfg, choice=None):
        r = route(layer, h, cfg, choice)
        if layer_of.get(layer["router"].data_ptr()) != target:
            return r
        calls[0] += 1
        scores = torch.sigmoid(
            (h.double() @ layer["router"].double()).float())
        ranked = torch.topk(scores + layer["expert_bias"], cfg.top_k + 1,
                            dim=-1).indices
        moved = torch.cat([ranked[:, :cfg.top_k - 1], ranked[:, -1:]], 1)
        rows = (torch.arange(h.shape[0]) + calls[0]) % EVERY == 0
        return route(layer, h, cfg,
                     torch.where(rows[:, None], moved, r.expert))

    return misrouted


def test_partial_misroute_is_caught_in_its_layer(root, monkeypatch):
    g = model.geometry(TINY_AFMOE)
    route = pafmoe._route

    def hook(weights, module, cfg):
        monkeypatch.setattr(pafmoe, "_route",
                            partial_misroute(route, weights, g))
        return weights

    result = _run(root, params_hook=hook)
    check = result["check"]
    assert result["correct"] is False, check
    layer = check["route_margin_layer"]
    assert layer["value"] > layer["limit"]

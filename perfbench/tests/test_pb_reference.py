"""The plain reference computes what the program computes: at float32
on the CPU, over the benchmark's own weights, both families, with and
without a sliding window. And its int8 control is a lower precision."""

import pytest
import torch

import tiny
from harness.model import geometry, make_weights, program_config
from reference import plain


@pytest.mark.parametrize("conf,window", [
    (tiny.TINY, 8), (tiny.TINY, None), (tiny.TINY_MOE, None)])
def test_reference_matches_the_program_at_float32(conf, window):
    conf = dict(conf, torch_dtype="float32", sliding_window=window)
    g = geometry(conf)
    module, cfg = program_config(conf)
    weights = make_weights(g, 2**40 + 3, "cpu")
    tokens = torch.randint(0, g["vocab"], (1, 24),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = module.prefill(weights, cfg, tokens)[0][0]
    ref, margins = plain.logits(weights, g, tokens[0].tolist(),
                                list(range(24)))
    assert not margins.any()
    scale = ref.abs().max()
    assert (out - ref).abs().max() / scale < 1e-5


def test_int8_control_rounds_the_weights():
    g = geometry(dict(tiny.TINY, torch_dtype="float32"))
    weights = make_weights(g, 9, "cpu")
    w = weights["layers"][0]["wq"]
    q = plain.widen(w, "int8")
    assert not torch.equal(q, w.float())
    # One scale per output column: 255 levels at most in a column.
    assert len(torch.unique(q[:, 0])) <= 255
    err = (q - w).abs().max(dim=0).values / w.abs().max(dim=0).values
    assert float(err.max()) <= 0.5 / 127 + 1e-6
    toks = list(range(20))
    a, _ = plain.logits(weights, g, toks, [19])
    b, _ = plain.logits(weights, g, toks, [19], quant="int8")
    assert 0 < float((a - b).abs().max()) < 0.5


def test_weights_are_the_seeds():
    g = geometry(tiny.TINY)
    a = make_weights(g, 2**35, "cpu")
    b = make_weights(g, 2**35, "cpu")
    c = make_weights(g, 2**35 + 1, "cpu")
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert not torch.equal(a["lm_head"], c["lm_head"])
    assert a["embed"].dtype == torch.bfloat16
    std = a["layers"][1]["w_down"].float().std()
    assert abs(float(std) - g["d"] ** -0.5) < 0.01


def test_followed_routing_and_its_margin():
    g = geometry(dict(tiny.TINY_MOE))
    weights = make_weights(g, 17, "cpu")
    toks = list(range(3, 40))
    own, _ = plain.logits(weights, g, toks, list(range(len(toks))))
    # The reference's own choices, recorded and followed: the same
    # logits and a margin of 0.
    chosen = []
    ffn = plain.moe_ffn

    def record(layer, h, top_k, quant, choice=None):
        probs = torch.softmax((h.double() @ layer["router"].double())
                              .float(), -1)
        chosen.append(torch.topk(probs, top_k, -1).indices)
        return ffn(layer, h, top_k, quant, choice)

    plain.moe_ffn = record
    try:
        plain.logits(weights, g, toks, [0])
    finally:
        plain.moe_ffn = ffn
    routes = torch.stack(chosen)
    again, margins = plain.logits(weights, g, toks, list(range(len(toks))),
                                  routes=routes)
    assert margins.numel() == g["layers"] * len(toks)
    assert not margins.any()
    assert torch.allclose(again, own, atol=1e-5)
    # Another expert in place of one choice: a margin above 0.
    moved = routes.clone()
    moved[1, 5, 1] = (routes[1, 5] .max() + 1) % g["experts"]
    while bool((moved[1, 5, 1] == moved[1, 5, 0])):
        moved[1, 5, 1] = (moved[1, 5, 1] + 1) % g["experts"]
    _, margins = plain.logits(weights, g, toks, [0], routes=moved)
    assert int((margins > 0).sum()) == 1

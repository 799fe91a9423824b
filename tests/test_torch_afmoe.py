"""The AFMoE family (``infinistore_tpu_torch.models.afmoe``) against a
plain float32 reference (``tests/afmoe_plain.py``), on the CPU at a tiny
size: 6 layers (1 dense, then 5 routed), layer kinds sliding / sliding /
full repeated, window 8 on 40-token sequences so the window bites, 16
experts, top-4, one shared expert. Norms are drawn at 1 + 0.1 N(0, 1)
and the expert bias at N(0, 0.1^2), so that a mechanism left out shows.

Tolerances, float32: the program and the reference differ only in
summation order (paged and flash attention, grouped expert products and
a float32 combine against per-token loops), ~1e-6 of the logits; 1e-5
relative L2 is the MoE family's float32 tolerance (tests/
test_torch_moe.py). A served token may lie at most 1e-4 below the
reference's best logit at its position (logits of order one).
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import afmoe_plain as plain
from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM)
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.cuda import CudaKVStore
from infinistore_tpu_torch.models import afmoe
from infinistore_tpu_torch.models import hf
from infinistore_tpu_torch.models import llama
from infinistore_tpu_torch.models import moe

TOL = 1e-5
TOL_GAP = 1e-4
WINDOW = 8
SEQ = 40
TYPES = ["sliding_attention", "sliding_attention", "full_attention"] * 2


def tiny_cfg(types=TYPES, **kw):
    windows, rope_on = afmoe.layer_pattern(types, WINDOW)
    d = dict(vocab_size=64, d_model=32, n_layers=len(types), n_heads=4,
             n_kv_heads=2, d_ff=48, d_expert=16, n_experts=16, top_k=4,
             n_shared=1, n_dense_layers=1, route_scale=2.826,
             route_norm=True, layer_windows=windows, layer_rope=rope_on,
             max_seq=128, page_size=8, embed_scale=math.sqrt(32),
             dtype="float32")
    d.update(kw)
    return afmoe.AfmoeConfig(**d)


def draw(cfg, seed):
    """init_params, then every norm at 1 + 0.1 N(0, 1) and the expert
    bias at N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(seed)
    params = afmoe.init_params(g, cfg, "cpu")
    norms = ("ln1", "ln2", "q_norm", "k_norm", "ln_post_attn",
             "ln_post_mlp")
    for layer in params["layers"]:
        for name in norms:
            layer[name] = 1 + 0.1 * torch.randn(layer[name].shape,
                                                generator=g)
        if "expert_bias" in layer:
            layer["expert_bias"] = 0.1 * torch.randn(cfg.n_experts,
                                                     generator=g)
    params["final_ln"] = 1 + 0.1 * torch.randn(cfg.d_model, generator=g)
    return params


def rel(a, b):
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).norm() / b.norm())


def sequences(cfg, n, seed, length=SEQ):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size, length)]
            for _ in range(n)]


@pytest.fixture(scope="module")
def model():
    cfg = tiny_cfg()
    return cfg, draw(cfg, 0)


def test_config_window_is_the_widest_layer():
    assert tiny_cfg().window == 0
    sliding = tiny_cfg(["sliding_attention"] * 6)
    assert sliding.window == WINDOW
    assert sliding.layer_rope == (True,) * 6
    assert tiny_cfg().layer_rope == (True, True, False) * 2
    with pytest.raises(ValueError, match="one entry per layer"):
        tiny_cfg(n_layers=5)


def test_prefill_logits_match_plain_reference(model):
    cfg, params = model
    toks = sequences(cfg, 1, 1)[0]
    logits, kvs = afmoe.prefill(params, cfg, torch.tensor([toks]))
    want = plain.forward(params, plain.spec_of(cfg), toks)
    assert rel(logits[0], want) <= TOL, rel(logits[0], want)
    assert len(kvs) == cfg.n_layers


def _pool(params, cfg, prompts, max_pages):
    """Prefill each prompt and page its KV into a fresh pool: (k_pages,
    v_pages, page table)."""
    shape = (cfg.n_layers, len(prompts) * max_pages + 1,
             *cfg.kv_page_shape())
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    table = torch.zeros((len(prompts), max_pages), dtype=torch.int32)
    nxt = 1
    for b, toks in enumerate(prompts):
        if toks:
            _, kvs = afmoe.prefill(params, cfg, torch.tensor([toks]))
            for li, (k, v) in enumerate(kvs):
                kpg, vpg = llama.kv_to_pages(cfg, k, v)
                kp[li, nxt:nxt + kpg.shape[1]] = kpg[0]
                vp[li, nxt:nxt + vpg.shape[1]] = vpg[0]
        table[b] = torch.arange(nxt, nxt + max_pages)
        nxt += max_pages
    return kp, vp, table


def test_paged_decode_prefix_and_verify_match_full_forward(model):
    """Prefill, then paged decode step by step across the window (an
    inactive row among the live ones); a prefix prefill over 16 cached
    tokens; a verify step with ragged valid_len: each against the
    reference's full forward at the same positions."""
    cfg, params = model
    spec = plain.spec_of(cfg)
    seqs = sequences(cfg, 2, 2)
    want = [plain.forward(params, spec, s) for s in seqs]
    starts = [12, 5]
    kp, vp, table = _pool(params, cfg, [s[:n] for s, n in
                                        zip(seqs, starts)] + [[]], 6)
    lens = torch.tensor(starts + [0], dtype=torch.int32)
    for _ in range(SEQ - max(starts)):
        token = torch.tensor([seqs[0][int(lens[0])], seqs[1][int(lens[1])],
                              0], dtype=torch.int32)
        logits, kp, vp = afmoe.decode_step(params, cfg, token, lens, kp, vp,
                                           table)
        for b in range(2):
            got, ref = logits[b], want[b][int(lens[b])]
            assert rel(got, ref) <= TOL, (b, int(lens[b]), rel(got, ref))
        lens[:2] += 1

    cached = 16
    _, kvs = afmoe.prefill(params, cfg, torch.tensor([seqs[0][:cached]]))
    logits, _ = afmoe.prefill_with_prefix(
        params, cfg, torch.tensor([seqs[0][cached:]]), kvs)
    assert rel(logits[0], want[0][cached:]) <= TOL

    m, at = 4, [20, 8]
    kp, vp, table = _pool(params, cfg, [s[:n] for s, n in zip(seqs, at)],
                          6)
    toks = torch.tensor([s[n:n + m] for s, n in zip(seqs, at)],
                        dtype=torch.int32)
    valid = torch.tensor([4, 2], dtype=torch.int32)
    logits, _, _ = afmoe.verify_step(params, cfg, toks,
                                     torch.tensor(at, dtype=torch.int32),
                                     kp, vp, table, valid_len=valid)
    for b in range(2):
        n = int(valid[b])
        assert rel(logits[b, :n], want[b][at[b]:at[b] + n]) <= TOL


def test_dropless_when_every_token_picks_the_same_experts(model):
    """An expert bias that sends every token to experts 0-3: capacity
    dispatch (``moe``'s, at factor 1.5) would keep 16 of the 40 tokens
    an expert; the program computes all 40 and matches the reference."""
    cfg, params = model
    params = {**params, "layers": [dict(layer) for layer in
                                   params["layers"]]}
    favoured = torch.zeros(cfg.n_experts)
    favoured[:cfg.top_k] = 5.0
    for layer in params["layers"]:
        if "router" in layer:
            layer["expert_bias"] = layer["expert_bias"] + favoured
    toks = sequences(cfg, 1, 3)[0]
    routed = params["layers"][cfg.n_dense_layers]
    h = torch.randn(SEQ, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    chosen = afmoe._route(routed, h, cfg).expert
    assert (chosen.sort(dim=1).values
            == torch.arange(cfg.top_k)).all()
    capacity = moe.MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                             capacity_factor=1.5).capacity(SEQ)
    assert capacity < SEQ
    logits, _ = afmoe.prefill(params, cfg, torch.tensor([toks]))
    want = plain.forward(params, plain.spec_of(cfg), toks)
    assert rel(logits[0], want) <= TOL


def _without(params, *names):
    return {**params, "layers": [
        {k: v for k, v in layer.items() if k not in names}
        for layer in params["layers"]]}


def _bias_weighs_too(monkeypatch):
    """A router whose weights are the biased scores."""
    def route(layer, h, cfg, choice=None):
        scores = torch.sigmoid(
            (h.double() @ layer["router"].double()).float())
        biased = scores + layer["expert_bias"]
        expert = torch.topk(biased, cfg.top_k, dim=-1).indices
        weight = biased.gather(1, expert)
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        return afmoe.Routing(expert, weight * cfg.route_scale)

    monkeypatch.setattr(afmoe, "_route", route)


ABLATIONS = {
    "qk_norm": lambda p, c, mp: (_without(p, "q_norm", "k_norm"), c),
    "output_gate": lambda p, c, mp: (_without(p, "wg"), c),
    "nope_on_full_layers": lambda p, c, mp: (
        p, dataclasses.replace(c, layer_rope=(True,) * c.n_layers)),
    "post_attention_norm": lambda p, c, mp: (_without(p, "ln_post_attn"), c),
    "post_mlp_norm": lambda p, c, mp: (_without(p, "ln_post_mlp"), c),
    "bias_selects_only": lambda p, c, mp: (_bias_weighs_too(mp), (p, c))[1],
    "route_norm": lambda p, c, mp: (
        p, dataclasses.replace(c, route_norm=False)),
    "route_scale": lambda p, c, mp: (
        p, dataclasses.replace(c, route_scale=1.0)),
    "shared_expert": lambda p, c, mp: (
        _without(p, "s_gate", "s_up", "s_down"), c),
    "mup_embed_scale": lambda p, c, mp: (
        p, dataclasses.replace(c, embed_scale=1.0)),
}


@pytest.mark.parametrize("mechanism", list(ABLATIONS))
def test_each_mechanism_left_out_fails_the_comparison(model, monkeypatch,
                                                      mechanism):
    cfg, params = model
    toks = sequences(cfg, 1, 5)[0]
    want = plain.forward(params, plain.spec_of(cfg), toks)
    p, c = ABLATIONS[mechanism](params, cfg, monkeypatch)
    logits, _ = afmoe.prefill(p, c, torch.tensor([toks]))
    assert rel(logits[0], want) > 100 * TOL, rel(logits[0], want)


# ---- serving -------------------------------------------------------------


@pytest.fixture(scope="module")
def store():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=16,
    ))
    srv.start()
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=TYPE_SHM))
    conn.connect()
    kv = CudaKVStore(conn, device="cpu")
    yield kv
    kv.close()
    conn.close()
    srv.stop()


def served_gaps(params, cfg, prompts, outputs):
    """Per served token, the reference's best logit minus its own."""
    spec = plain.spec_of(cfg)
    gaps = []
    for prompt, out in zip(prompts, outputs):
        ref = plain.forward(params, spec, prompt + out[:-1])
        rows = ref[len(prompt) - 1:]
        gaps.append(rows.max(-1).values - rows[torch.arange(len(out)),
                                               torch.tensor(out)])
    return torch.cat(gaps)


ENGINES = {
    "plain": dict(max_slots=2, total_pages=32),
    "spec": dict(max_slots=2, spec_k=2),
    "chunk": dict(max_slots=2, prefill_chunk=8),
    "burst": dict(max_slots=2, host_steps=4),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_serves_the_reference_tokens(model, store, case):
    cfg, params = model
    prompts = sequences(cfg, 2, 6) + [[3, 7, 3, 7, 3, 7, 3, 7, 3, 7, 3]]
    prompts[1] = prompts[1][:23]
    engine = ts.ServingEngine(params, cfg,
                              ts.ServingConfig(model_id=f"afmoe-{case}",
                                               **ENGINES[case]),
                              store=store, model=afmoe, device="cpu")
    out = engine.run([ts.Request(f"r{i}", p, max_new_tokens=8)
                      for i, p in enumerate(prompts)])
    outputs = [out[f"r{i}"] for i in range(len(prompts))]
    gaps = served_gaps(params, cfg, prompts, outputs)
    assert float(gaps.max()) <= TOL_GAP, gaps
    routed = cfg.n_layers - cfg.n_dense_layers
    assert engine.stats["moe_route_n"] > 0
    assert engine.stats["moe_route_n"] == engine.stats["moe_experts_n"]
    assert engine.stats["moe_route_n"] % routed == 0
    assert engine.stats["moe_route_ns"] > 0
    assert engine.stats["offloaded_pages"] > 0
    if case == "spec":
        assert engine.stats["spec_proposed"] > 0
    if case == "chunk":
        assert engine.stats["chunk_steps"] > 0
    if case == "burst":
        assert engine.stats["burst_steps"] > 0


@pytest.mark.parametrize("stack", ["mixed", "sliding_only"])
def test_window_paging_follows_the_widest_layer(store, stack):
    """A stack with a full layer neither skips nor frees a page below
    the window and restores a prefix hit whole; a stack of sliding
    layers alone frees pages as they leave the window and restores only
    the pages the window reaches. Both serve the cold engine's tokens
    on the hit."""
    types = TYPES if stack == "mixed" else ["sliding_attention"] * 6
    cfg = tiny_cfg(types)
    params = draw(cfg, 1)
    sc = ts.ServingConfig(model_id=f"afmoe-window-{stack}", max_slots=2,
                          total_pages=32)
    turn1 = sequences(cfg, 1, 7)[0]
    eng = ts.ServingEngine(params, cfg, sc, store=store, model=afmoe,
                           device="cpu")
    eng.submit(ts.Request("t1", turn1, max_new_tokens=12))
    released = []
    while eng.queue or any(eng.slots):
        eng.step()
        for s in eng.slots:
            if s is not None:
                released.append(s.released)
                if stack == "mixed":
                    assert 0 not in s.page_ids, s.page_ids
    convo = turn1 + eng.outputs["t1"]
    page = cfg.page_size
    turn2 = convo[:(len(convo) // page) * page] + [5, 9, 11]
    hit_eng = ts.ServingEngine(params, cfg, sc, store=store, model=afmoe,
                               device="cpu")
    out2 = hit_eng.run([ts.Request("t2", turn2, max_new_tokens=6)])
    hit = hit_eng.stats["prefix_hit_pages"]
    assert hit == len(convo) // page
    whole = hit * cfg.n_layers * 2
    if stack == "mixed":
        assert max(released) == 0
        assert hit_eng.stats["restored_pages"] == whole
    else:
        assert max(released) > 0
        assert 0 < hit_eng.stats["restored_pages"] < whole
    cold = ts.ServingEngine(params, cfg, sc, model=afmoe, device="cpu")
    assert out2["t2"] == cold.run([ts.Request("x", turn2,
                                              max_new_tokens=6)])["x"]


# ---- the HF config ---------------------------------------------------------

# The catalog's arcee-ai/Trinity-Mini config.json keys, typed in.
TRINITY_MINI = dict(
    global_attn_every_n_layers=4, head_dim=128, hidden_act="silu",
    hidden_size=2048, intermediate_size=6144,
    layer_types=["sliding_attention"] * 3 + ["full_attention"],
    load_balance_coeff=0.001, max_position_embeddings=131072,
    model_type="afmoe", moe_intermediate_size=1024, mup_enabled=True,
    n_group=1, num_attention_heads=32, num_dense_layers=2,
    num_expert_groups=1, num_experts=128, num_experts_per_tok=8,
    num_hidden_layers=32, num_key_value_heads=4, num_limited_groups=1,
    num_shared_experts=1, rms_norm_eps=1e-05, rope_scaling=None,
    rope_theta=10000, route_norm=True, route_scale=2.826,
    score_func="sigmoid", sliding_window=2048, tie_word_embeddings=False,
    topk_group=1, use_grouped_mm=True, vocab_size=200192)
TRINITY_MINI["layer_types"] = TRINITY_MINI["layer_types"] * 8


def test_hf_config_maps_trinity_mini():
    cfg = hf.config_from_hf(SimpleNamespace(**TRINITY_MINI),
                            dtype="bfloat16")
    assert isinstance(cfg, afmoe.AfmoeConfig)
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (2048, 32, 32, 4, 128, 200192)
    assert (cfg.d_ff, cfg.d_expert, cfg.n_experts, cfg.top_k, cfg.n_shared,
            cfg.n_dense_layers) == (6144, 1024, 128, 8, 1, 2)
    assert (cfg.route_scale, cfg.route_norm) == (2.826, True)
    assert cfg.layer_windows == (2048, 2048, 2048, 0) * 8
    assert cfg.layer_rope == (True, True, True, False) * 8
    assert cfg.window == 0
    assert cfg.embed_scale == pytest.approx(2048 ** 0.5)
    assert cfg.kv_page_bytes() == 16 * 4 * 128 * 2
    # Without layer_types: every global_attn_every_n_layers-th is full.
    bare = SimpleNamespace(**{k: v for k, v in TRINITY_MINI.items()
                              if k != "layer_types"})
    assert hf.config_from_hf(bare).layer_windows == cfg.layer_windows


@pytest.mark.parametrize("key,value", [
    ("score_func", "softmax"), ("n_group", 2), ("num_expert_groups", 2),
    ("topk_group", 2), ("rope_scaling", {"rope_type": "yarn"}),
    ("hidden_act", "gelu")])
def test_hf_config_refuses_what_afmoe_does_not_run(key, value):
    conf = SimpleNamespace(**dict(TRINITY_MINI, **{key: value}))
    with pytest.raises(NotImplementedError, match=key.split("_")[0]):
        hf.config_from_hf(conf)


def test_load_hf_refuses_afmoe_weights():
    with pytest.raises(NotImplementedError, match="weight names"):
        hf.load_hf({}, SimpleNamespace(**TRINITY_MINI), device="cpu")

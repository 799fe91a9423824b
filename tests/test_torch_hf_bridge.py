"""The port's HF bridge (``infinistore_tpu_torch.models.hf``) against
``transformers`` and against the JAX package's bridge, on tiny configs
built here with random weights (nothing is downloaded): every family the
JAX bridge maps (Llama, Llama-3.1 with llama3 rope scaling and biases,
Qwen2, Mistral with a window, Gemma-1, exact gelu, tied embeddings,
Mixtral). For each, the port's tree equals the JAX bridge's leaf for
leaf, and its prefill logits and one paged decode step's logits match
transformers' (2e-4, the JAX bridge tests' tolerance, float32) and the
JAX model's on the JAX bridge's tree. Every hard error of the JAX bridge
is raised by the port's, with the same exception type."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from infinistore_tpu.models import hf as jhf  # noqa: E402
from infinistore_tpu.models import llama as jl  # noqa: E402
from infinistore_tpu.models import moe as jm  # noqa: E402
from infinistore_tpu_torch.models import hf as thf  # noqa: E402
from infinistore_tpu_torch.models import llama as tl  # noqa: E402
from infinistore_tpu_torch.models import moe as tm  # noqa: E402

# float32 end to end, against transformers and the JAX model: summation
# order only (the JAX bridge's own tests hold 2e-4 against transformers).
TOL = 2e-4

_SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256,
              rms_norm_eps=1e-5, rope_theta=10000.0,
              tie_word_embeddings=False)

# family: (transformers class names, config overrides, seed, prefill
# length, decode position). The decode position is past the window
# (Mistral) or past original_max_position_embeddings (Llama-3.1).
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", {}, 0, 24, 16),
    "llama31": ("LlamaConfig", "LlamaForCausalLM", dict(
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64},
        attention_bias=True), 3, 96, 80),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
              dict(use_sliding_window=False), 7, 24, 16),
    "mistral_window": ("MistralConfig", "MistralForCausalLM",
                       dict(sliding_window=16), 21, 48, 40),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(
        intermediate_size=128, num_key_value_heads=1, head_dim=32,
        rms_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
        tie_word_embeddings=True), 51, 24, 16),
    "gelu_exact": ("LlamaConfig", "LlamaForCausalLM",
                   dict(hidden_act="gelu", intermediate_size=128), 59, 24,
                   16),
    "tied": ("LlamaConfig", "LlamaForCausalLM",
             dict(tie_word_embeddings=True), 1, 24, 16),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM", dict(
        intermediate_size=96, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=None), 61, 24, 16),
}


def _build(family):
    cfg_cls, model_cls, over, seed, _, _ = FAMILIES[family]
    cfg = getattr(transformers, cfg_cls)(**{**_SMALL, **over})
    torch.manual_seed(seed)
    return getattr(transformers, model_cls)(cfg).eval()


@pytest.fixture(scope="module")
def loaded():
    """family -> (HF model, state dict, port (cfg, params), JAX (cfg,
    params), port model module, JAX model module)."""
    cache = {}

    def get(family):
        if family not in cache:
            model = _build(family)
            sd = dict(model.state_dict())
            if FAMILIES[family][2].get("tie_word_embeddings"):
                sd.pop("lm_head.weight", None)
            if family == "mixtral":
                port = thf.load_hf_moe(sd, model.config, page_size=8,
                                       device="cpu")
                jax_ = jhf.load_hf_moe(sd, model.config, page_size=8)
                mods = (tm, jm)
            else:
                port = thf.load_hf(sd, model.config, page_size=8,
                                   device="cpu")
                jax_ = jhf.load_hf(sd, model.config, page_size=8)
                mods = (tl, jl)
            cache[family] = (model, sd, port, jax_) + mods
        return cache[family]
    return get


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _prefill(mod, params, cfg, tokens):
    out = mod.prefill(params, cfg, tokens)
    return out[0], out[1]


def _port_decode(mod, params, cfg, tokens, seq):
    """Prefill tokens[:, :seq], page the KV into a pool, decode token
    ``seq``: its logits [vocab]."""
    _, kvs = _prefill(mod, params, cfg, torch.from_numpy(tokens[:, :seq]))
    n_pages = seq // cfg.page_size
    kp = torch.zeros(cfg.n_layers, n_pages + 1, *cfg.kv_page_shape())
    vp = torch.zeros_like(kp)
    for li, (k, v) in enumerate(kvs):
        kpg, vpg = tl.kv_to_pages(cfg, k, v)
        kp[li, :n_pages], vp[li, :n_pages] = kpg[0], vpg[0]
    table = torch.arange(n_pages + 1, dtype=torch.int32)[None]
    logits, _, _ = mod.decode_step(
        params, cfg, torch.from_numpy(tokens[:, seq]).int(),
        torch.tensor([seq], dtype=torch.int32), kp, vp, table)
    return logits[0]


def _jax_decode(mod, params, cfg, tokens, seq):
    _, kvs = _prefill(mod, params, cfg, jnp.asarray(tokens[:, :seq],
                                                    jnp.int32))
    n_pages = seq // cfg.page_size
    shape = (cfg.n_layers, n_pages + 1, *cfg.kv_page_shape())
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for li, (k, v) in enumerate(kvs):
        kpg, vpg = jl.kv_to_pages(cfg, k, v)
        kp[li, :n_pages], vp[li, :n_pages] = kpg[0], vpg[0]
    table = jnp.arange(n_pages + 1, dtype=jnp.int32)[None]
    logits, _, _ = mod.decode_step(
        params, cfg, jnp.asarray(tokens[:, seq], jnp.int32),
        jnp.asarray([seq], jnp.int32), jnp.asarray(kp), jnp.asarray(vp),
        table)
    return logits[0]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tree_equals_the_jax_bridges(loaded, family):
    """Same config and the same leaves, bit for bit: both trees store
    projections [in, out]."""
    _, _, (tcfg, tparams), (jcfg, jparams), _, _ = loaded(family)
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "head_dim", "rope_theta", "rope_scaling", "window",
              "norm_eps", "norm_plus_one", "embed_scale", "act",
              "n_experts", "top_k", "capacity_factor"):
        assert getattr(tcfg, f, None) == getattr(jcfg, f, None), f
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(leaves) == len(tl.param_leaves(tparams))
    for path, leaf in leaves:
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        assert node.device.type == "cpu"
        assert tuple(node.shape) == leaf.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(_np(node), _np(leaf))
    if family == "mixtral":
        assert tparams["layers"][0]["router"].dtype == torch.float32
        assert tcfg.capacity_factor == tcfg.n_experts / tcfg.top_k
    if family in ("tied", "gemma"):
        assert torch.equal(tparams["lm_head"], tparams["embed"].T)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_paged_decode_match(loaded, family):
    model, _, (tcfg, tparams), (jcfg, jparams), tmod, jmod = loaded(family)
    _, _, _, _, n, seq = FAMILIES[family]
    rng = np.random.default_rng(FAMILIES[family][3] + 1)
    tokens = rng.integers(0, tcfg.vocab_size, (2, n)).astype(np.int64)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
    ours, _ = _prefill(tmod, tparams, tcfg, torch.from_numpy(tokens))
    theirs, _ = _prefill(jmod, jparams, jcfg, jnp.asarray(tokens,
                                                          jnp.int32))
    ours = _np(ours)
    assert np.abs(ours - ref).max() < TOL, np.abs(ours - ref).max()
    assert np.abs(ours - _np(theirs)).max() < TOL
    assert np.array_equal(ours.argmax(-1), ref.argmax(-1))

    one = tokens[:1, :seq + 1]
    got = _np(_port_decode(tmod, tparams, tcfg, one, seq))
    want = _np(_jax_decode(jmod, jparams, jcfg, one, seq))
    assert np.abs(got - ref[0, seq]).max() < TOL
    assert np.abs(got - want).max() < TOL
    assert int(got.argmax()) == int(ref[0, seq].argmax())


def test_config_from_an_attribute_namespace():
    """No transformers object needed: any namespace with the HF config's
    attributes maps (here Mixtral-8x7B-v0.1's published config.json)."""
    ns = types.SimpleNamespace(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        num_local_experts=8, num_experts_per_tok=2, rope_theta=1e6,
        max_position_embeddings=32768, rms_norm_eps=1e-5,
        sliding_window=None, hidden_act="silu")
    cfg = thf.moe_config_from_hf(ns, dtype="bfloat16")
    assert (cfg.head_dim, cfg.capacity_factor, cfg.dtype) == (
        128, 4.0, "bfloat16")
    assert cfg == tm.MoEConfig(**{
        f: getattr(jhf.moe_config_from_hf(ns, dtype="bfloat16"), f)
        for f in tm.MoEConfig.__dataclass_fields__})
    assert cfg.capacity(2048) == 2048
    assert thf.config_from_hf(types.SimpleNamespace(
        **{**vars(ns), "model_type": "llama"})).n_layers == 32


def test_qwen2_window_flags_map_as_the_jax_bridge():
    for kw, window in ((dict(use_sliding_window=True, sliding_window=None,
                             max_window_layers=0), 0),
                       (dict(use_sliding_window=True, sliding_window=64,
                             max_window_layers=0), 64),
                       (dict(use_sliding_window=True, sliding_window=64,
                             max_window_layers=4), 0)):
        cfg = transformers.Qwen2Config(num_hidden_layers=4, **kw)
        assert thf.config_from_hf(cfg).window == window
        assert jhf.config_from_hf(cfg).window == window


def _mixtral_cfg(**kw):
    return transformers.MixtralConfig(**{"sliding_window": None, **kw})


_LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
           "high_freq_factor": 4.0, "original_max_position_embeddings": 64}

# name: (call(bridge module), exception match). Each refuses a checkpoint
# feature the models do not implement.
HARD_ERRORS = {
    "rope_scaling_yarn": (lambda b: b.config_from_hf(
        transformers.LlamaConfig(rope_scaling={"rope_type": "yarn",
                                               "factor": 4.0})),
        "rope_scaling"),
    "qwen2_mixed_window": (lambda b: b.config_from_hf(
        transformers.Qwen2Config(num_hidden_layers=8,
                                 use_sliding_window=True,
                                 sliding_window=64, max_window_layers=4)),
        "mixed per-layer"),
    "gemma2": (lambda b: b.config_from_hf(transformers.Gemma2Config(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2,
        num_key_value_heads=1)), "gemma2"),
    "hidden_act": (lambda b: b.config_from_hf(
        transformers.LlamaConfig(hidden_act="relu")), "hidden_act"),
    "mlp_bias": (lambda b: b.load_hf(transformers.LlamaForCausalLM(
        transformers.LlamaConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=2, mlp_bias=True)),
        **({"device": "cpu"} if b is thf else {})), "mlp_bias"),
    "mixtral_sliding_window": (lambda b: b.moe_config_from_hf(
        transformers.MixtralConfig(sliding_window=4096)), "sliding_window"),
    "mixtral_rope_scaling": (lambda b: b.moe_config_from_hf(
        _mixtral_cfg(rope_scaling=_LLAMA3)), "rope_scaling"),
    "mixtral_activation": (lambda b: b.moe_config_from_hf(
        _mixtral_cfg(hidden_act="gelu_pytorch_tanh")), "activation"),
    "mixtral_attention_bias": (lambda b: b.moe_params_from_hf(
        {"model.layers.0.self_attn.v_proj.bias": torch.zeros(8)},
        b.moe_config_from_hf(_mixtral_cfg()),
        **({"device": "cpu"} if b is thf else {})), "attention_bias"),
}


@pytest.mark.parametrize("name", list(HARD_ERRORS))
def test_hard_errors_match_the_jax_bridge(name):
    call, match = HARD_ERRORS[name]
    for bridge in (jhf, thf):
        with pytest.raises(NotImplementedError, match=match):
            call(bridge)

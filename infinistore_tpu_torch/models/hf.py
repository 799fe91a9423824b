"""HuggingFace checkpoints into the port's models: Llama (with llama3
``rope_scaling``), Qwen2, Mistral, Gemma-1 and Mixtral.

The counterpart of ``infinistore_tpu/models/hf.py``, with the same
config mapping and the same hard errors (a checkpoint feature the models
do not implement raises rather than loading and silently diverging). It
never imports ``transformers``: the config is any object with the HF
config's attributes, and the weights a state dict (name -> tensor or
numpy array) or a module with ``.state_dict()``. ``nn.Linear`` stores
[out, in]; the port's trees store [in, out] like the JAX package's, so
every projection transposes. The leaves land on ``device`` (the card
unless ``device="cpu"``) in the config's dtype; a Mixtral router stays
float32.
"""

import torch

from .._device import resolve_device
from .llama import LlamaConfig


def config_from_hf(hf_cfg, page_size=16, dtype="float32"):
    """Map a HF Llama-family config onto :class:`LlamaConfig`. Raises
    NotImplementedError on checkpoint features the model does not
    implement."""
    scaling = getattr(hf_cfg, "rope_scaling", None)
    rope_scaling = ()
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type", ""))
        if rope_type == "llama3":
            rope_scaling = (
                float(scaling["factor"]),
                float(scaling["low_freq_factor"]),
                float(scaling["high_freq_factor"]),
                float(scaling["original_max_position_embeddings"]),
            )
        elif rope_type != "default":
            raise NotImplementedError(
                f"rope_scaling type {rope_type!r} is not supported "
                "(implemented: 'llama3', 'default'); a linear/yarn/"
                "dynamic checkpoint would produce wrong logits at "
                "every position"
            )
    # Sliding window: Qwen2 gates it behind use_sliding_window (and
    # transformers also on sliding_window being set), with
    # max_window_layers bottom layers at full attention, and the model
    # has one global window, so a mixed stack raises; Mistral's window is
    # on whenever sliding_window is set, on every layer.
    window = 0
    if hasattr(hf_cfg, "use_sliding_window"):
        if hf_cfg.use_sliding_window and hf_cfg.sliding_window is not None:
            mwl = int(getattr(hf_cfg, "max_window_layers", 0))
            if mwl >= hf_cfg.num_hidden_layers:
                window = 0
            elif mwl == 0:
                window = int(hf_cfg.sliding_window)
            else:
                raise NotImplementedError(
                    f"mixed per-layer sliding window (max_window_layers="
                    f"{mwl} of {hf_cfg.num_hidden_layers}) — the model "
                    "has one global window"
                )
    else:
        sw = getattr(hf_cfg, "sliding_window", None)
        if sw is not None:
            window = int(sw)
    # Decoupled head_dim (Gemma, Mistral-NeMo) becomes an override.
    hd = getattr(hf_cfg, "head_dim", None)
    derived = hf_cfg.hidden_size // hf_cfg.num_attention_heads
    head_dim_override = hd if (hd is not None and hd != derived) else 0
    hidden_act = getattr(hf_cfg, "hidden_act",
                         getattr(hf_cfg, "hidden_activation", None)) \
        or "silu"
    if hidden_act in ("silu", "swish"):
        act = "silu"
    elif hidden_act in ("gelu_pytorch_tanh", "gelu_new", "gelu_fast"):
        act = "gelu"          # tanh approximation
    elif hidden_act == "gelu":
        act = "gelu_exact"    # erf form: a distinct function
    else:
        raise NotImplementedError(
            f"hidden_act {hidden_act!r} has no mapping"
        )
    # Gemma-1: (1 + w) norms and sqrt(hidden_size)-scaled embeddings.
    # Gemma-2/3 add logit softcapping and extra per-layer norms.
    model_type = getattr(hf_cfg, "model_type", "")
    if model_type.startswith("gemma") and model_type != "gemma":
        raise NotImplementedError(
            f"{model_type} checkpoints carry logit softcapping and "
            "extra per-layer norms the model does not implement "
            "(gemma-1 is supported)"
        )
    is_gemma = model_type == "gemma"
    return LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_layers=hf_cfg.num_hidden_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=hf_cfg.num_key_value_heads,
        d_ff=hf_cfg.intermediate_size,
        max_seq=hf_cfg.max_position_embeddings,
        page_size=page_size,
        rope_theta=float(hf_cfg.rope_theta),
        rope_scaling=rope_scaling,
        window=window,
        act=act,
        norm_plus_one=is_gemma,
        embed_scale=float(hf_cfg.hidden_size) ** 0.5 if is_gemma else 1.0,
        head_dim_override=head_dim_override,
        norm_eps=float(hf_cfg.rms_norm_eps),
        dtype=dtype,
    )


def _state_dict(model_or_state_dict):
    sd = model_or_state_dict
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def _leaf(sd, name, dtype, device, transpose=False):
    """sd[name] as a ``dtype`` tensor on ``device`` ([out, in] -> [in,
    out] when ``transpose``)."""
    w = torch.as_tensor(sd[name]).detach().to(device=device, dtype=dtype)
    return w.T.contiguous() if transpose else w


def _embed_and_head(sd, dt, device):
    embed = _leaf(sd, "model.embed_tokens.weight", dt, device)
    if "lm_head.weight" in sd:
        lm_head = _leaf(sd, "lm_head.weight", dt, device, transpose=True)
    else:  # tied embeddings
        lm_head = embed.T.contiguous()
    return embed, lm_head


def _attention(sd, p, dt, device):
    return {
        "ln1": _leaf(sd, p + "input_layernorm.weight", dt, device),
        **{ours: _leaf(sd, p + f"self_attn.{theirs}.weight", dt, device,
                       transpose=True)
           for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                                ("wv", "v_proj"), ("wo", "o_proj"))},
        "ln2": _leaf(sd, p + "post_attention_layernorm.weight", dt, device),
    }


def params_from_hf(model_or_state_dict, cfg: LlamaConfig, device="cuda"):
    """The port's llama parameter dict from a HF Llama-family model or
    its state dict, on ``device``."""
    device = resolve_device(device)
    sd = _state_dict(model_or_state_dict)
    dt = cfg.torch_dtype
    layers = []
    for li in range(cfg.n_layers):
        p = f"model.layers.{li}."
        # mlp_bias=True checkpoints carry biases the MLP has no slot for.
        for theirs in ("gate_proj", "up_proj", "down_proj"):
            if p + f"mlp.{theirs}.bias" in sd:
                raise NotImplementedError(
                    "mlp_bias=True checkpoints are not supported: "
                    f"{p}mlp.{theirs}.bias has no parameter slot"
                )
        layer = _attention(sd, p, dt, device)
        for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
            layer[ours] = _leaf(sd, p + f"mlp.{theirs}.weight", dt, device,
                                transpose=True)
        # attention_bias=True checkpoints (Qwen2: q/k/v, no o).
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"),
                             ("bv", "v_proj"), ("bo", "o_proj")):
            name = p + f"self_attn.{theirs}.bias"
            if name in sd:
                layer[ours] = _leaf(sd, name, dt, device)
        layers.append(layer)
    embed, lm_head = _embed_and_head(sd, dt, device)
    return {"embed": embed, "layers": layers,
            "final_ln": _leaf(sd, "model.norm.weight", dt, device),
            "lm_head": lm_head}


def load_hf(model_or_state_dict, hf_cfg=None, page_size=16,
            dtype="float32", device="cuda"):
    """One-call bridge: returns (cfg, params). ``hf_cfg`` defaults to
    ``model.config`` when a model object is passed."""
    if hf_cfg is None:
        hf_cfg = model_or_state_dict.config
    cfg = config_from_hf(hf_cfg, page_size=page_size, dtype=dtype)
    return cfg, params_from_hf(model_or_state_dict, cfg, device)


def moe_config_from_hf(hf_cfg, page_size=16, dtype="float32"):
    """Map a HF Mixtral config onto :class:`~.moe.MoEConfig`.

    capacity_factor is n_experts / top_k, so per-expert capacity equals
    the token count and no token is ever dropped: the condition for the
    routing to be HF's dense top-k."""
    from .moe import MoEConfig

    if getattr(hf_cfg, "sliding_window", None) is not None:
        raise NotImplementedError(
            "Mixtral sliding_window set: the MoE family does not route "
            "windowed attention configs yet"
        )
    # The MoE bridge applies unscaled RoPE only: any scaling, 'llama3'
    # included, raises.
    scaling = getattr(hf_cfg, "rope_scaling", None)
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type", ""))
        if rope_type != "default":
            raise NotImplementedError(
                f"rope_scaling type {rope_type!r} is not supported by "
                "the MoE bridge (the MoE attention stack applies "
                "unscaled RoPE only)"
            )
    if getattr(hf_cfg, "hidden_act", "silu") not in ("silu", "swish"):
        raise NotImplementedError(
            f"MoE expert activation {hf_cfg.hidden_act!r}: the expert "
            "FFN is SwiGLU (silu)"
        )
    hd = getattr(hf_cfg, "head_dim", None)
    derived = hf_cfg.hidden_size // hf_cfg.num_attention_heads
    return MoEConfig(
        head_dim_override=(
            hd if (hd is not None and hd != derived) else 0
        ),
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_layers=hf_cfg.num_hidden_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=hf_cfg.num_key_value_heads,
        d_ff=hf_cfg.intermediate_size,
        n_experts=hf_cfg.num_local_experts,
        top_k=hf_cfg.num_experts_per_tok,
        capacity_factor=float(hf_cfg.num_local_experts)
        / hf_cfg.num_experts_per_tok,
        max_seq=hf_cfg.max_position_embeddings,
        page_size=page_size,
        rope_theta=float(hf_cfg.rope_theta),
        norm_eps=float(hf_cfg.rms_norm_eps),
        dtype=dtype,
    )


def moe_params_from_hf(model_or_state_dict, cfg, device="cuda"):
    """The port's MoE parameter dict from a HF Mixtral model or its state
    dict, on ``device``: per-expert w1 / w3 / w2 ([out, in] each) stack
    on the leading E axis as e_gate / e_up / e_down ([E, in, out]); the
    router gate transposes like every projection and stays float32."""
    device = resolve_device(device)
    sd = _state_dict(model_or_state_dict)
    dt = cfg.torch_dtype
    layers = []
    for li in range(cfg.n_layers):
        p = f"model.layers.{li}."
        m = p + "block_sparse_moe."
        # The MoE attention has no bias slots: refuse rather than drop.
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            if p + f"self_attn.{proj}.bias" in sd:
                raise NotImplementedError(
                    "attention_bias=True checkpoints are not supported "
                    f"by the MoE bridge: {p}self_attn.{proj}.bias has "
                    "no parameter slot"
                )
        layer = _attention(sd, p, dt, device)
        layer["router"] = _leaf(sd, m + "gate.weight", torch.float32,
                                device, transpose=True)
        for ours, theirs in (("e_gate", "w1"), ("e_up", "w3"),
                             ("e_down", "w2")):
            layer[ours] = torch.stack([
                _leaf(sd, m + f"experts.{e}.{theirs}.weight", dt, device,
                      transpose=True)
                for e in range(cfg.n_experts)])
        layers.append(layer)
    embed, lm_head = _embed_and_head(sd, dt, device)
    return {"embed": embed, "layers": layers,
            "final_ln": _leaf(sd, "model.norm.weight", dt, device),
            "lm_head": lm_head}


def load_hf_moe(model_or_state_dict, hf_cfg=None, page_size=16,
                dtype="float32", device="cuda"):
    """One-call Mixtral bridge: returns (cfg, params)."""
    if hf_cfg is None:
        hf_cfg = model_or_state_dict.config
    cfg = moe_config_from_hf(hf_cfg, page_size=page_size, dtype=dtype)
    return cfg, moe_params_from_hf(model_or_state_dict, cfg, device)


__all__ = ["config_from_hf", "params_from_hf", "load_hf",
           "moe_config_from_hf", "moe_params_from_hf", "load_hf_moe"]

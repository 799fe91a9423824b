"""Model families of the port: ``llama`` (with the HF Llama, Qwen2,
Mistral and Gemma-1 checkpoints through ``hf``), the sparse-MoE ``moe``
(Mixtral) and ``afmoe`` (Arcee Trinity: sliding and full layers, dense
and routed layers, a sigmoid router with a shared expert)."""

from .llama import (  # noqa: F401
    LlamaConfig,
    decode_step,
    init_params,
    init_params_quantized,
    prefill,
    prefill_with_prefix,
    quantize_params,
    train_step,
)
from .hf import load_hf, load_hf_moe  # noqa: F401

"""Parallelism of the port: the (dp, tp) mesh with Megatron tensor
parallelism and FSDP (``mesh``), GPipe over pp (``pipeline``), the device
KV pool with its handoff and store tiering (``ici_handoff``), the
point-to-point transport they and the sequence ring share
(``transport``), and the ranks' launcher (``launch``). Sequence
parallelism is ``ops.ring_attention``; expert parallelism is in
``models.moe``."""

from .mesh import (  # noqa: F401
    MeshConfig,
    TensorParallel,
    fsdp_param_shardings,
    init_process_group,
    make_mesh,
    param_shardings,
    shard_params,
)

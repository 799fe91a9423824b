"""Parallelism of the port: the (dp, tp) mesh with Megatron tensor
parallelism and FSDP (``mesh``)."""

from .mesh import (  # noqa: F401
    MeshConfig,
    TensorParallel,
    fsdp_param_shardings,
    init_process_group,
    make_mesh,
    param_shardings,
    shard_params,
)

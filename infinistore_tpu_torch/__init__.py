"""infinistore-tpu ported to PyTorch and CUDA.

The same disaggregated KV-cache pool (the native server and its client,
copied from the JAX package's jax-free store layer) with a CUDA device
edge (`infinistore_tpu_torch.cuda`) that copies KV pages between GPU
memory and the pinned shared-memory pool, a PyTorch Llama
(`infinistore_tpu_torch.models.llama`) and hand-written CUDA attention
kernels (`infinistore_tpu_torch.ops`). Nothing here imports JAX.
"""

from ._native import (  # noqa: F401
    FAKE_TOKEN,
    KEY_NOT_FOUND,
    OK,
    REMOTE_BLOCK_DTYPE,
    status_name,
)
from .config import (  # noqa: F401
    TYPE_AUTO,
    TYPE_SHM,
    TYPE_STREAM,
    ClientConfig,
    ServerConfig,
)
from .lib import (  # noqa: F401
    InfiniStoreError,
    InfiniStoreKeyNotFound,
    InfinityConnection,
    Logger,
    check_supported,
    set_log_level,
)
from .server import InfiniStoreServer  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "ClientConfig",
    "ServerConfig",
    "InfinityConnection",
    "InfiniStoreServer",
    "InfiniStoreError",
    "InfiniStoreKeyNotFound",
    "Logger",
    "TYPE_AUTO",
    "TYPE_SHM",
    "TYPE_STREAM",
    "check_supported",
    "set_log_level",
    "REMOTE_BLOCK_DTYPE",
    "FAKE_TOKEN",
]

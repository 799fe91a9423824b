"""Device choice of the port's entry points."""

import torch


def disable_tf32():
    """Keep float32 matmuls in true float32 on the card: the JAX package
    asks for HIGHEST precision on f32 operands, which TF32 would break."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda"):
    """The entry points run on the card unless the caller asks for the
    CPU. Asking for CUDA where there is none raises: the port never
    moves to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        disable_tf32()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device

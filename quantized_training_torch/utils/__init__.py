"""Small helpers shared across the package."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises.

    The entry points default to ``"cuda"``: the plain PyTorch versions of
    the kernels run only when the caller asks for the CPU explicitly.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the serving path runs its kernels on an "
            "NVIDIA GPU; pass device='cpu' to run the plain PyTorch versions")
    return device

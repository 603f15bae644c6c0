"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA card.  A CUDA device without CUDA raises;
    the port never falls back to the CPU unless asked for it.  A CUDA
    device comes back with its index ("cuda" is the current card), so
    that it compares equal to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU with the plain torch versions of its kernels")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

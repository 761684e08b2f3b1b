"""Explicit device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  Asking for CUDA where no GPU is visible
    raises; nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that two names of one card compare equal as memo keys."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(seed: int, device=None) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (``None`` means the GPU):
    the port's initializers draw from it and place tensors on its device."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)

"""The device the caller names ("cuda" by default at every entry point);
nothing here falls back to another."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cpu", "cuda", "cuda:1", a torch.device).

    "cpu" runs every kernel's plain PyTorch version; "cuda" runs the CUDA
    kernels and raises where CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available on this machine")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev

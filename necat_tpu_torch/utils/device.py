"""The devices the caller names ("cuda" by default at every entry point);
nothing here falls back to another."""

from __future__ import annotations

from typing import List

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cpu", "cuda", "cuda:1", a torch.device).

    "cpu" runs every kernel's plain PyTorch version; "cuda" runs the CUDA
    kernels and raises where CUDA is not available or the index names no
    card."""
    try:
        dev = torch.device(device)
    except (RuntimeError, TypeError) as e:       # not a device name
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'") from e
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available on this machine")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise ValueError(f"device {device!r}: this machine has "
                             f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev


def resolve_devices(device) -> List[torch.device]:
    """The devices of `device`: one device, a list or tuple of them, or a
    comma-separated string ("cuda:0,cuda:1"), each checked by resolve_device.
    Repeats are kept (two shards on one card); the devices must be all CPU or
    all CUDA."""
    if isinstance(device, str) and "," in device:
        items = [d.strip() for d in device.split(",")]
    elif isinstance(device, (list, tuple)):
        items = list(device)
    else:
        items = [device]
    if not items:
        raise ValueError("an empty list of devices")
    devs = [resolve_device(d) for d in items]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices {device!r} mix CPU and CUDA")
    return devs

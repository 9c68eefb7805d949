"""The benchmark's span around the fused path's tag scatter: where
consensus/fused.py binds scatter_chunk, the call that the program's own
cns.tag_scatter range wraps (a program without that range is read the same
way). After each call it counts the call; the kernels launched inside the
span are the scatter's device time."""

from __future__ import annotations

TARGET = ("necat_tpu_torch.consensus.fused", "scatter_chunk")


def after(fn, args, kwargs, out, acc: dict) -> None:
    acc["calls"] = acc.get("calls", 0) + 1

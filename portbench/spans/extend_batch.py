"""The benchmark's span around each extension call: where align/engine.py
binds extend_batch. After each call it adds the call's least time (bound.py,
from the call's arguments and its cols output) to a device-side sum, so
that the span adds no wait for the card; the sum is read once, after the
window."""

from __future__ import annotations

import inspect
import os

from portbench import bound

TARGET = ("necat_tpu_torch.align.engine", "extend_batch")


def after(fn, args, kwargs, out, acc: dict) -> None:
    import torch
    a = inspect.signature(fn).bind(*args, **kwargs)
    a.apply_defaults()
    p = a.arguments
    cols = torch.cat([out["left_cols"], out["right_cols"]])
    band = "adaptive" if os.environ.get("NECAT_TPU_NO_PALLAS") else "static"
    nbytes, ops = bound.extend_work(p["qlens"], p["tlens"], p["anchor_q"], p["anchor_t"],
                                    p["W"], p["insb_words"], cols, band)
    least = torch.maximum(nbytes.double() / bound.PEAK_BYTES_S, ops / bound.PEAK_INT_OPS_S)
    acc["least_s"] = least if "least_s" not in acc else acc["least_s"] + least
    acc["calls"] = acc.get("calls", 0) + 1

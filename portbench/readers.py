"""Arithmetic shared by the per-layer metric readers (portbench/metrics/)."""

from __future__ import annotations


def roofline_share(obs: dict, span: str):
    """Percent: the span's calls' summed least time over the device time of
    the kernels launched inside it; None without a call or device time."""
    s = obs.get("spans", {}).get(span)
    if not s or not s["calls"] or s["device_s"] <= 0:
        return None
    return 100.0 * s["least_s"] / s["device_s"]


def scope_share(obs: dict, *names: str):
    """Percent of the window spent in the program's timing scopes `names`
    (host seconds); None when none of them ran."""
    sc = obs.get("scopes", {})
    if not any(n in sc for n in names):
        return None
    return 100.0 * sum(sc.get(n, 0.0) for n in names) / obs["window_s"]


def delta_share(obs: dict):
    """Percent of the window that a counter of seconds grew by; None when it
    did not grow."""
    d = obs.get("delta")
    if not d:
        return None
    return 100.0 * d / obs["window_s"]


def device_idle(obs: dict):
    """Percent of the traced window in which nothing ran on the card."""
    if "busy_s" not in obs:
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"])

"""Tag scatter (consensus/tags.py scatter_chunk, index_add_ in float64): the
device seconds of the kernels launched inside the benchmark's
cns.tag_scatter span over the window, in percent."""

SPAN = "cns.tag_scatter"


def read(obs):
    s = obs.get("spans", {}).get(SPAN)
    if not s or not s["calls"] or s["device_s"] <= 0:
        return None
    return 100.0 * s["device_s"] / obs["window_s"]

"""Rescue ladder (consensus/correct.py _run_waves with the ladder on): the
program's cns.rung_lanes (real lanes dispatched at a band above
band_width) plus cns.replay_lanes (round 0's lanes dispatched a second
time, at their decided band) over ext.real_lanes (every real lane
extended), in percent; None from a program without the counters."""


def read(obs):
    sc = obs.get("scopes", {})
    real = sc.get("ext.real_lanes")
    if "cns.rung_lanes" not in sc and "cns.replay_lanes" not in sc or not real:
        return None
    return 100.0 * (sc.get("cns.rung_lanes", 0.0) + sc.get("cns.replay_lanes", 0.0)) / real

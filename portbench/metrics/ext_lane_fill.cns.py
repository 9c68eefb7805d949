"""Dispatch (align/engine.py plan, consensus/fused.py dispatch_wave): the
program's ext.live_Mcols counter (the summed max(query, window) length of
each chunk's real lanes) over its ext.cell_Mlanes (lanes times the length
tier), in percent: the share of the planned cells that hold work. None from
a program without the counter."""


def read(obs):
    sc = obs.get("scopes", {})
    live, cells = sc.get("ext.live_Mcols"), sc.get("ext.cell_Mlanes")
    if not live or not cells:
        return None
    return 100.0 * live / cells

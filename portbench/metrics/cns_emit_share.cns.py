"""Consensus driver (consensus/correct.py _emit_records): host seconds in the
program's cns.emit_records scope over the window, in percent; None from a
program without the scope."""

from portbench.readers import scope_share


def read(obs):
    return scope_share(obs, "cns.emit_records")

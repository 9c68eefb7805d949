"""Consensus driver (consensus/correct.py, backbone.py): host seconds in the
program's cns.compact scope over the window, in percent."""

from portbench.readers import scope_share


def read(obs):
    return scope_share(obs, "cns.compact")

"""Rescue ladder (consensus/correct.py _ident_ladder, the round-0 replay,
_defer_ladder): host seconds in the program's cns.ident_ladder,
cns.round0_replay and cns.defer_ladder scopes over the window, in percent;
None from a program without the scopes."""

from portbench.readers import scope_share


def read(obs):
    return scope_share(obs, "cns.ident_ladder", "cns.round0_replay", "cns.defer_ladder")

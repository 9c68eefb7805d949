"""Tag scatter (consensus/tags.py): host seconds blocked at the scatter's
device-to-host syncs, the program's cns.scatter_sync scope, over the
window, in percent; None from a program without the scope."""

from portbench.readers import scope_share


def read(obs):
    return scope_share(obs, "cns.scatter_sync")

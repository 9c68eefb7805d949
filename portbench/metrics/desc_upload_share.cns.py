"""Dispatch (consensus/fused.py, align/engine.py): host seconds in the
program's descriptor-upload scopes, cns.fused_desc_up and ext.desc_upload,
over the window, in percent."""

from portbench.readers import scope_share


def read(obs):
    return scope_share(obs, "cns.fused_desc_up", "ext.desc_upload")

"""fsa-style named-option parsing (`--name=value` / `--name value`); the
port's copy of necat_tpu/utils/args.py.

The reference's C++ fsa tools parse their flags with ArgumentParser
(src/fsa/argument_parser.{hpp,cpp}); necat.pl passes the config strings
FSA_OL_FILTER_OPTIONS / FSA_ASSEMBLE_OPTIONS / FSA_CTG_BRIDGE_OPTIONS to them
verbatim (necat.pl:1228-1245, 1374). This module gives our typed option
dataclasses the same surface so reference configs behave identically.
"""

from __future__ import annotations

from typing import Dict

from necat_tpu_torch.utils.logging import logger


def parse_named(s: str) -> Dict[str, str]:
    """Parse `--name=value` / `--name value` tokens into a dict.

    A flag followed by another flag (or end of string) gets value "true"
    (ArgumentParser bool options, argument_parser.cpp)."""
    out: Dict[str, str] = {}
    toks = s.split()
    i = 0
    while i < len(toks):
        t = toks[i]
        if not t.startswith("--"):
            logger.warning("ignoring stray fsa option token %r in %r", t, s)
            i += 1
            continue
        body = t[2:]
        if "=" in body:
            k, _, v = body.partition("=")
            out[k] = v
            i += 1
        elif i + 1 < len(toks) and not toks[i + 1].startswith("--"):
            out[body] = toks[i + 1]
            i += 2
        else:
            out[body] = "true"
            i += 1
    return out


def apply_named(flags: Dict[str, str], mapping: Dict[str, tuple], base,
                label: str):
    """Apply parsed flags onto a dataclass via `mapping` name ->
    (field, type). Unknown names warn LOUDLY (they would silently change
    behavior vs the reference otherwise); returns the replaced dataclass."""
    import dataclasses

    updates = {}
    for k, v in flags.items():
        if k not in mapping:
            logger.warning("%s: option --%s=%s not supported by this "
                           "implementation — IGNORED (behavior may differ "
                           "from the reference)", label, k, v)
            continue
        field, typ = mapping[k]
        if typ is bool:
            updates[field] = v.strip().lower() in ("1", "true", "yes")
        else:
            updates[field] = typ(v)
    return dataclasses.replace(base, **updates)

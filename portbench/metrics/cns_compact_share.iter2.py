"""The reader of cns_compact_share.cns (portbench/metrics/cns_compact_share.cns.py),
on ecoli40x.cns-iter2: the same layer with the rescue ladder on."""

from pathlib import Path

from portbench.harness import load_module

_cns = load_module(Path(__file__).with_name("cns_compact_share.cns.py"))
read = _cns.read

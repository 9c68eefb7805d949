"""The reader of ext_lane_fill.cns (portbench/metrics/ext_lane_fill.cns.py),
on ecoli40x.cns-iter2: the same layer with the rescue ladder on."""

from pathlib import Path

from portbench.harness import load_module

_cns = load_module(Path(__file__).with_name("ext_lane_fill.cns.py"))
read = _cns.read

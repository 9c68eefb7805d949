"""The reader of scatter_device_share.cns (portbench/metrics/scatter_device_share.cns.py),
on ecoli40x.cns-iter2: the same layer with the rescue ladder on."""

from pathlib import Path

from portbench.harness import load_module

_cns = load_module(Path(__file__).with_name("scatter_device_share.cns.py"))
SPAN = _cns.SPAN
read = _cns.read

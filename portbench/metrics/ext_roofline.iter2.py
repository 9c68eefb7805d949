"""The reader of ext_roofline.cns (portbench/metrics/ext_roofline.cns.py),
on ecoli40x.cns-iter2: the same layer with the rescue ladder on."""

from pathlib import Path

from portbench.harness import load_module

_cns = load_module(Path(__file__).with_name("ext_roofline.cns.py"))
SPAN = _cns.SPAN
read = _cns.read

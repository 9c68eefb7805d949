"""Extension (align/banded.py extend_batch -> K1, K3): the least time of the
work each call's pairs need (portbench/bound.py) over the device time of the
kernels launched inside the benchmark's span around the call, in percent."""

from portbench.readers import roofline_share

SPAN = "extend_batch"


def read(obs):
    return roofline_share(obs, SPAN)

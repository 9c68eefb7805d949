"""Device (H100): the share of the traced window in which no kernel, copy or
fill ran on the card (the profiler's device events, their union), in
percent."""

from portbench.readers import device_idle


def read(obs):
    return device_idle(obs)

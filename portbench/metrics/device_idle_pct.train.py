"""The share of the traced window's wall time in which no kernel ran on the
device: one minus the union of the CUDA kernel intervals over the window."""

from portbench.readers import idle_pct


def read(r):
    return idle_pct(r)

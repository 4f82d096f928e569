"""The whole generated batch's share of the card's dense bf16 peak over
the measured window: the reference's model FLOPs of each unit (counted once
a kind on the meta device, recompute never counted) times the units the
window ran, over the window's seconds."""

from portbench.readers import mfu_pct


def read(r):
    return mfu_pct(r)

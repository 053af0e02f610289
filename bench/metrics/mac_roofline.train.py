"""The MAC kernels' share of their roofline in the traced step, %: the
least time of the sealed state the step verifies and tags, over the
kernels' device time."""
from benchlib import readers


def read(ctx: dict):
    return readers.mac_roofline(ctx)

"""The CTR kernel's share of its roofline in the traced step, %: the
least time of the sealed state the step unseals and reseals, over the
kernel's device time."""
from benchlib import readers


def read(ctx: dict):
    return readers.ctr_roofline(ctx)

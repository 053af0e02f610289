"""The CTR kernel's share of its roofline in the traced steps, %: the
least time of the ciphertext the engine's calls put through it, over
the kernel's device time."""
from benchlib import readers


def read(ctx: dict):
    return readers.ctr_roofline(ctx)

"""The MAC kernels' share of their roofline in the traced steps, %: the
least time of the ciphertext the engine's calls verify or tag, over
the kernels' device time."""
from benchlib import readers


def read(ctx: dict):
    return readers.mac_roofline(ctx)

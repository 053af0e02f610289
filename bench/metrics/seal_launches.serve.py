"""CTR and MAC kernel launches per gateway step over the window: the
ops' own ``launches`` counters."""
from benchlib import readers


def read(ctx: dict):
    return readers.seal_launches(ctx)

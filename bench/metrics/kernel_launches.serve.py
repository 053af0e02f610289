"""Device operations per gateway step in the traced steps."""
from benchlib import readers


def read(ctx: dict):
    return readers.kernel_launches(ctx)

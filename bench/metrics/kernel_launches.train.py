"""Device operations per train step in the traced step."""
from benchlib import readers


def read(ctx: dict):
    return readers.kernel_launches(ctx)

"""Share of the traced steps' wall time in which no device operation
ran, %."""
from benchlib import readers


def read(ctx: dict):
    return readers.idle_share(ctx)

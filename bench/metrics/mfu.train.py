"""The whole train step's share of the card's bf16 peak, %: model FLOPs
of the window's tokens (6N a token plus attention) over the seconds of its
untraced steps (the traced one carries the profiler)."""
from benchlib import readers


def read(ctx: dict):
    return readers.mfu(ctx)

"""The whole serving step's share of the card's bf16 peak, %: model FLOPs
of the window's useful prompt and generated tokens (2N a token plus
attention; padding lanes not counted) over the seconds of the window's
untraced steps (the traced ones carry the profiler)."""
from benchlib import readers


def read(ctx: dict):
    return readers.mfu(ctx)

"""Share of the traced steps' wall time in which the device sat idle
outside every engine call (scheduler, gateway bookkeeping, token
emission), %: the gaps between device operations outside the union of
the program's ``engine.*`` spans."""
from benchlib import program_spans


def read(ctx: dict):
    return program_spans.idle_off_engine(ctx)

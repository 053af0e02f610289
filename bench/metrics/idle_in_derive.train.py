"""Share of the traced step's wall time in which the device sat idle while
the host derived a key, %: the gaps between device operations that fall
inside the union of the program's ``seal.derive`` spans."""
from benchlib import program_spans


def read(ctx: dict):
    return program_spans.idle_in_derive(ctx)

"""Host launch calls (kernels, async copies and sets) made inside the key
derivation per train step in the traced step: the profiler's launch
events that start inside the union of the program's ``seal.derive``
spans."""
from benchlib import program_spans


def read(ctx: dict):
    return program_spans.derive_launches(ctx)

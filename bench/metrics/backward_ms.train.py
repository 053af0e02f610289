"""Stream time of the backward passes (every microbatch's gradient) in
the traced train step, ms: the sum of the program span
``train.backward``'s ``device_ms``.

``device_ms`` is the time between two CUDA events recorded on the
current stream at the span's entry and exit, read only while the
profiler records: the stream's time from the span's first operation
to its last, idle inside included (such as the waits for the host's
key derivations).  It is not the kernels' busy time."""
from benchlib import program_spans


def read(ctx: dict):
    return program_spans.device_ms_per_step(ctx, "train.backward")

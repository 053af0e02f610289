"""Time to first token, median, ms: from a request's submit to the end of
the gateway step that emits its first token, over every request whose
first token falls in the window (the harness's clock).  A window holds
some tens of first tokens, so a median stands on each side of it where a
90th percentile would rest on a handful."""
from benchlib import readers


def read(ctx: dict):
    return readers.percentile(ctx.get("ttft_ms", []), 50)

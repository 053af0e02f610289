"""Device-synchronised time of one decode step call, ms: the port's
``Profiler`` phase time, averaged over the window's calls."""


def read(ctx: dict):
    return ctx.get("phase_ms", {}).get("decode")

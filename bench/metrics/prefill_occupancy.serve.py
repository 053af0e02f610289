"""Share of the engine's lanes a prefill chunk filled, %: the gateway's
own ``prefill_chunk_occupancy_pct`` over the window."""


def read(ctx: dict):
    v = ctx.get("prefill_occupancy_pct")
    return v if v else None

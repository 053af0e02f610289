"""Device time of the fused causal attention's forward kernel per gateway
step in the traced steps, ms: ``flash_attn_fwd_kernel`` of
``csrc/flash_attention.cu`` in every layer of every prefill chunk (decode
steps take the plain path), summed over the traced stretch and divided by
its steps.  None where the program runs no such kernel."""
NEEDLES = ("flash_attn_fwd_kernel",)


def read(ctx: dict):
    tr = ctx["trace"]
    if not tr.steps or not tr.device:
        return None
    seconds = tr.kernel_seconds(*NEEDLES)
    return 1e3 * seconds / tr.steps if seconds > 0 else None

"""Device time of the fused causal attention's kernels per train step in
the traced step, ms: the forward, D, dK/dV and dQ kernels of
``csrc/flash_attention.cu`` (every layer's forward, its recompute under
the full remat, and its backward, over both microbatches), summed over
the traced stretch and divided by its steps.  None where the program runs
no such kernel."""
NEEDLES = ("flash_attn_fwd_kernel", "flash_attn_dot_kernel",
           "flash_attn_dkdv_kernel", "flash_attn_dq_kernel")


def read(ctx: dict):
    tr = ctx["trace"]
    if not tr.steps or not tr.device:
        return None
    seconds = tr.kernel_seconds(*NEEDLES)
    return 1e3 * seconds / tr.steps if seconds > 0 else None

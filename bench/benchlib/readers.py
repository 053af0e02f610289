"""Arithmetic the per-layer metric files share.  Each reader takes the
run's layer context (what the driver counted, and ``trace``, the traced
stretch) and returns a number, or None where it finds nothing to read."""
from __future__ import annotations

from . import yardstick

CTR_KERNELS = ("ctr_xor_kernel",)
MAC_KERNELS = ("mac_small_kernel", "mac_wide_kernel", "mac_general_kernel")


def roofline_pct(ctx: dict, needles: tuple, bound_s: float):
    """The least time over the named kernels' device time in the traced
    stretch, in percent."""
    dev = ctx["trace"].kernel_seconds(*needles)
    if dev <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / dev


def ctr_roofline(ctx: dict):
    b = ctx.get("traced_bytes", {}).get("ctr", 0)
    return roofline_pct(ctx, CTR_KERNELS, yardstick.ctr_bound_s(b))


def mac_roofline(ctx: dict):
    b = ctx.get("traced_bytes", {}).get("mac", 0)
    return roofline_pct(ctx, MAC_KERNELS, yardstick.mac_bound_s(b))


def mfu(ctx: dict):
    """Useful model FLOPs of the window's untraced steps over their
    seconds, against bf16 dense on the tensor cores."""
    if not ctx.get("flops") or ctx.get("flops_s", 0) <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["flops_s"] / \
        yardstick.BF16_FLOPS_PER_S


def idle_share(ctx: dict):
    tr = ctx["trace"]
    if tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def kernel_launches(ctx: dict):
    tr = ctx["trace"]
    if not tr.steps or not tr.device:
        return None
    return tr.launches() / tr.steps


def seal_launches(ctx: dict):
    n = ctx.get("seal_launches_per_step")
    return n if n else None


def percentile(values: list, q: float):
    """Nearest-rank percentile (q in (0, 100]); None for no values."""
    if not values:
        return None
    v = sorted(values)
    k = max(0, -(-len(v) * q // 100) - 1)
    return v[int(k)]

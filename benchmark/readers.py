"""What the per-layer readers (``metrics/<name>.py``) share: each takes the
run's context and returns a number, or None where its run has nothing for
it to read (no trace, no such kernel)."""

from __future__ import annotations

from typing import Optional, Sequence

import counts

FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_", "split_bf16x3_kernel")
K1_KERNELS = ("fused_decode_kernel",)


def kernel_seconds(ctx, names: Sequence[str]) -> float:
    """Device seconds of the traced kernels whose name holds one of
    ``names``."""
    return sum(d for n, _, d in ctx.trace.kernels() if any(k in n for k in names)) / 1e9


def roofline(ctx, bound_key: str, names: Sequence[str]) -> Optional[float]:
    """The work's bound over the kernels' device time, in %."""
    if ctx.trace is None or not ctx.work.get(bound_key):
        return None
    t = kernel_seconds(ctx, names)
    return 100.0 * ctx.work[bound_key] / t if t > 0 else None


def mfu(ctx, seconds: Optional[float]) -> Optional[float]:
    """Model FLOPs over ``seconds`` at the peak of the configuration's dtype
    (``counts.PEAK_FLOPS``: 989 TFLOP/s bf16, 495 float32), in %."""
    if not ctx.work.get("model_flops") or not seconds:
        return None
    return 100.0 * ctx.work["model_flops"] / (seconds * counts.PEAK_FLOPS[ctx.cfg["dtype"]])


def idle(ctx) -> Optional[float]:
    """The traced window's share with no device operation running, in %."""
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)

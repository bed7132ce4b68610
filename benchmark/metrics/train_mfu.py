"""Model FLOPs of the traced window's training steps (non-PAD positions,
forward and backward) over the window x the dtype's peak (989 TFLOP/s bf16,
495 float32), in %."""

import readers


def read(ctx):
    return readers.mfu(ctx, ctx.work.get("window_s"))

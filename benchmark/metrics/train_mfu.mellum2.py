"""Model FLOPs of the traced window's training steps (non-PAD positions,
forward and backward, the routed experts only: 8 of 64) over the window x
the bf16 peak (989 TFLOP/s), in % (``counts_mellum2.train_step_flops``)."""

import readers


def read(ctx):
    return readers.mfu(ctx, ctx.work.get("window_s"))

"""Model FLOPs of the traced backlog (encode and decode of every row) over
the window x 989 TFLOP/s bf16, in %."""

import readers


def read(ctx):
    return readers.mfu(ctx, ctx.work.get("window_s"))

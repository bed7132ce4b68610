"""Device kernels in the traced window over the training steps it ran."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("steps") or not ctx.trace.kernels():
        return None
    return len(ctx.trace.kernels()) / ctx.work["steps"]

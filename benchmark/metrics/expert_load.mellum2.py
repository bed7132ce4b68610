"""The experts' load over the window's steps: non-PAD positions routed to
the busiest expert over the mean of the 64, in the worst of the 4 layers
(``MoE.load``, counted on the device inside the captured steps)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.work.get("expert_load")

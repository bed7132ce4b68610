"""Host microseconds a step the trainer's thread waits for the prefetch
queue (the program's ``prefetch.wait`` span: the queue's get and the wait
on the copy's event) over the traced window."""

import program_spans


def read(ctx):
    return program_spans.us_per(ctx, ("prefetch.wait",), ctx.work.get("steps"))

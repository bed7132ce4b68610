"""Host microseconds a step in the prefetch thread's ``prefetch.stage`` span
(a batch to int64, pinned, copied to the card on the side stream) over the
traced window. The span times the producer thread's occupancy, its waits
included: for the interpreter's lock and for the card's launch queue, which
the trainer's replays fill. So it reads far more than the staging work alone
where the trainer keeps the host busy; what the step feels of the feed is
``prefetch_wait_us.train``."""

import program_spans


def read(ctx):
    return program_spans.us_per(ctx, ("prefetch.stage",), ctx.work.get("steps"))

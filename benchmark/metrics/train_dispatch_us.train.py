"""Host microseconds a step in the program's ``train.dispatch`` span
(``Trainer.train_batches``: the static buffers' copies, the graph's replay
call, the counters) over the traced window."""

import program_spans


def read(ctx):
    return program_spans.us_per(ctx, ("train.dispatch",), ctx.work.get("steps"))

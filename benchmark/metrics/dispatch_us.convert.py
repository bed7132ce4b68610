"""Host microseconds a file in the program's ``service.dispatch`` span
(``StyleTransferService._dispatch``: the batch and its copy to the card,
the encoder's launches, K1's host side) over the traced window."""

import program_spans


def read(ctx):
    return program_spans.us_per(ctx, ("service.dispatch",), ctx.attempted)

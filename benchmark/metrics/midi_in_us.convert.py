"""Host microseconds a file in the program's request tokenizing (its
``service.tokenize`` span, one a call of ``inference.service.
tokens_from_midi``) over the traced window. A program without that span
gives nothing to read."""

import program_spans


def read(ctx):
    return program_spans.us_per(ctx, ("service.tokenize",), ctx.attempted)

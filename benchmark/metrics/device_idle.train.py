"""The share of the traced window with no device operation running, in %."""

import readers


def read(ctx):
    return readers.idle(ctx)

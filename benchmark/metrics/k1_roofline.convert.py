"""K1 in the traced window: its bound from the decode steps each row ran
(operations and bytes from the decoder's shapes) over its device time, in %."""

import readers


def read(ctx):
    return readers.roofline(ctx, "k1_bound_s", readers.K1_KERNELS)

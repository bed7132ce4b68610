"""K4/K5 in the traced training steps of the Mellum2 cell: their bound
(``counts_mellum2.flash_bound_s``: the pairs that the window, causality and
the key lengths leave, K/V bytes at 4 heads read once) over the flash
kernels' device time, in %."""

import readers


def read(ctx):
    return readers.roofline(ctx, "flash_bound_s", readers.FLASH_KERNELS)

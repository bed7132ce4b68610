"""K4/K5 (and the float32 split) in the traced training steps: their bound
from shapes and key lengths over their device time, in %."""

import readers


def read(ctx):
    return readers.roofline(ctx, "flash_bound_s", readers.FLASH_KERNELS)

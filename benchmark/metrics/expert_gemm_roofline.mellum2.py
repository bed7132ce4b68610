"""The experts' grouped products (``torch._grouped_mm`` forward, and its
backward's two: the rows' and the weights' gradients) in the traced steps
of the Mellum2 cell: their bound (``counts_mellum2.expert_gemm_bound_s``,
the larger of FLOPs at 989 TFLOP/s and bytes at 3.35 TB/s) over their
kernels' device time, in %. The kernels are CUTLASS's grouped GEMMs on the
H100, found by these pieces of their names."""

import readers

EXPERT_KERNELS = ("GroupProblemShape",)


def read(ctx):
    return readers.roofline(ctx, "expert_gemm_bound_s", EXPERT_KERNELS)

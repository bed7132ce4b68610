"""What the Adam tests on the CPU (``test_torch_fused_adam.py``) and on the
card (``test_torch_gpu.py``) share: the settings they cross, bit-for-bit
equality, and a pair of optimizers over the same parameters, one on the
kernel route and one on the chain."""

import torch

from musicstyletransfer_torch.training.optimizer import Optimizer, OptimizerConfig

# the extras the kernel takes, crossed with adam/adamw and skip_nonfinite
EXTRAS = {"clip_gradient": "clip_gradient:1.0", "clip_global_norm": "clip_global_norm:1.0",
          "wd": "wd:0.1", "none": ""}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (float32: NaN where NaN)."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32),
                                                            b[~nan].view(torch.int32))


def adam_pair(init: torch.Tensor, name: str, extras: str):
    """Two optimizers over copies of ``init``: the kernel route (the route
    a CUDA buffer takes by itself; set by hand on the CPU) and the chain."""
    kern, chain = (Optimizer([torch.nn.Parameter(init.clone())],
                             OptimizerConfig(name, extras, 1e-2)) for _ in range(2))
    assert kern.route == ("kernel" if init.is_cuda else "chain")
    kern.route, chain.route = "kernel", "chain"
    return kern, chain


def assert_same_state(a: Optimizer, b: Optimizer, what) -> None:
    """Parameters and every state buffer bit for bit."""
    assert bits_equal(a.flat, b.flat), what
    for k in a.state:
        assert bits_equal(a.state[k], b.state[k]), (what, k)

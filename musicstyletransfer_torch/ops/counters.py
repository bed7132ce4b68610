"""The launch counters of the hand kernels (K1-K5 in PERF.md, the split
of float32 inputs for K4/K5's tensor-core route, and Adam's update).

Each wrapper adds one to its counter where it launches its kernel, and
each plain version adds one where it runs on a CUDA tensor; K4/K5 count
apart their launches with a window and with grouped K/V heads. "adam" counts
the launches of Adam's update kernel, "adam stats" the calls of the
gradient's reduction pass before it, and "adam plain" the optimizer steps
that ran its torch chain on CUDA buffers instead. They are host
counters: a CUDA graph that captured launches runs no Python when it is
replayed, so ``training/graph.py`` records the counts a capture added and
adds them again at every replay (``add``).
"""

from __future__ import annotations

from typing import Dict

from . import attention_core as ac
from . import flash_attention as fa
from . import fused_adam
from . import fused_decode as fd

# name -> (the function that carries the counter, its attribute)
COUNTERS = {
    "K1": (fd.fused_decode, "launches"),
    "K2": (ac.core_forward, "launches"),
    "K3": (ac.core_backward, "launches"),
    "K4": (fa.flash_forward, "launches"),
    "K5": (fa.flash_backward, "launches"),
    "K2 tc": (ac.core_forward, "tc_launches"),
    "K3 tc": (ac.core_backward, "tc_launches"),
    "K4 tc": (fa.flash_forward, "tc_launches"),
    "K5 tc": (fa.flash_backward, "tc_launches"),
    "K4 windowed": (fa.flash_forward, "windowed_launches"),
    "K5 windowed": (fa.flash_backward, "windowed_launches"),
    "K4 grouped": (fa.flash_forward, "grouped_launches"),
    "K5 grouped": (fa.flash_backward, "grouped_launches"),
    "split": (fa.split_bf16x3, "launches"),
    "K1 plain": (fd.fused_decode_reference, "cuda_runs"),
    "K2 plain": (ac.core_forward_reference, "cuda_runs"),
    "K3 plain": (ac.core_backward_reference, "cuda_runs"),
    "XLA-backward twin": (ac.core_xla_backward, "cuda_runs"),
    "K4 plain": (fa.flash_forward_reference, "cuda_runs"),
    "K5 plain": (fa.flash_backward_reference, "cuda_runs"),
    "split plain": (fa.split_bf16x3_reference, "cuda_runs"),
    "adam": (fused_adam.adam_update, "launches"),
    "adam stats": (fused_adam.grad_stats, "launches"),
    "adam plain": (fused_adam.adam_update, "chain_cuda_runs"),
}
PLAIN = ("K1 plain", "K2 plain", "K3 plain", "XLA-backward twin", "K4 plain", "K5 plain",
         "split plain", "adam plain")


def read() -> Dict[str, int]:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def write(values: Dict[str, int]) -> None:
    for k, v in values.items():
        fn, attr = COUNTERS[k]
        setattr(fn, attr, v)


def add(delta: Dict[str, int]) -> None:
    write({k: v + delta[k] for k, v in read().items()})


def reset() -> None:
    write({k: 0 for k in COUNTERS})

"""N training steps as one CUDA graph: the port's counterpart of the JAX
package's ``_scan_of`` and ``run_multi`` (``musicstyletransfer_tpu/training/
train_step.py:170-190, 268-290``), which run N steps as one program.

``GraphedSteps`` captures ``step_body`` n times in a row over static input
buffers [N, B, L+1] and replays the capture once per group of n batches, so
the host issues one launch for the n steps instead of ~800 a step. A replay
does what n eager ``step_body`` calls from the same state do:

- the parameters, the optimizer's state and the ``TrainState`` (step count,
  metric sums) are tensors that every step updates in place, and the graph
  reads and writes them where they are;
- dropout and the reparameterisation draw from the trainer's CUDA
  ``torch.Generator``, registered with every graph
  (``CUDAGraph.register_generator_state``): each replay draws the next
  numbers of the same Philox stream the eager steps would draw;
- the capture needs warm-up steps (they build the kernels' libraries and
  cuBLAS' workspaces); they run on the live state, which is then put back,
  generator included, so they count for nothing;
- the hand kernels' launch counters are host counters (``ops.counters``):
  the counts a capture adds are taken back and added again at every
  replay.

One graph per group length (the steps per dispatch, and an epoch's shorter
remainder), captured at its first use and sharing one memory pool. A
capture that fails raises; nothing falls back to eager steps.
``GraphedSteps.captures`` and ``.replays`` count captures and replays over
all instances.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..ops import counters
from .train_step import LossConfig, TrainState, step_body

WARMUP_STEPS = 2


class GraphedSteps:
    """Groups of up to ``max_steps`` training steps of ``model`` as CUDA
    graph replays; ``run`` takes the group's (tokens, seq_lens, classes,
    labels) device tensors."""

    captures = 0
    replays = 0

    def __init__(self, model, optimizer, loss_config: LossConfig, state: TrainState,
                 generator: torch.Generator, max_steps: int):
        self.model = model
        self.optimizer = optimizer
        self.loss_config = loss_config
        self.state = state
        self.generator = generator
        self.max_steps = max_steps
        self.inputs: List[torch.Tensor] = []  # [max_steps, ...] static buffers
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, Dict[str, int]]] = {}
        self.pool = torch.cuda.graph_pool_handle()

    def _tensors(self) -> List[torch.Tensor]:
        """Every tensor a step updates in place."""
        return [self.optimizer.flat, *self.optimizer.state.values(),
                self.state.step, self.state.sums, self.state.counts]

    def _body(self, i: int) -> None:
        step_body(self.model, self.optimizer, self.loss_config, self.state,
                  *(buf[i] for buf in self.inputs), generator=self.generator)

    def _capture(self, n: int) -> Tuple[torch.cuda.CUDAGraph, Dict[str, int]]:
        torch.cuda.synchronize()
        saved = [t.clone() for t in self._tensors()]
        rng = self.generator.get_state()
        before = counters.read()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._body(0)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip(self._tensors(), saved):
                t.copy_(v)
        self.generator.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        mark = counters.read()
        # thread_local: the prefetching thread may copy the next batches meanwhile
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            for i in range(n):
                self._body(i)
        delta = {k: v - mark[k] for k, v in counters.read().items()}
        counters.write(before)
        return graph, delta

    def run(self, group: Sequence[Sequence[torch.Tensor]]) -> None:
        """Run len(group) steps, one per batch, as one replay."""
        n = len(group)
        if not 1 <= n <= self.max_steps:
            raise ValueError(f"a group of {n} steps; the buffers hold 1 to {self.max_steps}")
        if not self.inputs:
            self.inputs = [torch.empty((self.max_steps, *x.shape), dtype=x.dtype, device=x.device)
                           for x in group[0]]
        for i, batch in enumerate(group):
            for buf, x in zip(self.inputs, batch):
                if x.shape != buf.shape[1:]:
                    raise ValueError(f"a batch of shape {tuple(x.shape)} in buffers of "
                                     f"{tuple(buf.shape[1:])}")
                buf[i].copy_(x, non_blocking=True)
        if n not in self.graphs:
            self.graphs[n] = self._capture(n)
            GraphedSteps.captures += 1
        graph, delta = self.graphs[n]
        graph.replay()
        GraphedSteps.replays += 1
        counters.add(delta)
        self.optimizer.params_changed()  # the replay ran no Python

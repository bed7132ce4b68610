"""N training steps as one CUDA graph: the port's counterpart of the JAX
package's ``_scan_of`` and ``run_multi`` (``musicstyletransfer_tpu/training/
train_step.py:170-190, 268-290``), which run N steps as one program.

``GraphedGroups`` captures a group of steps over static input buffers
[N, ...] and replays the capture once per group of batches, so the host
issues one launch for the group instead of hundreds a step. A replay does
what the same eager steps from the same state do:

- the parameters, the optimizers' state and every other tensor the steps
  update (the metric sums, the step count) are updated in place, and the
  graph reads and writes them where they are;
- dropout, the reparameterisation and the GAN's noise draw from one CUDA
  ``torch.Generator``, registered with every graph
  (``CUDAGraph.register_generator_state``): each replay draws the next
  numbers of the same Philox stream the eager steps would draw;
- the capture needs warm-up steps (they build the kernels' libraries and
  cuBLAS' workspaces); they run on the live state, which is then put back,
  generator included, so they count for nothing;
- the hand kernels' launch counters are host counters (``ops.counters``):
  the counts a capture adds are taken back and added again at every
  replay.

One graph per key, captured at its first use, all sharing one memory pool.
``GraphedSteps`` is the VAE's: n ``step_body`` calls, one graph per group
length (the steps per dispatch, and an epoch's shorter remainder);
``training/gan_trainer.GraphedGANGroups`` is the GAN's, one graph per
pattern of D and G steps. A capture that fails raises; nothing falls back
to eager steps. Each class's ``captures`` and ``replays`` count its
captures and replays over all its instances.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import torch

from .. import tracing
from ..ops import counters
from .train_step import LossConfig, TrainState, step_body

WARMUP_STEPS = 2


class GraphedGroups:
    """Groups of up to ``max_steps`` batches as CUDA graph replays.
    ``body(inputs, key)`` runs the group ``key`` names on the static buffers
    ``inputs`` (one [max_steps, ...] tensor per input of a batch, batch i at
    index i); ``tensors()`` lists every tensor it updates in place; the
    ``optimizers`` are told after each replay that their parameters changed;
    the warm-ups run the group ``warmup_key``."""

    captures = 0
    replays = 0

    def __init__(self, body: Callable[[List[torch.Tensor], Hashable], None],
                 tensors: Callable[[], List[torch.Tensor]], optimizers: Sequence,
                 generator: torch.Generator, max_steps: int, warmup_key: Hashable):
        self.body = body
        self.tensors = tensors
        self.optimizers = list(optimizers)
        self.generator = generator
        self.max_steps = max_steps
        self.warmup_key = warmup_key
        self.inputs: List[torch.Tensor] = []  # [max_steps, ...] static buffers
        self.graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, Dict[str, int]]] = {}
        self.pool = torch.cuda.graph_pool_handle()

    def _capture(self, key: Hashable) -> Tuple[torch.cuda.CUDAGraph, Dict[str, int]]:
        torch.cuda.synchronize()
        saved = [t.clone() for t in self.tensors()]
        rng = self.generator.get_state()
        before = counters.read()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.body(self.inputs, self.warmup_key)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip(self.tensors(), saved):
                t.copy_(v)
        self.generator.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        mark = counters.read()
        # thread_local: the prefetching thread may copy the next batches meanwhile
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            self.body(self.inputs, key)
        delta = {k: v - mark[k] for k, v in counters.read().items()}
        counters.write(before)
        return graph, delta

    def run(self, group: Sequence[Sequence[torch.Tensor]], key: Hashable) -> None:
        """Copy the group's batches into the buffers and replay ``key``'s
        graph (captured at its first use)."""
        n = len(group)
        if not 1 <= n <= self.max_steps:
            raise ValueError(f"a group of {n} steps; the buffers hold 1 to {self.max_steps}")
        with tracing.span("graph.copy_in"):
            if not self.inputs:
                self.inputs = [torch.empty((self.max_steps, *x.shape), dtype=x.dtype,
                                           device=x.device) for x in group[0]]
            for i, batch in enumerate(group):
                for buf, x in zip(self.inputs, batch):
                    if x.shape != buf.shape[1:]:
                        raise ValueError(f"a batch of shape {tuple(x.shape)} in buffers of "
                                         f"{tuple(buf.shape[1:])}")
                    buf[i].copy_(x, non_blocking=True)
        cls = type(self)
        if key not in self.graphs:
            with tracing.span("graph.capture"):
                self.graphs[key] = self._capture(key)
            cls.captures += 1
        graph, delta = self.graphs[key]
        with tracing.span("graph.replay"):
            graph.replay()
        cls.replays += 1
        with tracing.span("graph.after"):
            counters.add(delta)
            for opt in self.optimizers:
                opt.params_changed()  # the replay ran no Python


class GraphedSteps(GraphedGroups):
    """Groups of up to ``max_steps`` training steps of ``model`` as CUDA
    graph replays, one graph per group length; ``run`` takes the group's
    (tokens, seq_lens, classes, labels) device tensors."""

    def __init__(self, model, optimizer, loss_config: LossConfig, state: TrainState,
                 generator: torch.Generator, max_steps: int):
        def body(inputs: List[torch.Tensor], n: int) -> None:
            for i in range(n):
                step_body(model, optimizer, loss_config, state, *(buf[i] for buf in inputs),
                          generator=generator)

        def tensors() -> List[torch.Tensor]:
            return [optimizer.flat, *optimizer.state.values(), state.step, state.sums,
                    state.counts]

        super().__init__(body, tensors, [optimizer], generator, max_steps, warmup_key=1)

    def run(self, group: Sequence[Sequence[torch.Tensor]]) -> None:
        """Run len(group) steps, one per batch, as one replay."""
        super().run(group, len(group))

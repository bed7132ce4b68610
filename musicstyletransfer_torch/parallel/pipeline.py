"""Pipeline parallelism (GPipe) over a mesh's model axis (counterpart of
``musicstyletransfer_tpu/parallel/pipeline.py``).

A stack of S identical stages lies one stage a rank along the model axis;
x is cut into M microbatches that stream through the stages, activations
hopping one rank forward between ticks. M + S - 1 ticks: at tick t, stage 0
takes microbatch t, every other stage the activation that just hopped in,
and the last stage's result is microbatch t - (S - 1)'s output. At the end
the last stage's outputs go to every rank of the model group, so the result
is replicated, as the JAX package's psum of one-hot-masked outputs makes it.

Activations are a tensor or a tuple of tensors sharing the leading batch
axis: side inputs that travel with their microbatch (the key mask) ride
along as extra elements that ``stage_fn`` passes through. ``stage_fn`` must
keep the shapes and dtypes of what it is given, as the JAX package's scan
carry must.

The per-rank schedule is written once (``_stage_steps``, a generator that
yields the activation to hop and receives the one that hopped in), as the
ring attention's step code is (``ops/ring_attention.py``), and driven two
ways:

- ``pipeline_apply``, one rank of a world: each hop is ``_Hop``, an
  autograd function whose forward is ``Mesh.rotate_model`` and whose
  backward is the reverse rotation of the cotangents (ppermute's
  transpose). A scalar "anchor" threads every hop of a rank, and the final
  broadcast, into one chain, so that each rank's backward runs its hops in
  the reverse order of the forward, every one of them, whether or not the
  activation it delivered was used: every rank takes part in every hop both
  ways. The anchor depends on x and the stage parameters, so that
  ``torch.autograd.grad`` asked of any of them (it runs only what leads to
  them) still runs every hop; a gradient asked only of tensors that
  ``stage_fn`` closes over is not covered (``backward()`` is). The
  broadcast's backward hands the last stage its own cotangent once (every
  rank backpropagates the same replicated loss; an all-reduce there would
  make the gradients S times too large).
- ``pipeline_apply_lockstep``: the S stages in one process, a hop being list
  indexing; autograd runs through it as it is (the card check of
  ``chip_smoke.py`` and the CPU tests).

A stage in a bubble tick (before its first microbatch or after its last)
is skipped and hops zeros; the JAX package computes it on garbage and masks
the result. Gradients stay where they arise: on rank s those of stage s's
parameters (the other stages' slices get zeros), and stage 0's for x.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..ops.ring_attention import _drive, _drive_lockstep

Activation = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
StageFn = Callable[[Dict[str, torch.Tensor], Activation], Activation]


def _as_tuple(x: Activation) -> Tuple[torch.Tensor, ...]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _split(x: Activation, microbatches: int) -> Tuple[bool, List[Tuple[torch.Tensor, ...]]]:
    """(whether x was a bare tensor, its M microbatch tuples), checking the
    JAX contract: a shared leading batch axis that M divides."""
    leaves = _as_tuple(x)
    if not leaves:
        raise ValueError("x has no tensors")
    B = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != B:
            raise ValueError(f"x's tensors do not share the batch axis: {leaf.shape} vs B={B}")
    if microbatches < 1 or B % microbatches:
        raise ValueError(f"a batch of {B} rows does not split into {microbatches} microbatches")
    parts = [leaf.chunk(microbatches, 0) for leaf in leaves]
    return not isinstance(x, (tuple, list)), [tuple(p[m] for p in parts)
                                              for m in range(microbatches)]


def _check_stage_params(stage_params: Mapping[str, torch.Tensor], n_stages: int) -> None:
    for name, p in stage_params.items():
        if p.shape[0] != n_stages:
            raise ValueError(f"stage_params leading axis {p.shape[0]} ({name}) != pipe axis "
                             f"{n_stages}")


def _stage_steps(stage_fn: StageFn, params: Mapping[str, torch.Tensor],
                 x_mb: Sequence[Tuple[torch.Tensor, ...]], bare: bool, idx: int, n: int):
    """Stage ``idx`` of ``n``'s ticks; yields the activation tuple to hop
    after every tick but the last and receives the one that hopped in.
    Returns the last stage's M output tuples (None on the other stages). A
    single stage hops nothing."""
    M = len(x_mb)
    idle = tuple(torch.zeros_like(leaf) for leaf in x_mb[0])
    acts = idle
    outs: List[Tuple[torch.Tensor, ...]] = []
    for t in range(M + n - 1):
        m = t - idx
        if 0 <= m < M:
            h_in = x_mb[m] if idx == 0 else acts
            h = _as_tuple(stage_fn(params, h_in[0] if bare else h_in))
            if [(y.shape, y.dtype) for y in h] != [(y.shape, y.dtype) for y in h_in]:
                raise ValueError("stage_fn must keep the shapes and dtypes of its input: "
                                 f"{[(tuple(y.shape), y.dtype) for y in h_in]} -> "
                                 f"{[(tuple(y.shape), y.dtype) for y in h]}")
            if idx == n - 1:
                outs.append(h)
        else:
            h = idle
        if n > 1 and t < M + n - 2:
            acts = yield h
    return outs if idx == n - 1 else None


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it travels: bool as uint8 (the backends move bytes)."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


class _Hop(torch.autograd.Function):
    """One hop forward (``rotate(tensors, 1)``); backward, the cotangents of
    the floating tensors rotate back (``rotate(g, -1)``). The anchor goes
    through so that the hops of a rank form one chain."""

    @staticmethod
    def forward(ctx, rotate, anchor, *tensors):
        ctx.rotate = rotate
        ctx.floating = [t.is_floating_point() for t in tensors]
        received = [_unwire(r, t.dtype) for r, t in
                    zip(rotate([_wire(t) for t in tensors], 1), tensors)]
        ctx.mark_non_differentiable(*[r for r, f in zip(received, ctx.floating) if not f])
        return (anchor.clone(), *received)

    @staticmethod
    def backward(ctx, g_anchor, *grads):
        back = iter(ctx.rotate([g.contiguous() for g, f in zip(grads, ctx.floating) if f], -1))
        return (None, g_anchor, *(next(back) if f else None for f in ctx.floating))


class _FromLast(torch.autograd.Function):
    """The last stage's outputs broadcast over the model group; backward,
    the last stage keeps its own cotangent and the others drop theirs."""

    @staticmethod
    def forward(ctx, mesh, anchor, *tensors):
        last = mesh.tp - 1
        src = mesh.data_rank * mesh.tp + last
        ctx.last = mesh.model_rank == last
        ctx.device = anchor.device
        outs = []
        for t in tensors:
            buf = t.detach().clone().contiguous()
            dist.broadcast(_wire(buf), src=src, group=mesh.model_group)
            outs.append(buf)
        ctx.mark_non_differentiable(*[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, torch.zeros((), dtype=torch.float32, device=ctx.device),
                *(g if ctx.last else None for g in grads))


def _join(outs: Sequence[Tuple[torch.Tensor, ...]], bare: bool) -> Activation:
    cat = tuple(torch.cat(parts, 0) for parts in zip(*outs))
    return cat[0] if bare else cat


def _anchor(x: Activation, stage_params: Mapping[str, torch.Tensor],
            device: torch.device) -> torch.Tensor:
    """The head of a rank's hop chain: a float32 zero that, with grad
    enabled, depends on every input that requires grad (0 * one element of
    each). ``torch.autograd.grad`` runs only the nodes that lead to an input
    it is asked about; through the anchor every hop leads to all of them, so
    a gradient asked of x or of stage_params runs every hop's backward on
    every rank (without it a rank whose first hop carried only zeros would
    skip that hop's backward and its neighbour would wait for it)."""
    anchor = torch.zeros((), dtype=torch.float32, device=device)
    if not torch.is_grad_enabled():
        return anchor
    deps = [t for t in (*_as_tuple(x), *stage_params.values()) if t.requires_grad]
    if not deps:
        return anchor.requires_grad_()
    return anchor + sum(t.reshape(-1)[0].float() * 0 for t in deps)


def pipeline_apply(stage_fn: StageFn, stage_params: Mapping[str, torch.Tensor], x: Activation,
                   *, mesh, microbatches: int) -> Activation:
    """Run ``x`` through S = ``mesh.tp`` chained stages pipelined over the
    mesh's model axis, this rank being stage ``mesh.model_rank``.

    ``stage_fn(params_s, h) -> h'`` applies one stage and keeps the shapes
    and dtypes of h; ``stage_params`` maps names to tensors stacked on a
    leading stage axis of size S, of which this rank uses slice
    [model_rank]. ``x``: a tensor or a tuple of tensors sharing the leading
    batch axis B, B % microbatches == 0. Returns
    stage_{S-1}(...stage_0(x)) with x's structure on every rank of the
    model group; every rank of it must call, with the same shapes."""
    n = mesh.tp
    _check_stage_params(stage_params, n)
    bare, x_mb = _split(x, microbatches)
    params = {k: v[mesh.model_rank] for k, v in stage_params.items()}
    anchor = _anchor(x, stage_params, x_mb[0][0].device)

    def hop(tensors):
        nonlocal anchor
        anchor, *received = _Hop.apply(mesh.rotate_model, anchor, *tensors)
        return received

    outs = _drive(_stage_steps(stage_fn, params, x_mb, bare, mesh.model_rank, n), hop)
    if outs is None:  # the broadcast's buffers: x's shapes and dtypes
        outs = [tuple(torch.zeros_like(leaf) for leaf in mb) for mb in x_mb]
    result = _FromLast.apply(mesh, anchor, *_join(outs, False))
    return result[0] if bare else result


def pipeline_apply_lockstep(stage_fn: StageFn, stage_params: Mapping[str, torch.Tensor],
                            x: Activation, n_stages: int, microbatches: int) -> Activation:
    """``pipeline_apply`` with the ``n_stages`` stages in this process,
    every stage's tick before the next hop, a hop being list indexing
    (stage s receives stage s - 1's activation). Differentiable as it is."""
    _check_stage_params(stage_params, n_stages)
    bare, x_mb = _split(x, microbatches)
    results = _drive_lockstep([
        _stage_steps(stage_fn, {k: v[s] for k, v in stage_params.items()}, x_mb, bare, s,
                     n_stages) for s in range(n_stages)])
    return _join(results[-1], bare)


def sequential_apply(stage_fn: StageFn, stage_params: Mapping[str, torch.Tensor],
                     x: Activation, n_stages: int) -> Activation:
    """The stages one after another on the whole batch: what the pipeline
    computes."""
    for s in range(n_stages):
        x = stage_fn({k: v[s] for k, v in stage_params.items()}, x)
    return x

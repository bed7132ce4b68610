"""A pipelined ``TransformerStack``: the adapter between the port's stack
and ``pipeline.py``'s stacked-stage contract (counterpart of
``musicstyletransfer_tpu/parallel/transformer_pipeline.py``).

- ``stack_stage_params``: the N layers' tensors of a stack's state_dict
  (``layers.{i}.<name>``) grouped into S stages of K = N/S consecutive
  layers and stacked to [S, K, ...] under the layer's own names
  (``attention.w_q.weight``); differentiable (``torch.stack``), so the
  stack's parameters receive the gradients.
- ``transformer_stage_fn``: one stage, its K layers applied in turn with
  ``torch.func.functional_call`` over the stacked slice, deterministic (no
  dropout); the key mask passes through with its microbatch.
- ``pipeline_transformer_stack``: ``TransformerStack.forward`` (sqrt(d)
  scaling and the positional table, the layers, the final LayerNorm under
  pre-LN) with the layers pipelined.

A stage runs under ``use_mesh(None)``: the pipe axis is the mesh's model
axis while every stage's weights are whole, so no layer may read the mesh
(ring attention, the time scatter, the core's tp rule, the TP collectives
of ``Dense``/``FeedForward``). With no mesh the attention dispatch is the
one-device one: the attention core (K2/K3) at 256 <= T < 1024 where the
configuration enables it, the flash route (K4/K5) at T >= flash_min_seq_len.

A stage gives back its input's dtype: under post-LN in bfloat16 a layer
returns the compute dtype while the stack's input is float32, so the value
a stage hands on is cast back (exactly) to float32 and the next stage's
first residual sum runs in float32 where the sequential stack rounds it to
bfloat16 (under pre-LN, and in float32, nothing changes).

Unlike the JAX adapter, which leaves it out (VERDICT.md weak #6), the final
LayerNorm of a pre-LN stack is applied: the result equals
``TransformerStack.forward``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch
from torch.func import functional_call

from .mesh import use_mesh
from .pipeline import pipeline_apply, pipeline_apply_lockstep

_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


def stack_stage_params(stack_state: Mapping[str, torch.Tensor],
                       n_stages: int) -> Dict[str, torch.Tensor]:
    """``{layers.{i}.<name>: tensor}`` (a ``TransformerStack``'s state_dict
    or named parameters; other keys are ignored) -> ``{<name>: [S, K, ...]}``
    with S = ``n_stages`` stages of K = N/S consecutive layers."""
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, value in stack_state.items():
        m = _LAYER.match(key)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = value
    n_layers = len(layers)
    if not n_layers or sorted(layers) != list(range(n_layers)):
        raise ValueError(f"no layers.0..layers.{{N-1}} in the stack's state: {sorted(layers)}")
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} equal stages")
    k = n_layers // n_stages
    return {name: torch.stack([torch.stack([layers[s * k + j][name] for j in range(k)])
                               for s in range(n_stages)])
            for name in layers[0]}


def transformer_stage_fn(layer: torch.nn.Module):
    """stage_fn for ``pipeline_apply``: params ``{<name>: [K, ...]}`` = K
    stacked layers of ``layer``'s kind, activations ``(h [mb, T, D],
    key_mask [mb, T])``; returns ``(h', key_mask)``."""

    def stage(params_k: Mapping[str, torch.Tensor], carry):
        h, key_mask = carry
        dtype = h.dtype
        training = layer.training
        layer.eval()
        try:
            with use_mesh(None):
                for j in range(next(iter(params_k.values())).shape[0]):
                    h = functional_call(layer, {n: p[j] for n, p in params_k.items()},
                                        (h, key_mask))
        finally:
            layer.train(training)
        return h.to(dtype), key_mask

    return stage


def pipeline_transformer_stack(stack: torch.nn.Module, x: torch.Tensor, key_mask: torch.Tensor,
                               *, mesh, microbatches: int,
                               n_stages: Optional[int] = None) -> torch.Tensor:
    """``stack.forward(x, key_mask)`` in evaluation mode (no dropout, no
    remat, no sequence sharding) with its N layers pipelined in S stages of
    N/S layers: over ``mesh``'s model axis (S = mesh.tp, this rank stage
    model_rank), or with ``mesh`` None in this process in lock step over
    ``n_stages``. x: [B, T, D] (before scaling); key_mask: [B, T] True at
    valid keys."""
    if mesh is None and n_stages is None:
        raise ValueError("pipeline_transformer_stack needs a mesh or n_stages")
    S = mesh.tp if mesh is not None else n_stages
    params = stack_stage_params(dict(stack.named_parameters()), S)
    h = stack.scale * x + stack.pos_table[: x.shape[1]]
    stage = transformer_stage_fn(stack.layers[0])
    if mesh is None:
        out, _ = pipeline_apply_lockstep(stage, params, (h, key_mask), S, microbatches)
    else:
        out, _ = pipeline_apply(stage, params, (h, key_mask), mesh=mesh,
                                microbatches=microbatches)
    if stack.config.norm_scheme == "pre":
        out = stack.final_ln(out)
    return out

"""A dropless mixture of SwiGLU experts with a top-k softmax router.

``MoE`` maps x [..., D] to sum over the k experts a position is routed to of
w_e * Down_e(silu(Gate_e x) * Up_e x): the router is softmax(x Wr) over the
experts in float32, its top k kept and renormalised to sum 1 (Hugging
Face's ``norm_topk_prob``). Every position goes to its k experts (nothing is
dropped, no capacity), and nothing depends on the data's shape on the host:

- ``moe.route``: the router's logits, softmax and top k;
- ``moe.permute``: the (position, expert) pairs sorted by expert (a stable
  sort, so a position's pairs keep their order), the experts' end offsets
  in that order (``searchsorted`` on the device), the inverse permutation,
  x gathered in it;
- ``moe.experts``: two grouped products over the sorted rows,
  [rows, D] x [E, D, 2F] (gate and up side by side) and [rows, F] x
  [E, F, D], each expert's rows against its own weights
  (``torch._grouped_mm`` with the offsets on the device for CUDA tensors, a
  loop over the experts on the CPU);
- ``moe.combine``: the outputs put back in the pairs' order and summed over
  each position's k experts with the router's weights (rounded to the
  compute dtype), one batched product with float32 sums.

So a CUDA graph captures the layer whole, and ``training/graph.py``
replays it. The spans are host spans: they record in eager runs and while a
graph is captured. ``load`` [E] (int64, a buffer) counts the non-PAD
positions routed to each expert in training mode, added on the device
inside the step (and inside a graph), read by the caller when it likes.

Both gathers are ``GatherRows``: an ``index_select`` whose backward gathers
by the inverse permutation, where ``index_select``'s own backward is an
``index_add_`` (an atomic add an element on a card). The combine's backward
is a gather into the sorted order; the dispatch's a gather back into the
pairs' order and a sum of each position's k rows (float32 sums of the
compute-dtype terms, rounded once). So the layer's backward adds in a fixed
order and repeats bit for bit.

Parameters: ``router`` (a bias-free ``Dense``, flax ``router/kernel``),
``w_gate_up`` [E, D, 2F] and ``w_down`` [E, F, D] kept as they are (in, out).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing


def _gmm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows offs[e-1]:offs[e] of a [M, K] times b[e] [K, N]: [M, N]."""
    if a.is_cuda:
        return torch._grouped_mm(a, b, offs=offs)
    out, start = a.new_zeros(a.shape[0], b.shape[-1]), 0
    for e, end in enumerate(offs.tolist()):
        out[start:end] = a[start:end] @ b[e]
        start = end
    return out


def _gmm_weight_grad(a: torch.Tensor, dy: torch.Tensor, offs: torch.Tensor,
                     experts: int) -> torch.Tensor:
    """[E, K, N]: for each expert, its rows of a [M, K] transposed times its
    rows of dy [M, N] (zeros for an expert with no rows)."""
    if a.is_cuda:
        return torch._grouped_mm(a.t(), dy, offs=offs)
    out, start = a.new_zeros(experts, a.shape[1], dy.shape[1]), 0
    for e, end in enumerate(offs.tolist()):
        out[e] = a[start:end].t() @ dy[start:end]
        start = end
    return out


class GroupedMM(torch.autograd.Function):
    """y = a_e b_e over each expert's rows, differentiable in a and b."""

    @staticmethod
    def forward(ctx, a, b, offs):
        ctx.save_for_backward(a, b, offs)
        return _gmm(a, b, offs)

    @staticmethod
    def backward(ctx, dy):
        a, b, offs = ctx.saved_tensors
        dy = dy.contiguous()
        da = _gmm(dy, b.transpose(1, 2), offs)
        db = _gmm_weight_grad(a, dy, offs, b.shape[0])
        return da, db, None


class GatherRows(torch.autograd.Function):
    """``src.index_select(0, index)``, where each row of src is taken k times
    and ``inverse[r * k + j]`` is where its j-th take went
    (``index[inverse] == arange(len(src)).repeat_interleave(k)``): the
    backward gathers dy by ``inverse`` and sums each row's k terms."""

    @staticmethod
    def forward(ctx, src, index, inverse, k: int):
        ctx.save_for_backward(inverse)
        ctx.k = k
        return src.index_select(0, index)

    @staticmethod
    def backward(ctx, dy):
        (inverse,) = ctx.saved_tensors
        dsrc = dy.index_select(0, inverse)
        if ctx.k > 1:
            dsrc = dsrc.view(-1, ctx.k, dsrc.shape[-1]).sum(1)
        return dsrc, None, None, None


def load_counters(model: nn.Module) -> list:
    """The ``load`` buffers of ``model``'s expert layers (state a training
    step updates beside the optimizer's)."""
    return [m.load for m in model.modules() if isinstance(m, MoE)]


class MoE(nn.Module):
    """Dropless top-k mixture of SwiGLU experts (module docstring)."""

    def __init__(self, model_size: int, expert_width: int, num_experts: int, top_k: int,
                 dtype: torch.dtype):
        super().__init__()
        from .transformer import Dense

        self.num_experts, self.top_k, self.width = num_experts, top_k, expert_width
        self.compute_dtype = dtype
        self.router = Dense(model_size, num_experts, torch.float32, bias=False)
        self.w_gate_up = nn.Parameter(torch.empty(num_experts, model_size, 2 * expert_width))
        self.w_down = nn.Parameter(torch.empty(num_experts, expert_width, model_size))
        self.register_buffer("load", torch.zeros(num_experts, dtype=torch.int64),
                             persistent=False)

    def route(self, x: torch.Tensor):
        """(weights [N, k] float32, experts [N, k] int64) of rows x [N, D]."""
        probs = torch.softmax(self.router(x.float()), dim=-1)
        weights, experts = probs.topk(self.top_k, dim=-1)
        return weights / weights.sum(-1, keepdim=True), experts

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [..., D] -> [..., D] in the compute dtype; ``key_mask`` [...]
        (True at non-PAD positions) picks the positions ``load`` counts."""
        dt, k, E = self.compute_dtype, self.top_k, self.num_experts
        shape = x.shape
        xf = x.reshape(-1, shape[-1])
        with tracing.span("moe.route"):
            weights, experts = self.route(xf)
        with tracing.span("moe.permute"):
            flat = experts.reshape(-1)
            sorted_experts, order = torch.sort(flat, stable=True)
            offs = torch.searchsorted(sorted_experts, torch.arange(E, device=x.device),
                                      right=True).to(torch.int32)
            back = torch.empty_like(order).scatter_(0, order, torch.arange(
                order.numel(), device=x.device))
            rows = GatherRows.apply(xf.to(dt), order // k, back, k)
            if self.training and key_mask is not None:
                with torch.no_grad():
                    self.load.index_add_(0, flat, key_mask.reshape(-1, 1).expand(-1, k)
                                         .reshape(-1).to(torch.int64))
        with tracing.span("moe.experts"):
            h = GroupedMM.apply(rows, self.w_gate_up.to(dt), offs)
            gate, up = h.chunk(2, dim=-1)
            y = GroupedMM.apply(F.silu(gate) * up, self.w_down.to(dt), offs)
        with tracing.span("moe.combine"):
            y = GatherRows.apply(y, back, order, 1).view(-1, k, shape[-1])
            # [N, 1, k] x [N, k, D]: float32 sums of the compute-dtype terms
            out = torch.bmm(weights.to(dt)[:, None, :], y)[:, 0]
        return out.reshape(shape)

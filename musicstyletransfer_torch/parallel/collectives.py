"""The conjugate collectives of tensor and sequence parallelism, as
``torch.autograd.Function``s over a mesh's model group.

Tensor parallelism (Megatron's pair, one all-reduce per block each way, as
the JAX package's GSPMD layout of ``_TP_RULES`` gives):

- ``copy_to_model`` sits in front of the column-parallel projections
  (w_q|w_k|w_v, ff1): identity forward, the all-reduce of the input's
  gradient backward (each rank's heads or columns contribute a part);
- ``reduce_from_model`` follows the row-parallel ones (w_o, ff2): the
  all-reduce of the partial products forward (summed in float32), identity
  backward.

Sequence parallelism (ring attention, the model axis carrying time):

- ``scatter_seq``: this rank's time chunk of a tensor every rank holds whole
  (padded to the ring); backward, the all-gather of the chunks' gradients,
  so the whole tensor's gradient is complete on every rank;
- ``gather_seq``: the all-gather of every rank's chunk, the padding sliced
  off; backward, this rank's chunk of the gradient (every rank computes the
  same gradient downstream of a gather).
"""

from __future__ import annotations

import torch

from .mesh import Mesh, SeqShard


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.mesh.all_reduce_model_sum_(g)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.float().contiguous()
        if y.data_ptr() == x.data_ptr():
            y = y.clone()
        mesh.all_reduce_model_sum_(y)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, mesh, dim):
        ctx.config = (seq, mesh, dim)
        return seq.local(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        seq, mesh, dim = ctx.config
        full = mesh.all_gather_model(g, dim)
        return full.narrow(dim, 0, seq.length), None, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, mesh, dim):
        ctx.config = (seq, mesh, dim)
        return mesh.all_gather_model(x, dim).narrow(dim, 0, seq.length).contiguous()

    @staticmethod
    def backward(ctx, g):
        seq, mesh, dim = ctx.config
        return seq.local(g, dim).contiguous(), None, None, None


def _needs(mesh) -> Mesh:
    if mesh is None:
        raise ValueError("a layer sharded by parallel.mesh.shard_model runs under "
                         "parallel.mesh.use_mesh(its mesh)")
    return mesh


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, _needs(mesh))


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, _needs(mesh))


def scatter_seq(x: torch.Tensor, seq: SeqShard, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    return _ScatterSeq.apply(x, seq, mesh, dim)


def gather_seq(x: torch.Tensor, seq: SeqShard, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    return _GatherSeq.apply(x, seq, mesh, dim)

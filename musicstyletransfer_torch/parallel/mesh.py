"""The (data, model) mesh over one ``torch.distributed`` world and its
tensor-parallel rules (counterpart of ``musicstyletransfer_tpu/parallel/mesh.py``).

One process per card. The world's ranks form a dp x tp grid with
rank = d * tp + m, as ``make_mesh`` reshapes the devices to (n // tp, tp)
(``mesh.py:48-60`` of the JAX package):

- axis "data": the ranks of one model index m hold the same parameters and
  different rows of each global batch; the data group averages their
  gradients;
- axis "model": the ranks of one data index d see the same rows. Under
  tensor parallelism each holds 1/tp of every layer's heads and FFN hidden
  columns (Megatron's layout, the JAX ``_TP_RULES``); under ring attention
  the axis carries time instead, every parameter is whole on every rank, and
  each rank runs the stacks on its chunk of the time axis
  (``models/transformer.py``, ``ops/ring_attention.py``).

Collectives are explicit ``torch.distributed`` calls (NCCL on CUDA, gloo on
the CPU): nothing here falls back to a single process, and a failed
collective raises. The model code reads the mesh of ``use_mesh`` through
``current_mesh``, as the JAX package's does at trace time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's chunk of a time axis of ``length`` positions, padded to a
    multiple of the ring ``n`` (the encoder's L+1 and the decoder's L+2
    cannot both divide it); chunk ``index`` holds positions
    [index * chunk, (index + 1) * chunk)."""

    length: int
    n: int
    index: int

    @property
    def padded(self) -> int:
        return -(-self.length // self.n) * self.n

    @property
    def chunk(self) -> int:
        return self.padded // self.n

    def pad(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``x`` with ``dim`` (of size ``length``) padded with zeros (False)
        to ``padded``."""
        extra = self.padded - self.length
        if extra == 0:
            return x
        shape = list(x.shape)
        shape[dim] = extra
        return torch.cat([x, x.new_zeros(shape)], dim)

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's chunk of ``x`` (of ``length`` positions along ``dim``)."""
        return self.pad(x, dim).narrow(dim, self.index * self.chunk, self.chunk)


class Mesh:
    """The dp x tp grid over the initialised world: this rank's coordinates
    (``data_rank``, ``model_rank``), its data group (the ranks of its model
    index) and its model group (the ranks of its data index)."""

    def __init__(self, tp: int, device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs torch.distributed initialised "
                               "(parallel.distributed.initialize_distributed)")
        world, rank = dist.get_world_size(), dist.get_rank()
        if tp < 1 or world % tp:
            raise ValueError(f"{world} processes not divisible by tp={tp}")
        dp = world // tp
        self.shape = {AXIS_DATA: dp, AXIS_MODEL: tp}
        self.rank, self.world = rank, world
        self.data_rank, self.model_rank = divmod(rank, tp)
        self.device = torch.device(device)
        # Every rank creates every group, in one order (new_group's rule).
        for d in range(dp):
            group = dist.new_group([d * tp + m for m in range(tp)])
            if d == self.data_rank:
                self.model_group = group
        for m in range(tp):
            group = dist.new_group([d * tp + m for d in range(dp)])
            if m == self.model_rank:
                self.data_group = group

    @property
    def dp(self) -> int:
        return self.shape[AXIS_DATA]

    @property
    def tp(self) -> int:
        return self.shape[AXIS_MODEL]

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"Mesh(data={self.dp}, model={self.tp}, rank={self.rank} = "
                f"({self.data_rank}, {self.model_rank}), device={self.device})")

    # ---- collectives -------------------------------------------------

    def all_reduce_data_mean_(self, x: torch.Tensor) -> torch.Tensor:
        """In place: the mean of ``x`` over the data group (issued at dp = 1
        too, where it leaves the bits as they are)."""
        dist.all_reduce(x, group=self.data_group)
        return x.div_(self.dp)

    def all_reduce_data_sum_(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.data_group)
        return x

    def all_reduce_model_sum_(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.model_group)
        return x

    def all_gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's ``x`` concatenated along ``dim`` in model order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        dist.all_gather(parts, x, group=self.model_group)
        return torch.cat(parts, dim)

    def rotate_model(self, tensors: Sequence[torch.Tensor],
                     shift: int = 1) -> Tuple[torch.Tensor, ...]:
        """One hop of the model group's ring: each tensor goes to model rank
        m + shift and this rank receives model rank m - shift's (``ppermute``
        with the JAX ring's ``_ring_perm``; shift -1 is its transpose)."""
        base = self.data_rank * self.tp
        nxt = base + (self.model_rank + shift) % self.tp
        prv = base + (self.model_rank - shift) % self.tp
        ops, received = [], []
        for x in tensors:
            x = x.contiguous()
            buf = torch.empty_like(x)
            ops.append(dist.P2POp(dist.isend, x, nxt, self.model_group))
            ops.append(dist.P2POp(dist.irecv, buf, prv, self.model_group))
            received.append(buf)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(received)

    def draw(self, fn, shape: Sequence[int], generator, device, seq: Optional[SeqShard] = None,
             cols: bool = False) -> torch.Tensor:
        """``fn(global shape)`` (``torch.rand`` or ``torch.randn``) cut to this
        rank's block of ``shape``: its rows of the global batch (dim 0), its
        time chunk under ``seq`` (dim 1, drawn at ``seq.length``) and, with
        ``cols``, its columns of the last dim. Every rank draws the same
        numbers, and one process on the global batch draws them too, so a
        data-parallel run keeps the single process's dropout masks."""
        full = list(shape)
        full[0] *= self.dp
        if seq is not None:
            full[1] = seq.length
        if cols:
            full[-1] *= self.tp
        x = fn(full, generator=generator, device=device)
        x = x.narrow(0, self.data_rank * shape[0], shape[0])
        if seq is not None:
            x = seq.local(x, 1)
        if cols:
            x = x.narrow(-1, self.model_rank * shape[-1], shape[-1])
        return x


def default_device(backend: str) -> torch.device:
    """A mesh's device when none is given, from its world's backend: this
    process's card on NCCL (``initialize_distributed`` made it current), the
    CPU on gloo."""
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"no mesh device for the {backend!r} backend")


def make_mesh(tp: int = 1, device: Optional[torch.device] = None) -> Mesh:
    """The (data, model) mesh of the world with ``tp``-way model axis; the
    rest of the ranks form the data axis. Raises when tp does not divide the
    world (``make_mesh``'s assert). ``device`` None follows the world's
    backend (``default_device``)."""
    if device is None:
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs torch.distributed initialised "
                               "(parallel.distributed.initialize_distributed)")
        device = default_device(dist.get_backend())
    return Mesh(tp, device)


def mesh_device(mesh: Optional[Mesh], device: Optional[torch.device]) -> torch.device:
    """An entry point's device: the given one, else the mesh's, else CUDA
    (raising without a card, ``utils.resolve_device``); a given device must
    be the mesh's."""
    if mesh is None:
        if device is not None:
            return torch.device(device)
        from ..utils import resolve_device

        return resolve_device()
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


_MESH = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the one ``current_mesh`` returns in this thread."""
    prev = getattr(_MESH, "mesh", None)
    _MESH.mesh = mesh
    try:
        yield mesh
    finally:
        _MESH.mesh = prev


def current_mesh() -> Optional[Mesh]:
    return getattr(_MESH, "mesh", None)


# ---- tensor-parallel rules ------------------------------------------------

# The JAX package's _TP_RULES (mesh.py:75-81) on nn.Linear's [out, in]
# weights: column-parallel w_q|w_k|w_v|ff1 shard the output dim (weight
# dim 0) and the bias; row-parallel w_o|ff2 shard the input dim (weight dim
# 1) and keep the bias whole, added once after the all-reduce. Everything
# else is replicated.
_TP_RULES = (
    (re.compile(r"(w_q|w_k|w_v|ff1)\.(weight|bias)$"), 0),
    (re.compile(r"(w_o|ff2)\.weight$"), 1),
)


def param_spec(name: str) -> Optional[int]:
    """The dim of parameter ``name`` (a state_dict key) that the model axis
    shards, or None for a replicated one."""
    for pattern, dim in _TP_RULES:
        if pattern.search(name):
            return dim
    return None


def shard_dims(shapes: Mapping[str, Sequence[int]], tp: int) -> Dict[str, Optional[int]]:
    """``param_spec`` of each parameter, replicated where the model axis
    does not divide the dim (``param_shardings``, ``mesh.py:98-108``)."""
    out = {}
    for name, shape in shapes.items():
        dim = param_spec(name)
        if dim is not None and (tp <= 1 or dim >= len(shape) or shape[dim] % tp):
            dim = None
        out[name] = dim
    return out


def _local(x: torch.Tensor, dim: Optional[int], tp: int, index: int) -> torch.Tensor:
    if dim is None:
        return x
    size = x.shape[dim] // tp
    return x.narrow(dim, index * size, size)


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh,
                 dims: Optional[Mapping[str, Optional[int]]] = None) -> Dict[str, torch.Tensor]:
    """This rank's slices of full parameters (``dims`` as ``shard_dims``
    gives them unless passed). ``mesh`` needs only ``tp`` and
    ``model_rank``."""
    if dims is None:
        dims = shard_dims({k: v.shape for k, v in state_dict.items()}, mesh.tp)
    return {k: _local(v, dims[k], mesh.tp, mesh.model_rank).clone()
            for k, v in state_dict.items()}


def shard_batch(batch_tensors: Sequence[torch.Tensor], mesh) -> Tuple[torch.Tensor, ...]:
    """This rank's rows of global batch tensors (leading batch axis)."""
    out = []
    for x in batch_tensors:
        rows = x.shape[0] // mesh.dp
        if rows * mesh.dp != x.shape[0]:
            raise ValueError(f"a batch of {x.shape[0]} rows over {mesh.dp} data ranks")
        out.append(x.narrow(0, mesh.data_rank * rows, rows))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ParamShard:
    """Where one parameter of a sharded model lives: its full shape, the
    dim the model axis (of size ``tp``) shards (None: whole on every rank)
    and whether its gradient is a partial sum over the model group (the
    stacks' parameters under sequence sharding, each rank seeing its time
    chunk)."""

    name: str
    shape: Tuple[int, ...]
    dim: Optional[int]
    tp: int = 1
    partial: bool = False

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def local_numel(self) -> int:
        return self.numel if self.dim is None else self.numel // self.tp


def shard_model(model: torch.nn.Module, mesh: Mesh) -> List[ParamShard]:
    """Shard ``model`` (whole, the same on every rank) in place onto
    ``mesh`` and return the layout of its parameters in
    ``model.parameters()`` order.

    Under ring attention on a model axis > 1 the axis carries time: no
    parameter is sliced, and the stacks' parameters are marked partial.
    Otherwise the TP rules apply, per attention module only where its heads
    divide by tp (the heads of w_q|w_k|w_v are sliced whole), as the JAX
    ``_core_eligible`` requires of ``attention_core_tp``."""
    from ..models.transformer import MultiHeadSelfAttention, TransformerStack

    tp = mesh.tp
    named = dict(model.named_parameters())
    ring = tp > 1 and any(isinstance(m, TransformerStack) and m.config.ring_attention
                          for m in model.modules())
    partial = set()
    if ring:
        dims = {name: None for name in named}
        partial = {id(p) for m in model.modules() if isinstance(m, TransformerStack)
                   for p in m.parameters()}
    else:
        dims = shard_dims({k: tuple(v.shape) for k, v in named.items()}, tp)
        for mod_name, m in model.named_modules():
            if isinstance(m, MultiHeadSelfAttention) and m.num_heads % tp:
                for w in ("w_q", "w_k", "w_v", "w_o"):
                    for leaf in ("weight", "bias"):
                        dims[f"{mod_name}.{w}.{leaf}"] = None
    layout = []
    with torch.no_grad():
        for mod_name, m in model.named_modules():
            for leaf, p in list(m.named_parameters(recurse=False)):
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                dim = dims[name]
                if dim is not None:
                    setattr(m, leaf, torch.nn.Parameter(
                        _local(p.detach(), dim, tp, mesh.model_rank).clone()))
    for name, p in model.named_parameters():
        dim = dims[name]
        full = list(p.shape)
        if dim is not None:
            full[dim] *= tp
        layout.append(ParamShard(name, tuple(full), dim, tp, id(p) in partial))
    return layout


def shard_flat(full: torch.Tensor, layout: Sequence[ParamShard], mesh) -> torch.Tensor:
    """This rank's flat vector (the optimizer's layout) from a full one."""
    pieces, offset = [], 0
    for s in layout:
        x = full[offset:offset + s.numel].view(s.shape)
        pieces.append(_local(x, s.dim, mesh.tp, mesh.model_rank).reshape(-1))
        offset += s.numel
    if offset != full.numel():
        raise ValueError(f"{full.numel()} values for a layout of {offset}")
    return torch.cat(pieces)


def gather_flat(local: torch.Tensor, layout: Sequence[ParamShard], mesh: Mesh) -> torch.Tensor:
    """The full flat vector from every model rank's ``local`` one (a
    collective over the model group; whole parameters are taken as they
    are)."""
    pieces, offset = [], 0
    for s in layout:
        n = s.local_numel
        x = local[offset:offset + n]
        if s.dim is None:
            pieces.append(x)
        else:
            shape = list(s.shape)
            shape[s.dim] //= mesh.tp
            pieces.append(mesh.all_gather_model(x.view(shape), s.dim).reshape(-1))
        offset += n
    return torch.cat(pieces)


class FlatSync:
    """The optimizer's collectives under a mesh, over its flat float32
    buffers: the gradient's reduction (partial sums over the model group,
    then the mean over the data group), the global sum of squares (sharded
    entries summed over the model group, whole ones counted once) and one
    non-finite decision for every rank."""

    def __init__(self, mesh: Mesh, layout: Sequence[ParamShard], device):
        self.mesh = mesh
        self.layout = list(layout)
        sizes = [s.local_numel for s in self.layout]
        self.ranges = []  # contiguous (start, stop) of the partial parameters
        offset = 0
        for s, n in zip(self.layout, sizes):
            if s.partial:
                if self.ranges and self.ranges[-1][1] == offset:
                    self.ranges[-1] = (self.ranges[-1][0], offset + n)
                else:
                    self.ranges.append((offset, offset + n))
            offset += n
        self.sharded = any(s.dim is not None for s in self.layout)
        self.mask = torch.cat([torch.full((n,), float(s.dim is not None), device=device)
                               for s, n in zip(self.layout, sizes)]) if self.sharded else None
        self.param_mask = torch.tensor([float(s.dim is not None) for s in self.layout],
                                       device=device)

    def reduce_(self, grad: torch.Tensor) -> None:
        for lo, hi in self.ranges:
            self.mesh.all_reduce_model_sum_(grad[lo:hi])
        self.mesh.all_reduce_data_mean_(grad)

    def sq_sum(self, u: torch.Tensor) -> torch.Tensor:
        sq = u * u
        if not self.sharded:
            return torch.sum(sq)
        sharded = torch.sum(sq * self.mask)
        self.mesh.all_reduce_model_sum_(sharded)
        return torch.sum(sq * (1.0 - self.mask)) + sharded

    def param_sq_sums(self, sq: torch.Tensor) -> torch.Tensor:
        """Per-parameter sums of squares [P] made global."""
        if not self.sharded:
            return sq
        sharded = sq * self.param_mask
        self.mesh.all_reduce_model_sum_(sharded)
        return sq * (1.0 - self.param_mask) + sharded

    def all_finite(self, finite: torch.Tensor) -> torch.Tensor:
        if not self.sharded:
            return finite
        bad = (~finite).to(torch.float32).reshape(1)
        self.mesh.all_reduce_model_sum_(bad)
        return bad[0] == 0

"""K2 / K3: softmax attention over the interleaved QKV projection.

Replaces ``musicstyletransfer_tpu/ops/attention_core.py``: K2 is
``_core_forward`` (Pallas kernel ``_core_fwd_kernel``), K3 is
``_core_backward`` (``_core_bwd_kernel``). ``core_forward_reference`` and
``core_backward_reference`` below are the kernels' plain PyTorch versions.
``core_forward`` / ``core_backward`` launch the kernels for CUDA tensors and
take the plain versions only for CPU tensors; they never fall back from one
to the other. ``attention_core`` binds the two through one
``torch.autograd.Function``.

Two sources hold the kernels, and the wrappers choose between them by dtype
and head dimension alone, before the launch (``core_route``): bfloat16 at
head dimension 32 or 64 (every core launch of the wide recipe) goes to the
core's entry points of ``csrc/flash_attention_tc.cu``, which run the
tensor-core flash kernels' device code on the core's layout, read as
strided [B, H, T, hd] heads; float32, and the other head dimensions, go to
``csrc/attention_core.cu`` (CUDA-core float32 FMA). The tensor-core route
needs 16-byte aligned rows, which a contiguous qkv at head dimension 32 or
64 has when its base address is 16-byte aligned; the wrapper raises on
anything else and never falls back. ``launches`` counts every launch of a
wrapper, ``tc_launches`` those of the tensor-core route.

The layout is the JAX package's: ``qkv`` [B, T, H*3*hd] with column group
h = [q_h | k_h | v_h] (``interleave_qkv_weights`` permutes the projection's
weight columns into it), ``key_lens`` [B] prefix key counts, the context
[B, T, H*hd] in the qkv dtype and the logsumexp ``lse`` [B, H, T, 1] in
float32. Keys at or past ``key_lens`` are masked, and so are later keys
under ``causal``; a query row with no key left gives zeros and the lse
sentinel -1e30.

Rounding points, as in the Pallas kernels: q * sm_scale rounded to the qkv
dtype; scores in float32; p rounded to the v dtype before P.V; o / max(l,
1e-30); the backward all in float32, P recomputed from lse. The tensor-core
backward keeps float32 sums, softmax and scale but rounds P and dS to bf16
before its second products, as K5's does (``flash_attention``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

_NEG_INF = -1e30
# The resident-score design of the JAX kernel caps its window; the port's
# dispatch keeps the same window (models/transformer.py).
MAX_CORE_SEQ_LEN = 1024
_HEAD_DIMS = (8, 16, 32, 64, 128)
_TC_HEAD_DIMS = (32, 64)  # head dimensions of the tensor-core kernels (bfloat16 only)


def interleave_qkv_weights(wq, bq, wk, bk, wv, bv, num_heads: int, head_dim: int):
    """Separate Q/K/V projections in flax's [in, out] layout -> the kernel's
    per-head-interleaved layout: output column group h is [q_h | k_h | v_h].
    Returns (w [D, H*3*hd], b [H*3*hd])."""
    D = wq.shape[0]
    H, hd = num_heads, head_dim
    w = torch.stack([wq.reshape(D, H, hd), wk.reshape(D, H, hd),
                     wv.reshape(D, H, hd)], dim=2).reshape(D, H * 3 * hd)
    b = torch.stack([bq.reshape(H, hd), bk.reshape(H, hd),
                     bv.reshape(H, hd)], dim=1).reshape(H * 3 * hd)
    return w, b


def default_scale(qkv: torch.Tensor, num_heads: int) -> float:
    return 1.0 / math.sqrt(qkv.shape[-1] // (3 * num_heads))


def _split(qkv: torch.Tensor, num_heads: int):
    B, T, W = qkv.shape
    x = qkv.reshape(B, T, num_heads, 3, W // (3 * num_heads))
    return x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]  # [B, T, H, hd] each


def head_views(qkv: torch.Tensor, num_heads: int):
    """q, k, v as strided [B, H, T, hd] views of ``qkv`` (no copy): the
    layout in which the tensor-core route reads them. The same views of a
    dqkv buffer are where it writes dq, dk and dv."""
    return tuple(x.transpose(1, 2) for x in _split(qkv, num_heads))


def _mask(key_lens: torch.Tensor, T: int, causal: bool) -> torch.Tensor:
    """[B, 1, Tq, Tk] True where query q may attend to key k."""
    pos = torch.arange(T, device=key_lens.device)
    mask = (pos[None, None, None, :] < key_lens.long()[:, None, None, None])
    if causal:
        mask = mask & (pos[None, None, None, :] <= pos[None, None, :, None])
    return mask


# ----------------------------------------------------------------------------
# The plain PyTorch versions


def core_forward_reference(qkv: torch.Tensor, key_lens: torch.Tensor, num_heads: int,
                           causal: bool, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function, whole [T, T] score tile at once: (ctx [B, T, H*hd] in
    the qkv dtype, lse [B, H, T, 1] float32)."""
    if qkv.is_cuda:
        core_forward_reference.cuda_runs += 1
    B, T, _ = qkv.shape
    q, k, v = _split(qkv, num_heads)
    q = q * torch.tensor(sm_scale, dtype=qkv.dtype)  # rounded in the qkv dtype
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    mask = _mask(key_lens, T, causal)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)  # [B, H, T, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    ctx = (o / l.permute(0, 2, 1, 3)).to(qkv.dtype)
    return ctx.reshape(B, T, -1), m + torch.log(l)


core_forward_reference.cuda_runs = 0


def _backward_math(qkv, key_lens, lse, out, g, num_heads, causal, sm_scale):
    """dqkv by recomputing P from lse, all in float32 (``_core_bwd_kernel``
    and ``_core_xla_backward`` compute the same)."""
    B, T, W = qkv.shape
    H = num_heads
    hd = W // (3 * H)
    q, k, v = (x.float() for x in _split(qkv, H))
    q = q * sm_scale  # pre-scaled: dk needs no further scale
    do = g.reshape(B, T, H, hd).float()
    o = out.reshape(B, T, H, hd).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    mask = _mask(key_lens, T, causal) & (lse > -1e29)  # fully masked rows
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    delta = (do * o).sum(-1)  # [B, T, H]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return torch.stack([dq, dk, dv], dim=3).reshape(B, T, W).to(qkv.dtype)


def core_backward_reference(qkv, key_lens, lse, out, g, num_heads: int, causal: bool,
                            sm_scale: float) -> torch.Tensor:
    """K3's function: dqkv [B, T, H*3*hd] in the qkv dtype."""
    if qkv.is_cuda:
        core_backward_reference.cuda_runs += 1
    return _backward_math(qkv, key_lens, lse, out, g, num_heads, causal, sm_scale)


core_backward_reference.cuda_runs = 0


def core_xla_backward(qkv, key_lens, lse, out, g, num_heads: int, causal: bool,
                      sm_scale: float) -> torch.Tensor:
    """Twin of the JAX package's ``_core_xla_backward``, the backward that
    ``attention_core_xla_backward`` selects instead of K3. Plain PyTorch on
    every device (it is a route of its own, not a kernel's plain version)."""
    if qkv.is_cuda:
        core_xla_backward.cuda_runs += 1
    return _backward_math(qkv, key_lens, lse, out, g, num_heads, causal, sm_scale)


core_xla_backward.cuda_runs = 0

# ----------------------------------------------------------------------------
# The kernels


class _Args(ctypes.Structure):
    """Mirror of ``MstCoreArgs`` in csrc/attention_core_args.cuh."""

    _fields_ = [
        ("qkv", ctypes.c_void_p), ("key_lens", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("lse", ctypes.c_void_p),
        ("dout", ctypes.c_void_p), ("delta", ctypes.c_void_p),
        ("dqkv", ctypes.c_void_p),
        ("B", ctypes.c_int), ("T", ctypes.c_int), ("H", ctypes.c_int),
        ("HD", ctypes.c_int), ("causal", ctypes.c_int), ("is_bf16", ctypes.c_int),
        ("fwd_scale", ctypes.c_float), ("bwd_scale", ctypes.c_float),
    ]


# route -> (source in csrc/, prefix of its C entry points)
_SOURCES = {"cuda-core": ("attention_core", "mst_core"),
            "tensor-core": ("flash_attention_tc", "mst_core_tc")}


def core_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels take a CUDA input of this dtype and head dimension:
    "tensor-core" (the core's entry points of ``csrc/flash_attention_tc.cu``)
    or "cuda-core" (``csrc/attention_core.cu``). The flash wrappers follow
    the same table (``flash_attention.kernel_route``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"inputs must be float32 or bfloat16, got {dtype}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not supported by the kernel (one of {_HEAD_DIMS})")
    return "tensor-core" if dtype == torch.bfloat16 and head_dim in _TC_HEAD_DIMS else "cuda-core"


_entry_points = {}  # (route, direction) -> (C entry point, its error string function)


def _entry_point(route: str, direction: str):
    """The C entry point of ``route`` for ``direction`` ("forward" or
    "backward"), its library built and bound at first use."""
    fns = _entry_points.get((route, direction))
    if fns is None:
        source, prefix = _SOURCES[route]
        lib = _build.load(source)
        fn, err = getattr(lib, f"{prefix}_{direction}"), getattr(lib, f"{prefix}_error_string")
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fns = _entry_points[(route, direction)] = (fn, err)
    return fns


def _check(qkv: torch.Tensor, key_lens: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int, str]:
    """(B, T, H, hd, route) of a valid kernel input; raises on anything else."""
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous [B, T, H*3*hd] tensor, got "
                         f"{tuple(qkv.shape)}")
    B, T, W = qkv.shape
    if num_heads < 1 or W % (3 * num_heads):
        raise ValueError(f"qkv width {W} is not a multiple of 3*num_heads={3 * num_heads}")
    hd = W // (3 * num_heads)
    route = core_route(qkv.dtype, hd)
    if (key_lens.dtype != torch.int32 or key_lens.shape != (B,)
            or key_lens.device != qkv.device):
        raise ValueError(f"key_lens must be an int32 [B={B}] tensor on {qkv.device}")
    if route == "tensor-core":
        check_tc_rows(qkv=qkv)
    return B, T, num_heads, hd, route


def check_tc_rows(**tensors: torch.Tensor) -> None:
    """The tensor-core route moves 16-byte pieces of rows. A contiguous qkv,
    context or cotangent at head dimension 32 or 64 has row strides and
    column offsets that are multiples of 8 elements, so its rows are
    16-byte aligned when its base address is: raise unless it is."""
    for name, x in tensors.items():
        if x.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: the tensor-core route needs a 16-byte aligned base "
                             f"address, got offset {x.data_ptr() % 16}")


def _launch(route: str, direction: str, args: _Args, device: torch.device) -> None:
    fn, err_string = _entry_point(route, direction)
    err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_SOURCES[route][1]}_{direction} launch failed: "
                           + err_string(err).decode())


@functools.lru_cache(maxsize=None)
def _scales(dtype: torch.dtype, sm_scale: float) -> Tuple[float, float]:
    """(sm_scale rounded to ``dtype``, sm_scale as float32); cached, since
    a wrapper asks at every launch."""
    return (float(torch.tensor(sm_scale, dtype=dtype)),
            float(torch.tensor(sm_scale, dtype=torch.float32)))


def core_forward(qkv: torch.Tensor, key_lens: torch.Tensor, num_heads: int,
                 causal: bool, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (ctx [B, T, H*hd], lse [B, H, T, 1]); one kernel launch (of the
    source ``core_route`` names) for a CUDA ``qkv``,
    ``core_forward_reference`` for a CPU one."""
    if not qkv.is_cuda:
        return core_forward_reference(qkv, key_lens, num_heads, causal, sm_scale)
    B, T, H, hd, route = _check(qkv, key_lens, num_heads)
    out = torch.empty(B, T, H * hd, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(B, H, T, 1, dtype=torch.float32, device=qkv.device)
    fwd_scale, bwd_scale = _scales(qkv.dtype, sm_scale)
    args = _Args(qkv=qkv.data_ptr(), key_lens=key_lens.data_ptr(), out=out.data_ptr(),
                 lse=lse.data_ptr(), B=B, T=T, H=H, HD=hd, causal=int(causal),
                 is_bf16=int(qkv.dtype == torch.bfloat16), fwd_scale=fwd_scale,
                 bwd_scale=bwd_scale)
    _launch(route, "forward", args, qkv.device)
    core_forward.launches += 1
    core_forward.tc_launches += route == "tensor-core"
    return out, lse


core_forward.launches = 0
core_forward.tc_launches = 0


def core_backward(qkv: torch.Tensor, key_lens: torch.Tensor, lse: torch.Tensor,
                  out: torch.Tensor, g: torch.Tensor, num_heads: int, causal: bool,
                  sm_scale: float) -> torch.Tensor:
    """K3: dqkv in the qkv layout and dtype; one call (two kernels: dQ with
    delta, then dK/dV, of the source ``core_route`` names) for a CUDA
    ``qkv``, ``core_backward_reference`` for a CPU one."""
    if not qkv.is_cuda:
        return core_backward_reference(qkv, key_lens, lse, out, g, num_heads, causal,
                                       sm_scale)
    B, T, H, hd, route = _check(qkv, key_lens, num_heads)
    if g.dtype != qkv.dtype or not g.is_contiguous():  # a call into torch costs host time
        g = g.to(qkv.dtype).contiguous()
    for name, x, shape, dt in (("out", out, (B, T, H * hd), qkv.dtype),
                               ("g", g, (B, T, H * hd), qkv.dtype),
                               ("lse", lse, (B, H, T, 1), torch.float32)):
        if (x.shape != shape or x.dtype != dt or not x.is_contiguous()
                or x.device != qkv.device):
            raise ValueError(f"{name} must be a contiguous {list(shape)} {dt} tensor "
                             f"on {qkv.device}, got {tuple(x.shape)} {x.dtype}")
    if route == "tensor-core":
        check_tc_rows(out=out, g=g)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty(B, H, T, dtype=torch.float32, device=qkv.device)
    fwd_scale, bwd_scale = _scales(qkv.dtype, sm_scale)
    args = _Args(qkv=qkv.data_ptr(), key_lens=key_lens.data_ptr(), out=out.data_ptr(),
                 lse=lse.data_ptr(), dout=g.data_ptr(), delta=delta.data_ptr(),
                 dqkv=dqkv.data_ptr(), B=B, T=T, H=H, HD=hd, causal=int(causal),
                 is_bf16=int(qkv.dtype == torch.bfloat16), fwd_scale=fwd_scale,
                 bwd_scale=bwd_scale)
    _launch(route, "backward", args, qkv.device)
    core_backward.launches += 1
    core_backward.tc_launches += route == "tensor-core"
    return dqkv


core_backward.launches = 0
core_backward.tc_launches = 0


class AttentionCore(torch.autograd.Function):
    """K2 forward (residuals: qkv, key_lens, lse, ctx) and K3 backward, or
    ``core_xla_backward`` when ``xla_backward`` is set."""

    @staticmethod
    def forward(ctx, qkv, key_lens, num_heads, causal, sm_scale, xla_backward):
        out, lse = core_forward(qkv, key_lens, num_heads, causal, sm_scale)
        ctx.save_for_backward(qkv, key_lens, lse, out)
        ctx.config = (num_heads, causal, sm_scale, xla_backward)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, key_lens, lse, out = ctx.saved_tensors
        num_heads, causal, sm_scale, xla_backward = ctx.config
        backward = core_xla_backward if xla_backward else core_backward
        dqkv = backward(qkv, key_lens, lse, out, g.contiguous(), num_heads, causal, sm_scale)
        return dqkv, None, None, None, None, None


def attention_core(qkv: torch.Tensor, key_lens: torch.Tensor, num_heads: int,
                   causal: bool = False, sm_scale: Optional[float] = None,
                   xla_backward: bool = False) -> torch.Tensor:
    """Attention over the interleaved ``qkv`` [B, T, H*3*hd] with prefix
    ``key_lens`` [B] (int32): the context [B, T, H*hd], differentiable in
    ``qkv``. ``sm_scale`` defaults to 1/sqrt(hd)."""
    if sm_scale is None:
        sm_scale = default_scale(qkv, num_heads)
    return AttentionCore.apply(qkv.contiguous(), key_lens.to(torch.int32).contiguous(),
                               num_heads, causal, float(sm_scale), xla_backward)

"""K4 / K5: flash attention, forward and backward.

Replaces ``musicstyletransfer_tpu/ops/flash_attention.py``: K4 is the forward
(``_flash_forward_with_lse`` with Pallas kernel ``_flash_kernel``, and
``_flash_forward_streaming`` with ``_flash_stream_kernel`` from padded
T >= 8192), K5 the backward (``_flash_backward`` with ``_dqkv_kernel``, and
``_flash_backward_streaming`` with ``_dq_stream_kernel`` and
``_dkv_stream_kernel``). The resident / streaming split is a VMEM artefact:
the kernels here, ``csrc/flash_attention.cu``, take any T.
``flash_forward_reference`` and ``flash_backward_reference`` are their plain
PyTorch versions. ``flash_forward`` / ``flash_backward`` launch the kernels
for CUDA tensors and take the plain versions only for CPU tensors; they
never fall back from one to the other. ``flash_attention`` and
``flash_attention_with_lse`` bind the two through one
``torch.autograd.Function``.

The layout is the JAX package's: q, k, v [B, H, T, D], ``key_lens`` [B]
prefix key counts (int32), out [B, H, T, D] in the input dtype and lse
[B, H, T] in float32. A query sees the keys k < key_lens[b], and under
``causal`` only k <= q; a non-causal query row past key_lens still sees the
valid keys. A row that sees no key gives zeros and the lse sentinel -1e30.
The kernels take any strides with a contiguous last dimension, so the model
passes its [B, T, H, D] projections as transposed views without a copy; out
and the gradients are laid out [B, T, H, D] in memory, returned as
[B, H, T, D] views.

Rounding points, as in the Pallas kernels: q * sm_scale with the scale first
rounded to the input dtype (``jnp.asarray(sm_scale, q.dtype)``); scores in
float32; p rounded to v's dtype before P.V; float32 accumulation;
acc / max(l, 1e-30). The backward is all float32 with the scale in float32:
P recomputed from lse, a row live where lse > -1e29, ds = p * (dp - delta)
with delta = rowsum(dO * O) - g_lse, dq = ds K scale, dk = ds^T (q scale),
dv = p^T dO.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .attention_core import _HEAD_DIMS, _NEG_INF, _mask, _scales

_SENTINEL = -1e29  # lse at or below it: a row that sees no key


# ----------------------------------------------------------------------------
# The plain PyTorch versions


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            key_lens: torch.Tensor, causal: bool,
                            sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function, whole [T, T] score tile at once: (out [B, H, T, D] in
    the input dtype, lse [B, H, T] float32)."""
    if q.is_cuda:
        flash_forward_reference.cuda_runs += 1
    T = q.shape[2]
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)  # rounded in the input dtype
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    mask = _mask(key_lens, T, causal)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


flash_forward_reference.cuda_runs = 0


def flash_backward_reference(q, k, v, key_lens, lse, out, g, causal: bool, sm_scale: float,
                             g_lse: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's function: (dq, dk, dv) in the input dtype, P recomputed from
    lse, all in float32; ``g_lse`` (the lse cotangent) folds into delta."""
    if q.is_cuda:
        flash_backward_reference.cuda_runs += 1
    T = q.shape[2]
    qs = q.float() * sm_scale  # pre-scaled: dk needs no further scale
    kf, vf, do = k.float(), v.float(), g.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    mask = _mask(key_lens, T, causal) & (lse[..., None] > _SENTINEL)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = (do * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = torch.where(mask, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


flash_backward_reference.cuda_runs = 0

# ----------------------------------------------------------------------------
# The kernels

_Strides = ctypes.c_longlong * 3


class _Args(ctypes.Structure):
    """Mirror of ``MstFlashArgs`` in csrc/flash_attention.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("key_lens", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("lse", ctypes.c_void_p), ("dout", ctypes.c_void_p),
        ("g_lse", ctypes.c_void_p), ("delta", ctypes.c_void_p),
        ("dq", ctypes.c_void_p), ("dk", ctypes.c_void_p), ("dv", ctypes.c_void_p),
        ("sq", _Strides), ("sk", _Strides), ("sv", _Strides), ("so", _Strides),
        ("sdo", _Strides), ("sdq", _Strides), ("sdk", _Strides), ("sdv", _Strides),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("T", ctypes.c_int),
        ("HD", ctypes.c_int), ("causal", ctypes.c_int), ("is_bf16", ctypes.c_int),
        ("fwd_scale", ctypes.c_float), ("bwd_scale", ctypes.c_float),
    ]


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.mst_flash_forward.argtypes is None:
        for fn in (lib.mst_flash_forward, lib.mst_flash_backward):
            fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mst_flash_error_string.argtypes = [ctypes.c_int]
        lib.mst_flash_error_string.restype = ctypes.c_char_p
    return lib


def _strides(x: torch.Tensor) -> "_Strides":
    return _Strides(*x.stride()[:3])


def _check(q, k, v, key_lens) -> Tuple[int, int, int, int]:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, D], got {tuple(q.shape)}")
    B, H, T, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the kernel (one of {_HEAD_DIMS})")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} {q.dtype} on {q.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
    if (key_lens.dtype != torch.int32 or key_lens.shape != (B,)
            or key_lens.device != q.device or not key_lens.is_contiguous()):
        raise ValueError(f"key_lens must be a contiguous int32 [B={B}] tensor on {q.device}")
    return B, H, T, D


def _empty_bthd(B: int, H: int, T: int, D: int, like: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] view of a [B, T, H, D] buffer (the model's layout)."""
    return torch.empty(B, T, H, D, dtype=like.dtype, device=like.device).transpose(1, 2)


def _launch(fn_name: str, args: _Args, device: torch.device) -> None:
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn_name)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           + lib.mst_flash_error_string(err).decode())


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_lens: torch.Tensor,
                  causal: bool, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (out [B, H, T, D], lse [B, H, T]); one kernel launch for CUDA
    tensors, ``flash_forward_reference`` for CPU ones."""
    if not q.is_cuda:
        return flash_forward_reference(q, k, v, key_lens, causal, sm_scale)
    B, H, T, D = _check(q, k, v, key_lens)
    out = _empty_bthd(B, H, T, D, q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    fwd_scale, bwd_scale = _scales(q.dtype, sm_scale)
    args = _Args(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), key_lens=key_lens.data_ptr(),
                 out=out.data_ptr(), lse=lse.data_ptr(), sq=_strides(q), sk=_strides(k),
                 sv=_strides(v), so=_strides(out), B=B, H=H, T=T, HD=D, causal=int(causal),
                 is_bf16=int(q.dtype == torch.bfloat16), fwd_scale=fwd_scale,
                 bwd_scale=bwd_scale)
    _launch("mst_flash_forward", args, q.device)
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_lens: torch.Tensor,
                   lse: torch.Tensor, out: torch.Tensor, g: torch.Tensor, causal: bool,
                   sm_scale: float, g_lse: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: (dq, dk, dv) in q's dtype; one call (three kernels: delta, dQ,
    dK/dV) for CUDA tensors, ``flash_backward_reference`` for CPU ones."""
    if not q.is_cuda:
        return flash_backward_reference(q, k, v, key_lens, lse, out, g, causal, sm_scale,
                                        g_lse)
    B, H, T, D = _check(q, k, v, key_lens)
    g = g.to(q.dtype)
    if g.stride(-1) != 1:
        g = g.contiguous()
    for name, x in (("out", out), ("g", g)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device or x.stride(-1) != 1:
            raise ValueError(f"{name} must be a {list(q.shape)} {q.dtype} tensor on {q.device} "
                             f"with a contiguous last dimension")
    for name, x in (("lse", lse), ("g_lse", g_lse)):
        if x is not None and (x.shape != (B, H, T) or x.dtype != torch.float32
                              or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be a contiguous [{B}, {H}, {T}] float32 tensor "
                             f"on {q.device}")
    dq, dk, dv = (_empty_bthd(B, H, T, D, q) for _ in range(3))
    delta = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    fwd_scale, bwd_scale = _scales(q.dtype, sm_scale)
    args = _Args(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), key_lens=key_lens.data_ptr(),
                 out=out.data_ptr(), lse=lse.data_ptr(), dout=g.data_ptr(),
                 g_lse=None if g_lse is None else g_lse.data_ptr(), delta=delta.data_ptr(),
                 dq=dq.data_ptr(), dk=dk.data_ptr(), dv=dv.data_ptr(),
                 sq=_strides(q), sk=_strides(k), sv=_strides(v), so=_strides(out),
                 sdo=_strides(g), sdq=_strides(dq), sdk=_strides(dk), sdv=_strides(dv),
                 B=B, H=H, T=T, HD=D, causal=int(causal),
                 is_bf16=int(q.dtype == torch.bfloat16), fwd_scale=fwd_scale,
                 bwd_scale=bwd_scale)
    _launch("mst_flash_backward", args, q.device)
    flash_backward.launches += 1
    return dq, dk, dv


flash_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """K4 forward (residuals: q, k, v, key_lens, lse, out) and K5 backward;
    an lse cotangent, where lse is used, folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, key_lens, causal, sm_scale):
        out, lse = flash_forward(q, k, v, key_lens, causal, sm_scale)
        ctx.save_for_backward(q, k, v, key_lens, lse, out)
        ctx.config = (causal, sm_scale)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, key_lens, lse, out = ctx.saved_tensors
        causal, sm_scale = ctx.config
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_backward(q, k, v, key_lens, lse, out, g_out, causal, sm_scale,
                                    None if g_lse is None else g_lse.contiguous())
        return dq, dk, dv, None, None, None


def _apply(q, k, v, key_lens, causal, sm_scale):
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, key_lens.to(torch.int32).contiguous(), causal,
                                float(sm_scale))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_lens: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over q, k, v [B, H, T, D] with prefix ``key_lens`` [B]:
    out [B, H, T, D], differentiable in q, k and v. ``sm_scale`` defaults
    to 1/sqrt(D)."""
    return _apply(q, k, v, key_lens, causal, sm_scale)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             key_lens: torch.Tensor, causal: bool = False,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, T, D], lse [B, H, T] float32), both differentiable: the
    lse cotangent folds into the backward's delta (delta' = delta - g_lse),
    so a caller that merges partial softmaxes by lse gets exact gradients."""
    return _apply(q, k, v, key_lens, causal, sm_scale)

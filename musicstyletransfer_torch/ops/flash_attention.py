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

Two sources hold the kernels, and the wrappers choose between them by dtype
and head dimension alone, before the launch (``kernel_route``): bfloat16 at
head dimension 16, 32, 64 or 128 and float32 at 32 or 64 go to
``csrc/flash_attention_tc.cu``, whose matrix products run on the tensor
cores (``wgmma``) from bf16 shared-memory tiles that a producer warpgroup
fills with asynchronous copies; the rest (head dimension 8, and float32 at
16 and 128) goes to ``csrc/flash_attention.cu`` (CUDA-core float32 FMA).
float32 inputs reach the tensor cores as three bf16
pieces each (``split_bf16x3``: x = hi + mid + lo exactly, one launch of
``split_bf16x3_kernel`` an operand, q with sm_scale applied first), every
float32 product as six bf16 products into a float32 accumulator. The
attention core (``attention_core.core_route``) keeps float32 on its
CUDA-core kernels. The tensor-core kernels need 16-byte aligned rows (base
address, and (b, h, t) strides that are multiples of 16 bytes: 8 bf16 or 4
float32 elements), which the model's layouts have; the wrapper raises on
anything else and never falls back. ``launches`` counts every launch of a
wrapper, ``tc_launches`` those of the tensor-core kernels, and
``split_bf16x3.launches`` those of the split.

Two arguments beyond the JAX package's, for the decoders of today's open
models, on the bf16 tensor-core route only: K/V heads fewer than the query
heads (grouped-query attention: k and v [B, H_kv, T, D], H a multiple of
H_kv, query head h reads K/V head h // (H / H_kv); dK and dV are summed
over each group, [B, H_kv, T, D]), and ``window`` W > 0 with ``causal``
(query i sees keys i - W < j <= i; key tiles wholly outside the window are
skipped, not masked). With H_kv = H and W = 0 the kernels compute what they
did without them. ``windowed_launches`` and ``grouped_launches`` count the
launches that take each; ``tile_stats`` (a device int64 [2], None unless a
caller sets it: ``track_tiles``) gathers from every launch the key (K4, dQ)
and query (dK/dV) tiles the blocks loaded, which ``walked_tiles`` counts by
the walks' rule (the tests hold one to the other).

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
dv = p^T dO. The tensor-core backward keeps float32 sums, softmax and scale
but feeds bf16 operands to its products: S from the raw q, scaled
afterwards; P (for dv) and ds (for dq, dk) rounded to bf16; dk scaled at the
end. For float32 inputs the tensor-core kernels keep the rounding points
above: their operands are exact in three pieces. Through ``flash_attention``
bf16 K4 on the tensor cores also writes out's float32 residual (``out_lo``,
bf16) and K5 takes delta from out + out_lo: delta from the bf16 out alone
put ~3% of error into dq on rows of 2047 keys (PERF.md); the plain
versions keep the JAX package's delta from out.
"""

from __future__ import annotations

import ctypes
import sys
import types
from typing import Optional, Tuple

import torch

from . import _build
from .attention_core import _NEG_INF, _mask, _scales, core_route

_SENTINEL = -1e29  # lse at or below it: a row that sees no key
# dtype -> the head dimensions the tensor-core kernels take (float32 as three
# bf16 pieces an operand: at 16 and 128 those outgrow the shared memory)
TC_HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 128), torch.float32: (32, 64)}


# ----------------------------------------------------------------------------
# The plain PyTorch versions


def flash_mask(key_lens: torch.Tensor, T: int, causal: bool, window: int = 0) -> torch.Tensor:
    """[B, 1, Tq, Tk] True where query q sees key k: k < key_lens, causal
    k <= q, and with a window W > 0 also k > q - W."""
    mask = _mask(key_lens, T, causal)
    if window > 0:
        pos = torch.arange(T, device=key_lens.device)
        mask = mask & (pos[None, None, None, :] > pos[None, None, :, None] - window)
    return mask


def expand_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    """K/V [B, H_kv, T, D] repeated to ``heads`` query heads (head h is K/V
    head h // (heads / H_kv))."""
    return x if x.shape[1] == heads else x.repeat_interleave(heads // x.shape[1], dim=1)


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            key_lens: torch.Tensor, causal: bool,
                            sm_scale: float, window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function, whole [T, T] score tile at once: (out [B, H, T, D] in
    the input dtype, lse [B, H, T] float32); k and v may hold fewer heads."""
    if q.is_cuda:
        flash_forward_reference.cuda_runs += 1
    T, H = q.shape[2], q.shape[1]
    k, v = expand_kv(k, H), expand_kv(v, H)
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)  # rounded in the input dtype
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    mask = flash_mask(key_lens, T, causal, window)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


flash_forward_reference.cuda_runs = 0


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_lens: torch.Tensor, causal: bool, sm_scale: float) -> torch.Tensor:
    """Dense attention in the input dtype, the JAX package's
    ``reference_attention`` (``flash_attention.py:60-80``): q, k, v
    [B, H, T, D], prefix ``key_lens`` [B]; out [B, H, T, D]."""
    T = q.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    bias = torch.where(_mask(key_lens, T, causal), 0.0, _NEG_INF)
    probs = torch.softmax(logits + bias.to(logits.dtype), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def flash_backward_reference(q, k, v, key_lens, lse, out, g, causal: bool, sm_scale: float,
                             g_lse: Optional[torch.Tensor] = None, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's function: (dq, dk, dv) in the input dtype, P recomputed from
    lse, all in float32; ``g_lse`` (the lse cotangent) folds into delta;
    dk and dv summed over each K/V head's group of query heads."""
    if q.is_cuda:
        flash_backward_reference.cuda_runs += 1
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    qs = q.float() * sm_scale  # pre-scaled: dk needs no further scale
    kf, vf, do = expand_kv(k, H).float(), expand_kv(v, H).float(), g.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    mask = flash_mask(key_lens, T, causal, window) & (lse[..., None] > _SENTINEL)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = (do * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = torch.where(mask, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs).reshape(B, Hkv, H // Hkv, T, D).sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do).reshape(B, Hkv, H // Hkv, T, D).sum(2)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


flash_backward_reference.cuda_runs = 0


def split_bf16x3_reference(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The split's function: y = x * scale in float32 (the scale as
    float32), then y = hi + mid + lo with hi = bf16(y), mid = bf16(y - hi),
    lo = bf16(y - hi - mid); [3, *x.shape] bf16 (hi, mid, lo), contiguous.
    The three pieces hold y's 24 significant bits exactly wherever y - hi -
    mid is a normal bf16 (|y| above ~2^-110)."""
    if x.is_cuda:
        split_bf16x3_reference.cuda_runs += 1
    y = x * torch.tensor(scale, dtype=torch.float32)
    hi = y.to(torch.bfloat16)
    r = y - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return torch.stack((hi, mid, lo))


split_bf16x3_reference.cuda_runs = 0

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
        ("q3", ctypes.c_void_p), ("k3", ctypes.c_void_p), ("v3", ctypes.c_void_p),
        ("dout3", ctypes.c_void_p), ("window", ctypes.c_int), ("group", ctypes.c_int),
        ("tile_stats", ctypes.c_void_p), ("out_lo", ctypes.c_void_p),
    ]


# route -> (source in csrc/, prefix of its C entry points)
_SOURCES = {"cuda-core": ("flash_attention", "mst_flash"),
            "tensor-core": ("flash_attention_tc", "mst_flash_tc")}


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels take CUDA inputs of this dtype and head dimension:
    "tensor-core" (``csrc/flash_attention_tc.cu``: bfloat16 at head
    dimension 16, 32, 64 or 128, float32 as three bf16 pieces at 32 or 64;
    ``TC_HEAD_DIMS``) or "cuda-core" (``csrc/flash_attention.cu``: head
    dimension 8, and float32 at 16 and 128). The attention core's table
    (``attention_core.core_route``) is narrower: bfloat16 at 32 or 64."""
    core_route(dtype, head_dim)  # the dtype and head dimension checks
    return "tensor-core" if head_dim in TC_HEAD_DIMS[dtype] else "cuda-core"


def check_tc_layout(**tensors: torch.Tensor) -> None:
    """The tensor-core kernels (and the split of float32 inputs) move
    16-byte pieces of rows: raise unless each [B, H, T, D] tensor starts
    16-byte aligned and its (b, h, t) strides are multiples of 16 bytes (8
    bf16 or 4 float32 elements)."""
    for name, x in tensors.items():
        unit = 16 // x.element_size()
        if x.data_ptr() % 16 != 0 or any(st % unit != 0 for st in x.stride()[:3]):
            raise ValueError(
                f"{name}: the tensor-core flash kernels need a 16-byte aligned base address and "
                f"(b, h, t) strides that are multiples of {unit} elements, got offset "
                f"{x.data_ptr() % 16} and strides {tuple(x.stride())}")


def _library(route: str) -> Tuple[ctypes.CDLL, str]:
    source, prefix = _SOURCES[route]
    lib = _build.load(source)
    if getattr(lib, prefix + "_forward").argtypes is None:
        for fn in (getattr(lib, prefix + "_forward"), getattr(lib, prefix + "_backward")):
            fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        getattr(lib, prefix + "_error_string").argtypes = [ctypes.c_int]
        getattr(lib, prefix + "_error_string").restype = ctypes.c_char_p
        if route == "tensor-core":
            lib.mst_split_bf16x3.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_Strides), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
            lib.mst_split_bf16x3.restype = ctypes.c_int
    return lib, prefix


def _strides(x: torch.Tensor) -> "_Strides":
    return _Strides(*x.stride()[:3])


def split_bf16x3(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The bf16 pieces hi, mid, lo of float32 x * scale ([B, H, T, D], any
    strides with a contiguous last dimension and 16-byte aligned rows):
    [3, B, H, T, D] bf16, contiguous, as the tensor-core kernels read float32
    inputs. One launch of ``split_bf16x3_kernel`` for a CUDA ``x``,
    ``split_bf16x3_reference`` (the same bits) for a CPU one."""
    if not x.is_cuda:
        return split_bf16x3_reference(x, scale)
    if x.dtype != torch.float32 or x.dim() != 4 or x.stride(-1) != 1 or x.shape[-1] % 4 != 0:
        raise ValueError(f"the split takes a float32 [B, H, T, D] tensor with a contiguous last "
                         f"dimension and D a multiple of 4, got {x.dtype} {tuple(x.shape)} with "
                         f"strides {tuple(x.stride())}")
    check_tc_layout(x=x)
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    lib, _ = _library("tensor-core")
    err = lib.mst_split_bf16x3(x.data_ptr(), ctypes.byref(_strides(x)), *x.shape, scale,
                               out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("mst_split_bf16x3 launch failed: "
                           + lib.mst_flash_tc_error_string(err).decode())
    split_bf16x3.launches += 1
    return out


split_bf16x3.launches = 0


def _check(q, k, v, key_lens, route: Optional[str] = None, causal: bool = True,
           window: int = 0) -> Tuple[int, int, int, int, str]:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, H, T, D], got {tuple(q.shape)}, {tuple(k.shape)}")
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    if route is None:
        route = kernel_route(q.dtype, D)
    elif route not in ("cuda-core", kernel_route(q.dtype, D)):
        raise ValueError(f"the {route} kernels do not take {q.dtype} at head dimension {D}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} K/V heads")
    if window < 0 or (window and not causal):
        raise ValueError(f"a window ({window}) needs causal attention")
    if (Hkv != H or window) and route != "tensor-core":
        raise ValueError(f"K/V groups and windows are the tensor-core kernels' ({q.dtype} at "
                         f"head dimension {D} goes to the {route} ones)")
    if (Hkv != H or window) and q.dtype != torch.bfloat16:
        raise ValueError("K/V groups and windows are the bf16 kernels' (float32's pieces are "
                         "laid out at the query heads, and its instances take no window)")
    for name, x in (("k", k), ("v", v)):
        if x.shape != (B, Hkv, T, D) or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must be [{B}, {Hkv}, {T}, {D}] {q.dtype} on {q.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
    if (key_lens.dtype != torch.int32 or key_lens.shape != (B,)
            or key_lens.device != q.device or not key_lens.is_contiguous()):
        raise ValueError(f"key_lens must be a contiguous int32 [B={B}] tensor on {q.device}")
    if route == "tensor-core":
        check_tc_layout(q=q, k=k, v=v)
    return B, H, T, D, route


def _empty_bthd(B: int, H: int, T: int, D: int, like: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] view of a [B, T, H, D] buffer (the model's layout)."""
    return torch.empty(B, T, H, D, dtype=like.dtype, device=like.device).transpose(1, 2)


def _launch(route: str, direction: str, args: _Args, device: torch.device) -> None:
    lib, prefix = _library(route)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, f"{prefix}_{direction}")(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{prefix}_{direction} launch failed: "
                           + getattr(lib, prefix + "_error_string")(err).decode())


def _pieces(route: str, scale: float, q: torch.Tensor, *rest: torch.Tensor):
    """float32 inputs of the tensor-core route: the pieces of q * scale and
    of each of ``rest`` (``split_bf16x3``), else Nones."""
    if route != "tensor-core" or q.dtype != torch.float32:
        return (None,) * (1 + len(rest))
    return (split_bf16x3(q, scale), *(split_bf16x3(x) for x in rest))


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_lens: torch.Tensor,
                  causal: bool, sm_scale: float, *, route: Optional[str] = None,
                  window: int = 0, out_lo: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (out [B, H, T, D], lse [B, H, T]); one kernel launch (of the
    source ``kernel_route`` names; float32 on the tensor cores first splits
    q, k and v) for CUDA tensors, ``flash_forward_reference`` for CPU ones.
    ``route`` "cuda-core" takes the CUDA-core kernels at any head dimension
    (to measure them beside the tensor-core ones). ``out_lo`` (bf16 on the
    tensor cores, shaped and strided as out, ``new_out_lo``) receives what
    rounding out to bf16 left over, for ``flash_backward``'s delta."""
    if not q.is_cuda:
        return flash_forward_reference(q, k, v, key_lens, causal, sm_scale, window)
    B, H, T, D, route = _check(q, k, v, key_lens, route, causal, window)
    out = _empty_bthd(B, H, T, D, q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    fwd_scale, bwd_scale = _scales(q.dtype, sm_scale)
    q3, k3, v3 = _pieces(route, fwd_scale, q, k, v)
    args = _Args(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), key_lens=key_lens.data_ptr(),
                 out=out.data_ptr(), lse=lse.data_ptr(), sq=_strides(q), sk=_strides(k),
                 sv=_strides(v), so=_strides(out), B=B, H=H, T=T, HD=D, causal=int(causal),
                 is_bf16=int(q.dtype == torch.bfloat16), fwd_scale=fwd_scale,
                 bwd_scale=bwd_scale, q3=_ptr(q3), k3=_ptr(k3), v3=_ptr(v3),
                 window=window, group=H // k.shape[1], tile_stats=_ptr(tile_stats.buffer),
                 out_lo=_ptr(out_lo))
    _launch(route, "forward", args, q.device)
    _count(flash_forward, route, window, H != k.shape[1])
    return out, lse


def new_out_lo(q: torch.Tensor) -> Optional[torch.Tensor]:
    """A buffer for K4's residual of out where the kernels keep one: bf16 q
    on the card at a tensor-core head dimension; None elsewhere."""
    if not q.is_cuda or q.dtype != torch.bfloat16 or kernel_route(q.dtype, q.shape[-1]) != \
            "tensor-core":
        return None
    B, H, T, D = q.shape
    return _empty_bthd(B, H, T, D, q)


def _count(wrapper, route: str, window: int, grouped: bool) -> None:
    wrapper.launches += 1
    wrapper.tc_launches += route == "tensor-core"
    wrapper.windowed_launches += window > 0
    wrapper.grouped_launches += grouped


class tile_stats:
    """The tiles the tensor-core flash kernels walk, counted on the device
    while ``track_tiles`` is on (``buffer``: int64 [2], the key tiles K4 and
    the dQ kernel loaded, then the dK/dV kernel's query tiles). Launches
    made meanwhile, captured ones too, add to it at every run; ``read``
    copies it out."""

    buffer: Optional[torch.Tensor] = None

    @classmethod
    def track_tiles(cls, device, on: bool = True) -> None:
        cls.buffer = torch.zeros(2, dtype=torch.int64, device=device) if on else None

    @classmethod
    def read(cls) -> Optional[list]:
        return None if cls.buffer is None else cls.buffer.tolist()


def walked_tiles(key_lens, T: int, H: int, window: int, head_dim: int) -> Tuple[int, int]:
    """What ``tile_stats`` should read after one causal K4 and K5 at
    ``window`` (0: none) over rows of ``key_lens``, by the walks' rule:
    blocks of 128 rows; K4 (64-key tiles at hd 128, else 128) and the dQ
    kernel (64) load the key tiles from the one holding the first key the
    block's first row sees up to the block's last visible key, none where
    key_lens ends before the first; the dK/dV kernel loads 64-row query
    tiles from the block's diagonal tile to the last row that sees one of
    its keys below key_lens."""
    fwd_bn = 64 if head_dim == 128 else 128

    def keys(q0: int, valid: int, bn: int) -> int:
        kend = min(valid, T, q0 + 128)
        first = max(q0 - window + 1, 0) if window else 0
        return -(-kend // bn) - first // bn if kend > first else 0

    key_tiles = query_tiles = 0
    for valid in key_lens:
        valid = max(0, min(int(valid), T))
        for q0 in range(0, T, 128):
            key_tiles += H * (keys(q0, valid, fwd_bn) + keys(q0, valid, 64))
            qbegin = (q0 // 64) * 64 if q0 < valid else T
            qend = min(T, min(q0 + 128, valid) - 1 + window) if window else T
            query_tiles += H * max(0, -(-(qend - qbegin) // 64))
    return key_tiles, query_tiles


flash_forward.launches = 0
flash_forward.tc_launches = 0
flash_forward.windowed_launches = 0
flash_forward.grouped_launches = 0


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_lens: torch.Tensor,
                   lse: torch.Tensor, out: torch.Tensor, g: torch.Tensor, causal: bool,
                   sm_scale: float, g_lse: Optional[torch.Tensor] = None, *,
                   route: Optional[str] = None, window: int = 0,
                   out_lo: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: (dq, dk, dv) in q's dtype; one call (three kernels: delta, dQ,
    dK/dV, of the source ``kernel_route`` names; float32 on the tensor cores
    first splits q, k, v and dO) for CUDA tensors,
    ``flash_backward_reference`` for CPU ones. ``route`` as for
    ``flash_forward``; ``out_lo``, K4's residual of out, makes delta
    rowsum(dO * (out + out_lo))."""
    if not q.is_cuda:
        return flash_backward_reference(q, k, v, key_lens, lse, out, g, causal, sm_scale,
                                        g_lse, window)
    B, H, T, D, route = _check(q, k, v, key_lens, route, causal, window)
    Hkv = k.shape[1]
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
    if route == "tensor-core":
        check_tc_layout(out=out, g=g)
    dq = _empty_bthd(B, H, T, D, q)
    dk, dv = (_empty_bthd(B, Hkv, T, D, q) for _ in range(2))
    delta = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    fwd_scale, bwd_scale = _scales(q.dtype, sm_scale)
    q3, k3, v3, g3 = _pieces(route, bwd_scale, q, k, v, g)
    args = _Args(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), key_lens=key_lens.data_ptr(),
                 out=out.data_ptr(), lse=lse.data_ptr(), dout=g.data_ptr(),
                 g_lse=None if g_lse is None else g_lse.data_ptr(), delta=delta.data_ptr(),
                 dq=dq.data_ptr(), dk=dk.data_ptr(), dv=dv.data_ptr(),
                 sq=_strides(q), sk=_strides(k), sv=_strides(v), so=_strides(out),
                 sdo=_strides(g), sdq=_strides(dq), sdk=_strides(dk), sdv=_strides(dv),
                 B=B, H=H, T=T, HD=D, causal=int(causal),
                 is_bf16=int(q.dtype == torch.bfloat16), fwd_scale=fwd_scale,
                 bwd_scale=bwd_scale, q3=_ptr(q3), k3=_ptr(k3), v3=_ptr(v3), dout3=_ptr(g3),
                 window=window, group=H // Hkv, tile_stats=_ptr(tile_stats.buffer),
                 out_lo=_ptr(out_lo))
    _launch(route, "backward", args, q.device)
    _count(flash_backward, route, window, H != Hkv)
    return dq, dk, dv


flash_backward.launches = 0
flash_backward.tc_launches = 0
flash_backward.windowed_launches = 0
flash_backward.grouped_launches = 0


class FlashAttention(torch.autograd.Function):
    """K4 forward (residuals: q, k, v, key_lens, lse, out, and for bf16 on
    the tensor cores out's residual ``out_lo``) and K5 backward; an lse
    cotangent, where lse is used, folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, key_lens, causal, sm_scale, window=0):
        windowed = {"window": window} if window else {}
        out_lo = new_out_lo(q)
        extra = windowed if out_lo is None else {**windowed, "out_lo": out_lo}
        out, lse = flash_forward(q, k, v, key_lens, causal, sm_scale, **extra)
        ctx.save_for_backward(q, k, v, key_lens, lse, out, out_lo)
        ctx.config = (causal, sm_scale, windowed)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, key_lens, lse, out, out_lo = ctx.saved_tensors
        causal, sm_scale, extra = ctx.config
        if g_out is None:
            g_out = torch.zeros_like(out)
        if out_lo is not None:
            extra = {**extra, "out_lo": out_lo}
        dq, dk, dv = flash_backward(q, k, v, key_lens, lse, out, g_out, causal, sm_scale,
                                    None if g_lse is None else g_lse.contiguous(), **extra)
        return dq, dk, dv, None, None, None, None


def _apply(q, k, v, key_lens, causal, sm_scale, window=0):
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, key_lens.to(torch.int32).contiguous(), causal,
                                float(sm_scale), int(window))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_lens: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Attention over q [B, H, T, D] and k, v [B, H_kv, T, D] (H a multiple
    of H_kv) with prefix ``key_lens`` [B], under ``causal`` within a left
    ``window`` (0: none): out [B, H, T, D], differentiable in q, k and v.
    ``sm_scale`` defaults to 1/sqrt(D)."""
    return _apply(q, k, v, key_lens, causal, sm_scale, window)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             key_lens: torch.Tensor, causal: bool = False,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, T, D], lse [B, H, T] float32), both differentiable: the
    lse cotangent folds into the backward's delta (delta' = delta - g_lse),
    so a caller that merges partial softmaxes by lse gets exact gradients."""
    return _apply(q, k, v, key_lens, causal, sm_scale)


class _CallableModule(types.ModuleType):
    """This module, callable as its ``flash_attention``: the JAX package's
    ``ops`` exports the function under the module's name, and the port's
    ``ops.flash_attention`` stays the module the wrappers live in."""

    def __call__(self, *args, **kwargs):
        return flash_attention(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule

"""Adam's update on the card as one pass over the optimizer's flat float32
buffers (``csrc/fused_adam.cu``), and the pass over the gradient before it.

``grad_stats(grad)`` (kernel A) reads the flat gradient once and gives its
sum of squares (float32 []) and whether every element is finite (bool []),
both on the device: the non-finite guard's input and the logged gradient
norm, where the chain took ``isfinite(grad).all()`` and ``sum(grad * grad)``
(two passes and two whole-vector temporaries). Its sum is taken in double in
a fixed order and rounded once, so it lies within 2^-23 of the exact sum;
``grad_stats_reference`` is its plain version.

``adam_update(...)`` (kernel B) reads g, p, mu and nu once and writes p, mu
and nu: the elementwise chain of ``training/optimizer.Optimizer`` for adam
and adamw (clip_gradient, clip_global_norm, wd, skip_nonfinite), equal to it
bit for bit on the card. That chain is its plain version: the optimizer runs
it on CPU buffers and for the settings the kernel does not take
(``training.optimizer.update_route``). Every value that changes from step to
step is a device scalar, so a CUDA graph replays a captured launch for every
later step.

Counters: ``adam_update.launches`` (kernel B's launches),
``grad_stats.launches`` (kernel A's calls, each two launches) and
``adam_update.chain_cuda_runs`` (the optimizer's chain steps on CUDA
buffers), "adam", "adam stats" and "adam plain" in ``ops.counters``.

Both kernels take CUDA float32 vectors only, contiguous and 16-byte aligned
(the optimizer's buffers are whole allocations), and raise on anything else;
neither falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

THREADS = 256  # kThreads of the source
BLOCKS_PER_SM = {"update": 4, "stats": 8}  # the kernels' __launch_bounds__


class _Consts(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "b1", "one_minus_b1", "b2", "one_minus_b2", "eps", "clip", "max_norm", "wd",
        "adamw_wd")] + [("has_clip", ctypes.c_int)]


def grid_of(n: int, sms: int, kernel: str) -> int:
    """Blocks of a launch over ``n`` elements: enough for one 16-byte piece
    a thread, at most as many as ``sms`` SMs hold at once."""
    return max(1, min(-(-(n // 4) // THREADS), sms * BLOCKS_PER_SM[kernel]))


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_adam")
    if lib.mst_adam_update.argtypes is None:
        p = ctypes.c_void_p
        lib.mst_adam_update.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.POINTER(_Consts),
                                        p, p, p, p, p, ctypes.c_int, p]
        lib.mst_adam_update.restype = ctypes.c_int
        lib.mst_grad_stats.argtypes = [p, ctypes.c_longlong, p, ctypes.c_int, p, p, p]
        lib.mst_grad_stats.restype = ctypes.c_int
        lib.mst_adam_error_string.argtypes = [ctypes.c_int]
        lib.mst_adam_error_string.restype = ctypes.c_char_p
    return lib


def _check_vectors(n: int, **tensors: torch.Tensor) -> None:
    for name, x in tensors.items():
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name}: the Adam kernels take contiguous float32 CUDA vectors, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if x.numel() != n or x.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: {x.numel()} elements at offset {x.data_ptr() % 16} "
                             f"from 16 bytes; the kernels take {n}, 16-byte aligned")


def _check_scalar(name: str, x: Optional[torch.Tensor], dtype: torch.dtype,
                  device: torch.device) -> int:
    """The device address of a 0-dim ``dtype`` scalar on ``device`` (0 for None)."""
    if x is None:
        return 0
    if x.dtype != dtype or x.dim() != 0 or x.device != device:
        raise ValueError(f"{name}: a {dtype} scalar on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    return x.data_ptr()


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: " + lib.mst_adam_error_string(err).decode())


def grad_stats(grad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of grad * grad as float32 [], every element finite as bool []),
    on the device: kernel A (two launches) on a flat CUDA float32 vector."""
    n = grad.numel()
    _check_vectors(n, grad=grad)
    grid = grid_of(n, _sms(grad.device), "stats")
    partial = torch.empty(grid, dtype=torch.float64, device=grad.device)
    sq = torch.empty((), dtype=torch.float32, device=grad.device)
    finite = torch.empty((), dtype=torch.bool, device=grad.device)
    lib = _library()
    err = lib.mst_grad_stats(grad.data_ptr(), n, partial.data_ptr(), grid, sq.data_ptr(),
                             finite.data_ptr(), torch.cuda.current_stream(grad.device).cuda_stream)
    _raise_on(lib, err, "mst_grad_stats")
    grad_stats.launches += 1
    return sq, finite


def grad_stats_reference(grad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``grad_stats``'s plain version: the sum in double, rounded once."""
    total = torch.sum(grad.double() * grad.double())
    return total.float(), torch.isfinite(total)


def adam_update(flat: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, grad: torch.Tensor,
                rate: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor, *, b1: float,
                b2: float, eps: float, clip: Optional[float] = None,
                max_norm: Optional[float] = None, norm: Optional[torch.Tensor] = None,
                wd: float = 0.0, adamw_wd: float = 0.0,
                apply: Optional[torch.Tensor] = None) -> None:
    """One Adam step in place on the optimizer's flat buffers (kernel B):
    ``flat`` -= the bias-corrected step at the rate ``-rate``, ``mu`` and
    ``nu`` the new moments. ``rate`` (already negative), ``bc1`` = 1 - b1^t
    and ``bc2`` = 1 - b2^t are float32 device scalars; ``norm`` (with
    ``max_norm``) the clipped gradient's global norm; ``apply`` the
    non-finite guard's bool device scalar (None: always): where it is False
    the moments stay and ``flat`` gets + 0."""
    n = flat.numel()
    _check_vectors(n, flat=flat, mu=mu, nu=nu, grad=grad)
    dev = flat.device
    if (norm is None) != (max_norm is None):
        raise ValueError("clip_global_norm takes both max_norm and the norm")
    ptrs = [_check_scalar(k, x, torch.float32, dev) for k, x in
            (("rate", rate), ("bc1", bc1), ("bc2", bc2))]
    apply_ptr = _check_scalar("apply", apply, torch.bool, dev)
    norm_ptr = _check_scalar("norm", norm, torch.float32, dev)
    consts = _Consts(b1=b1, one_minus_b1=1.0 - b1, b2=b2, one_minus_b2=1.0 - b2, eps=eps,
                     clip=0.0 if clip is None else clip,
                     max_norm=0.0 if max_norm is None else max_norm, wd=wd, adamw_wd=adamw_wd,
                     has_clip=int(clip is not None))
    lib = _library()
    err = lib.mst_adam_update(flat.data_ptr(), mu.data_ptr(), nu.data_ptr(), grad.data_ptr(), n,
                              ctypes.byref(consts), *ptrs, apply_ptr, norm_ptr,
                              grid_of(n, _sms(dev), "update"),
                              torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "mst_adam_update")
    adam_update.launches += 1


grad_stats.launches = 0
adam_update.launches = 0
adam_update.chain_cuda_runs = 0

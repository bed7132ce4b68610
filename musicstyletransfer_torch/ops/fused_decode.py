"""K1: the transformer decoder's whole sampled decode loop in one CUDA launch.

Replaces ``musicstyletransfer_tpu/ops/fused_decode.py::fused_decode`` (the
Pallas kernel built by ``_make_kernel``). The kernel is
``csrc/fused_decode.cu``; ``fused_decode_reference`` below is its plain
PyTorch version, built from the ``nn.Module`` decode step. ``fused_decode``
launches the kernel for CUDA tensors and takes the plain version only for
CPU tensors; it never falls back from one to the other.

What both compute, per row: position 0 consumes the conditioning state x0;
each step t >= 1 embeds the previous token (plus the class row under
``per_step`` conditioning), runs every layer (post-LN, or pre-LN with a final
LayerNorm) over the KV cache, runs the float32 vocab head, and picks the
next token: Gumbel-max over ``logits / temperature`` after top-k / top-p
filtering (``"sample"``), argmax (``"greedy"``) or the given token
(``"forced"``). Scores add -log p of the emitted token under the
unfiltered, untempered logits. A row is done at EOS and then emits PAD and
adds nothing.

Random numbers: Philox4x32-10 with counter (row, step, vocab index, 0) and
the 64-bit seed as key, bits mapped to uniforms strictly inside (0, 1) as
the JAX package's ``_uniform_from_bits`` does. The kernel and the plain
version draw the same noise, so their samples agree wherever their logits
round alike.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ..midi.vocab import EOS_ID, PAD_ID, SOS_ID

from ..models.transformer import sqrt_in
from . import _build

_NEG_INF = -1e30
# Bisection depth of the support-filter threshold search: 32 halvings
# close the whole int32 key range.
_FILTER_ITERS = 32
MODES = {"sample": 0, "greedy": 1, "forced": 2}

# ----------------------------------------------------------------------------
# Top-k / top-p support, sortless (JAX: fused_decode.py:195-271)


def float_sort_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> int32 keys (signed int order == float order);
    -0.0 is folded onto +0.0 first so the two zeros tie."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    i = x.contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def _threshold_key(keys: torch.Tensor, weights: torch.Tensor,
                   bound: float) -> torch.Tensor:
    """Per row, the least int32 t with sum(weights[keys > t]) < bound, by
    bisection; the midpoint floor((lo+hi)/2) is formed without overflow."""
    B = keys.shape[0]
    lo = torch.full((B, 1), -(2 ** 31), dtype=torch.int32, device=keys.device)
    hi = torch.full((B, 1), 2 ** 31 - 1, dtype=torch.int32, device=keys.device)
    zero = torch.zeros((), dtype=weights.dtype, device=keys.device)
    for _ in range(_FILTER_ITERS):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        g = torch.where(keys > mid, weights, zero).sum(-1, keepdim=True)
        below = g < bound
        hi = torch.where(below, mid, hi)
        lo = torch.where(below, lo, mid)
    return hi


def filter_support(scaled: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Top-k (ties kept) then top-p (the argmax always kept) on [B, V]
    float32 logits; filtered entries become -1e30. The keep sets equal
    ``inference.decode._filter_logits``'s."""
    if 0 < top_k < scaled.shape[-1]:
        keys = float_sort_keys(scaled)
        t = _threshold_key(keys, torch.ones_like(scaled), float(top_k))
        scaled = torch.where(keys >= t, scaled, _NEG_INF)
    if 0.0 < top_p < 1.0:
        keys = float_sort_keys(scaled)
        probs = torch.softmax(scaled, dim=-1)
        t = _threshold_key(keys, probs, top_p)
        scaled = torch.where(keys >= t, scaled, _NEG_INF)
    return scaled


# ----------------------------------------------------------------------------
# Philox4x32-10 in int64 arithmetic (the kernel's generator, for the CPU)

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for b < 2^32, without int64 overflow."""
    x = b * (a >> 16)
    y = b * (a & 0xFFFF)
    lo = (((x & 0xFFFF) << 16) + y) & _MASK32
    hi = (x + (y >> 16)) >> 16
    return hi, lo


def philox4x32(c0, c1, c2, c3, key0: int, key1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    words; returns the four output words."""
    k0, k1 = key0 & _MASK32, key1 & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Low 23 bits -> float32 uniforms strictly inside (0, 1)."""
    return (bits & 0x7FFFFF).to(torch.float32) * (2.0 ** -23) + 2.0 ** -24


def gumbel_steps(seed: int, first: int, count: int, batch: int, vocab: int,
                 device: torch.device) -> torch.Tensor:
    """[count, batch, vocab] Gumbel noise of the decode steps first ..
    first+count-1 (counter (row, step, vocab index, 0), key = the 64-bit
    seed)."""
    shape = (count, batch, vocab)
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    steps = torch.arange(first, first + count, dtype=torch.int64, device=device)
    rows = torch.arange(batch, dtype=torch.int64, device=device)
    cols = torch.arange(vocab, dtype=torch.int64, device=device)
    bits = philox4x32(rows[None, :, None] + zero, steps[:, None, None] + zero,
                      cols[None, None, :] + zero, zero, seed, seed >> 32)[0]
    return -torch.log(-torch.log(uniform_from_bits(bits)))


def gumbel_noise(seed: int, step: int, batch: int, vocab: int,
                 device: torch.device) -> torch.Tensor:
    """[batch, vocab] Gumbel noise of decode step ``step``."""
    return gumbel_steps(seed, step, 1, batch, vocab, device)[0]


# ----------------------------------------------------------------------------
# The plain PyTorch version


def _check_mode(mode: str, temperature: float) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if mode == "sample" and not temperature > 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")


NOISE_BLOCK = 64  # decode steps whose Gumbel noise ``decode_loop`` draws at once


def decode_loop(step, B: int, T: int, V: int, device: torch.device, seed: int,
                temperature: float = 1.0, mode: str = "sample",
                forced_tokens: Optional[torch.Tensor] = None, top_k: int = 0,
                top_p: float = 0.0):
    """The decode loop around ``step(tokens [B], t) -> logits [B, V]`` (the
    decoder's cached step at position t from the tokens at t - 1): the
    kernel's semantics, step by step. ``"sample"`` draws Gumbel-max over
    ``filter_support(logits / temperature)`` with the kernel's noise (drawn
    NOISE_BLOCK steps at a time by ``gumbel_steps``), ``"greedy"`` the
    argmax, ``"forced"`` the given tokens; scores add -log p of the emitted
    token under the unfiltered, untempered logits; a row is done at EOS and
    then emits PAD; sampling stops once every row is done.

    Returns (seqs [B, T] int32, scores [B] float32), plus logits [B, T, V]
    float32 in ``"forced"`` mode (row 0 zeros)."""
    _check_mode(mode, temperature)
    seqs = torch.full((B, T), PAD_ID, dtype=torch.int32, device=device)
    seqs[:, 0] = SOS_ID
    scores = torch.zeros(B, dtype=torch.float32, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    logits_out = (torch.zeros(B, T, V, dtype=torch.float32, device=device)
                  if mode == "forced" else None)
    for t in range(1, T):
        if mode != "forced" and bool(done.all()):
            break
        logits = step(seqs[:, t - 1].long(), t).float()
        if mode == "forced":
            logits_out[:, t] = logits
            nxt = forced_tokens[:, t].to(torch.int64)
        elif mode == "greedy":
            nxt = logits.argmax(-1)
        else:
            if (t - 1) % NOISE_BLOCK == 0:
                noise = gumbel_steps(seed, t, min(NOISE_BLOCK, T - t), B, V, device)
            scaled = filter_support(logits / temperature, top_k, top_p)
            nxt = (scaled + noise[(t - 1) % NOISE_BLOCK]).argmax(-1)
        nll = torch.logsumexp(logits, -1) - logits.gather(1, nxt[:, None])[:, 0]
        scores += torch.where(done, 0.0, nll)
        if mode != "forced":
            nxt = torch.where(done, PAD_ID, nxt)
            done = done | (nxt == EOS_ID)
        seqs[:, t] = nxt.to(torch.int32)
    if mode == "forced":
        return seqs, scores, logits_out
    return seqs, scores


@torch.inference_mode()
def fused_decode_reference(model, x0: torch.Tensor, max_len: int, seed: int,
                           temperature: float = 1.0, mode: str = "sample",
                           forced_tokens: Optional[torch.Tensor] = None,
                           top_k: int = 0, top_p: float = 0.0,
                           classes: Optional[torch.Tensor] = None):
    """The decode loop step by step through ``VAEDecoder.step_token``
    (``decode_loop``).

    Same interface and results as ``fused_decode``: (seqs [B, T] int32,
    scores [B] float32), plus logits [B, T, V] float32 in ``"forced"`` mode
    (row 0 zeros)."""
    _check_mode(mode, temperature)
    if x0.is_cuda:
        fused_decode_reference.cuda_runs += 1
    dec = model.decoder
    B, T = x0.shape[0], max_len
    cache = dec.decoder.init_cache(B, T)
    dec.decoder.step(x0, cache, 0)  # position 0: the conditioning state
    return decode_loop(lambda tokens, t: dec.step_token(tokens, cache, t, classes),
                       B, T, dec.config.output_dim, x0.device, seed, temperature, mode,
                       forced_tokens, top_k, top_p)


fused_decode_reference.cuda_runs = 0

# ----------------------------------------------------------------------------
# The kernel


class _Args(ctypes.Structure):
    """Mirror of ``MstFusedDecodeArgs`` in csrc/fused_decode.cu."""

    _fields_ = [
        ("x0", ctypes.c_void_p), ("pos", ctypes.c_void_p),
        ("emb", ctypes.c_void_p), ("wt", ctypes.c_void_p),
        ("wf", ctypes.c_void_p), ("step_bias", ctypes.c_void_p),
        ("forced", ctypes.c_void_p), ("cache", ctypes.c_void_p),
        ("seqs", ctypes.c_void_p), ("scores", ctypes.c_void_p),
        ("logits", ctypes.c_void_p),
        ("seed", ctypes.c_uint64),
        ("B", ctypes.c_int), ("T", ctypes.c_int), ("D", ctypes.c_int),
        ("H", ctypes.c_int), ("FF", ctypes.c_int), ("V", ctypes.c_int),
        ("NL", ctypes.c_int), ("mode", ctypes.c_int), ("pre_ln", ctypes.c_int),
        ("per_step", ctypes.c_int), ("top_k", ctypes.c_int),
        ("is_bf16", ctypes.c_int),
        ("top_p", ctypes.c_float), ("temperature", ctypes.c_float),
        ("scale", ctypes.c_float), ("head_scale", ctypes.c_float),
        ("rows", ctypes.c_int), ("cluster", ctypes.c_int), ("resident", ctypes.c_int),
        ("Dl", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_decode")
    if lib.mst_fused_decode.argtypes is None:
        lib.mst_fused_decode.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.mst_fused_decode.restype = ctypes.c_int
        lib.mst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mst_cuda_error_string.restype = ctypes.c_char_p
        lib.mst_fused_decode_clusters.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.mst_fused_decode_clusters.restype = ctypes.c_int
    return lib


_held: Dict[int, Dict[int, int]] = {}


def clusters_held(device: torch.device) -> Dict[int, int]:
    """{cluster size: the clusters of that size the card runs at once} for
    every size up to ``MAX_CLUSTER``, asked of the card once per device
    (``cudaOccupancyMaxActiveClusters`` for the kernel)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _held:
        lib = _library()
        held = {}
        with torch.cuda.device(index):
            for c in range(1, MAX_CLUSTER + 1):
                n = ctypes.c_int(0)
                err = lib.mst_fused_decode_clusters(c, ctypes.byref(n))
                if err != 0:
                    raise RuntimeError("cudaOccupancyMaxActiveClusters failed: "
                                       + lib.mst_cuda_error_string(err).decode())
                held[c] = n.value
        _held[index] = held
    return _held[index]


# ----------------------------------------------------------------------------
# The plan: rows a group, blocks a cluster, weights resident or streamed (a
# pure function of the shapes and of the clusters the card runs at once)

_WARPS = 8  # kThreads / 32 of csrc/fused_decode.cu
_MAX_ROWS, _LD_PAD = 16, 8
MAX_CLUSTER = 8  # kMaxCluster of the source: the portable cluster size
_SMEM_LIMIT = 232448 - 1024  # a block's shared memory, less the static part
# ``clusters_held`` of an H100 80GB HBM3 (scripts/k1-variants.py prints the
# card's): the default of ``plan`` where no card is asked.
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# Rates of the cost model of ``plan``, fitted to the H100's times of every
# plan at the three recipe decoders (scripts/k1-variants.py plans; PERF.md):
# the bytes one SM streams from L2/HBM a second while every SM does so, the
# card's memory rate, and the time of a position's chain of dependent phases.
_SM_BYTES_PER_S, _CARD_BYTES_PER_S, _POSITION_S = 20e9, 3.35e12, 30e-6


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_shapes(D: int, H: int, FF: int, V: int) -> None:
    """Raise ValueError for a decoder the kernel does not take: the heads
    must divide the model size, and the vocabulary must not be empty. Any
    other width is taken: ``padded_widths`` pads the products' inputs to
    pieces of 32, and a vocabulary above 320 (10 registers a lane) takes
    the token choice's loop over shared memory."""
    _require(H >= 1 and D >= 1 and D % H == 0,
             f"model size {D} is not a multiple of the {H} heads")
    _require(FF >= 1, f"FF width {FF} must be at least 1")
    _require(V >= 1, f"vocabulary {V} must hold at least one token")


def padded_widths(D: int, H: int, FF: int) -> Tuple[int, int]:
    """(Dp, FFp): the kernel's widths. Dp is the least multiple of 32 at or
    above D that the heads divide (each head padded from D/H to Dp/H
    dimensions), FFp FF rounded up to 32. The pads are zeros in the weights
    and activations, so every product is unchanged; LayerNorm takes its
    statistics over the D true columns. Dp == D and FFp == FF wherever D
    and FF are multiples of 32 (every recipe's decoder)."""
    step = 32 * H // math.gcd(32, H)
    return -(-D // step) * step, -(-FF // 32) * 32


def _split_of(n_tiles: int, K: int) -> int:
    return 1 if n_tiles >= _WARPS else min(_WARPS // n_tiles, K // 32)


def _nb_head(V: int, cluster: int) -> int:
    return ((V + cluster - 1) // cluster + 7) // 8 * 8


def slice_bytes(cluster: int, D: int, FF: int, V: int, NL: int, esize: int) -> int:
    """A block's resident weight slices (``Dims::slice_bytes`` in the
    source) at the kernel's widths D and FF: its rows of every layer's
    products, each padded by 64 bytes (``kSlicePad``), and its float32 rows
    of the head."""
    pad = 64 // esize
    layer = ((3 * D + D + FF) // cluster * (D + pad)) + D // cluster * (FF + pad)
    return NL * layer * esize + _nb_head(V, cluster) * (D + 16) * 4


def smem_bytes(rows: int, cluster: int, D: int, H: int, FF: int, V: int, esize: int,
               NL: int = 1, resident: bool = False) -> int:
    """Dynamic shared memory of a block (``smem_layout`` in the source) at
    the kernel's widths D and FF."""
    hd, hc = D // H, H // cluster
    nb = {"qkv": 3 * hc * hd, "o": D // cluster, "ff1": FF // cluster,
          "head": _nb_head(V, cluster)}
    part = max(_split_of(n // 8, k) * rows * n
               for n, k in ((nb["qkv"], D), (nb["o"], D), (nb["ff1"], D), (nb["o"], FF),
                            (nb["head"], D)))
    act = rows * (D + _LD_PAD) * esize
    sizes = [act, act, act, rows * (FF + _LD_PAD) * esize, rows * nb["qkv"] * 4,
             rows * V * 4, part * 4, rows * V * 4, _WARPS * 2 * 4, _WARPS * hd * 4,
             _MAX_ROWS * 4, _MAX_ROWS * 4, _MAX_ROWS * 4,
             slice_bytes(cluster, D, FF, V, NL, esize) if resident else 0]
    return sum((n + 15) // 16 * 16 for n in sizes)


def plan(B: int, D: int, H: int, FF: int, V: int, NL: int, T: int, esize: int,
         held: Optional[Dict[int, int]] = None) -> Dict[str, object]:
    """How the kernel decodes B rows: groups of ``rows`` rows (the last one
    ragged), each on a cluster of ``cluster`` blocks, with each block's
    weight slices ``resident`` in its shared memory or streamed from L2 at
    every position; ``D`` and ``FF`` of the result are the kernel's padded
    widths (``padded_widths``), which every size here counts. Raises
    ValueError for shapes the kernel does not take (``check_shapes``).

    The cluster is the largest size up to ``MAX_CLUSTER`` that divides the
    heads and leaves every block whole 8-column tiles. Weights are resident
    wherever a block's slices fit beside the group's buffers. Rows a group
    trade the bytes each group reads a position (the decoder's weights
    unless resident, and its rows' KV cache) against the clusters the card
    runs at once: the estimate of a position's time is the chain of its
    phases plus the larger of a block's bytes at one SM's rate and all
    blocks' bytes at the card's, times the waves of clusters (``held``: the
    clusters of each size the card runs at once, by default an H100's);
    the least estimate wins, a larger group on ties."""
    check_shapes(D, H, FF, V)
    D, FF = padded_widths(D, H, FF)
    hd = D // H
    cluster = next(c for c in range(MAX_CLUSTER, 0, -1)
                   if H % c == 0 and D % (8 * c) == 0 and FF % (8 * c) == 0)
    weights = NL * (4 * D * D + 2 * D * FF) * esize + D * V * 4
    keys = (T + 1) / 2  # mean keys a position attends to
    best = None
    for r in range(1, min(_MAX_ROWS, B) + 1):
        groups = -(-B // r)
        rows = -(-B // groups)  # the same groups, balanced
        resident = smem_bytes(rows, cluster, D, H, FF, V, esize, NL, True) <= _SMEM_LIMIT
        if not resident and smem_bytes(rows, cluster, D, H, FF, V, esize, NL) > _SMEM_LIMIT:
            continue
        streamed = 0 if resident else weights
        cache_row = NL * H * keys * hd * esize * 3  # K read twice, V once
        block = streamed / cluster + rows * cache_row / cluster
        card = groups * (streamed + rows * cache_row)
        waves = -(-groups // (held or H100_CLUSTERS)[cluster])
        est = waves * (_POSITION_S + max(block / _SM_BYTES_PER_S, card / _CARD_BYTES_PER_S))
        if best is None or est <= best[0]:
            best = (est, rows, groups, resident)
    if best is None:
        raise ValueError(f"no group of rows fits a block's shared memory at D={D}, FF={FF}")
    _, rows, groups, resident = best
    return {"rows": rows, "cluster": cluster, "groups": groups, "blocks": groups * cluster,
            "resident": resident, "D": D, "FF": FF,
            "smem": smem_bytes(rows, cluster, D, H, FF, V, esize, NL, resident)}


def plan_for(model, B: int, T: int) -> Dict[str, object]:
    """``plan`` at ``model``'s decoder shapes, on its card where it has one:
    the plan ``fused_decode`` launches."""
    tc = model.decoder.config.transformer_config
    held = clusters_held(model.device) if model.device.type == "cuda" else None
    return plan(B, tc.model_size, tc.num_heads, tc.model_size * tc.ffn_multiplier,
                model.decoder.config.output_dim, tc.num_layers, T,
                torch.finfo(model.compute_dtype).bits // 8, held)


# ----------------------------------------------------------------------------
# The weights in the kernel's layout

# Within every 32-wide piece of a bf16 weight row, lane q of an mma fragment
# finds (k = 2q, 2q+1, 2q+8, 2q+9) of the first k step and the same + 16 of
# the second at positions 8q .. 8q + 7: MMA_ORDER[p] is the k at position p.
MMA_ORDER = [16 * (e // 4) + 8 * ((e // 2) % 2) + 2 * q + e % 2
             for q in range(4) for e in range(8)]


def _mma_pack(w: torch.Tensor) -> torch.Tensor:
    N, K = w.shape
    return w.reshape(N, K // 32, 32)[:, :, MMA_ORDER].reshape(N, K)


def _mma_unpack(w: torch.Tensor) -> torch.Tensor:
    N, K = w.shape
    out = torch.empty_like(w).reshape(N, K // 32, 32)
    out[:, :, MMA_ORDER] = w.reshape(N, K // 32, 32)
    return out.reshape(N, K)


def _pad(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x`` with zeros appended along each dimension up to ``sizes``."""
    pads = []
    for d in reversed(range(x.dim())):
        pads += [0, sizes[d] - x.shape[d]]
    return torch.nn.functional.pad(x, pads) if any(pads) else x


def _pad_heads(x: torch.Tensor, dim: int, H: int, hdp: int) -> torch.Tensor:
    """``x`` with its H heads along ``dim`` (H * hd wide) each padded with
    zeros to hdp."""
    hd = x.shape[dim] // H
    if hd == hdp:
        return x
    split = list(x.shape[:dim]) + [H, hd] + list(x.shape[dim + 1:])
    y = _pad(x.reshape(split), *split[:dim + 1], hdp, *split[dim + 2:])
    return y.reshape(*x.shape[:dim], H * hdp, *x.shape[dim + 1:])


def _unpad_heads(x: torch.Tensor, dim: int, H: int, hd: int) -> torch.Tensor:
    hdp = x.shape[dim] // H
    split = list(x.shape[:dim]) + [H, hdp] + list(x.shape[dim + 1:])
    y = x.reshape(split).narrow(dim + 1, 0, hd)
    return y.reshape(*x.shape[:dim], H * hd, *x.shape[dim + 1:])


def pack_weights(model) -> Dict[str, torch.Tensor]:
    """The decoder's weights in the kernel's layout, on the model's device,
    at the kernel's widths Dp and FFp (``padded_widths``; zeros in every pad).

    ``wt`` (compute dtype), per layer: Wqkv [3Dp, Dp] (the rows of w_q, w_k,
    w_v, each head's rows padded to Dp/H), Wo [Dp, Dp] (its inputs padded
    by head), W1 [FFp, Dp], W2 [Dp, FFp] (PyTorch's [out, in]: a row per
    output, its inputs contiguous; in bf16 each 32-wide piece of a row in
    ``MMA_ORDER``), then bqkv, bo, b1, b2. ``wf`` (float32): per layer ln1
    scale/bias, ln2 scale/bias; then the final LayerNorm's scale/bias
    (ones/zeros under post-LN); then the head [V, Dp] and its bias. ``emb``
    and ``pos`` are padded to Dp too. Built once per model and reused while
    the parameters are unchanged (keyed by their storage and version
    counters); ``unpack_weights`` inverts it."""
    dec = model.decoder
    params = list(dec.parameters())
    key = tuple((p.device, p.data_ptr(), p._version) for p in params)
    cached = getattr(model, "_fused_decode_pack", None)
    if cached is not None and cached["key"] == key:
        return cached
    dt = model.compute_dtype
    order = _mma_pack if dt == torch.bfloat16 else (lambda w: w)
    stack = dec.decoder
    tc = stack.config
    D, H, FF = tc.model_size, tc.num_heads, tc.model_size * tc.ffn_multiplier
    Dp, FFp = padded_widths(D, H, FF)
    hdp = Dp // H
    wt, wf = [], []

    def qkv_rows(*ws):
        return torch.cat([_pad_heads(w, 0, H, hdp) for w in ws])

    with torch.no_grad():
        for layer in stack.layers:
            att, ff = layer.attention, layer.ff
            wqkv = _pad(qkv_rows(att.w_q.weight, att.w_k.weight, att.w_v.weight), 3 * Dp, Dp)
            wo = _pad(_pad_heads(att.w_o.weight, 1, H, hdp), Dp, Dp)
            wt += [order(w.to(dt)) for w in (wqkv, wo, _pad(ff.ff1.weight, FFp, Dp),
                                             _pad(ff.ff2.weight, Dp, FFp))]
            wt += [qkv_rows(att.w_q.bias, att.w_k.bias, att.w_v.bias),
                   _pad(att.w_o.bias, Dp), _pad(ff.ff1.bias, FFp), _pad(ff.ff2.bias, Dp)]
            wf += [_pad(w, Dp) for w in (layer.ln1.weight, layer.ln1.bias,
                                         layer.ln2.weight, layer.ln2.bias)]
        if tc.norm_scheme == "pre":
            wf += [_pad(stack.final_ln.weight, Dp), _pad(stack.final_ln.bias, Dp)]
        else:
            wf += [_pad(torch.ones(D, device=wf[0].device), Dp), torch.zeros_like(wf[0])]
        wf += [_pad(dec.output_layer.weight, dec.config.output_dim, Dp), dec.output_layer.bias]
        pack = {
            "key": key,
            "dims": (D, H, FF, Dp, FFp),
            "wt": torch.cat([w.reshape(-1).to(dt) for w in wt]).contiguous(),
            "wf": torch.cat([w.reshape(-1) for w in wf]).float().contiguous(),
            "emb": _pad(dec.token_emb.weight.to(dt), dec.config.output_dim, Dp).contiguous(),
            "pos": _pad(stack.pos_table, stack.pos_table.shape[0], Dp).contiguous(),
            "scale": float(stack.scale),
            "head_scale": float(sqrt_in(D // H, dt)),
        }
    model._fused_decode_pack = pack
    return pack


def padded_weights(pack: Dict[str, torch.Tensor], NL: int, V: int) -> Dict[str, torch.Tensor]:
    """The tensors of a pack as the kernel reads them, at the padded widths
    (``pack["dims"]``) and in [out, in] order: ``layers.{l}.{wqkv,wo,w1,w2}``,
    ``layers.{l}.{bqkv,bo,b1,b2,ln1s,ln1b,ln2s,ln2b}``, ``final_lns``,
    ``final_lnb``, ``head`` [V, Dp] and ``head_b``."""
    wt, wf = pack["wt"], pack["wf"]
    _, _, _, Dp, FFp = pack["dims"]
    unorder = _mma_unpack if wt.dtype == torch.bfloat16 else (lambda w: w)
    out, i, j = {}, 0, 0

    def take(src, at, n):
        return src[at:at + n], at + n

    for l in range(NL):
        for name, (rows, cols) in (("wqkv", (3 * Dp, Dp)), ("wo", (Dp, Dp)), ("w1", (FFp, Dp)),
                                   ("w2", (Dp, FFp))):
            w, i = take(wt, i, rows * cols)
            out[f"layers.{l}.{name}"] = unorder(w.reshape(rows, cols))
        for name, n in (("bqkv", 3 * Dp), ("bo", Dp), ("b1", FFp), ("b2", Dp)):
            out[f"layers.{l}.{name}"], i = take(wt, i, n)
        for name in ("ln1s", "ln1b", "ln2s", "ln2b"):
            out[f"layers.{l}.{name}"], j = take(wf, j, Dp)
    out["final_lns"], j = take(wf, j, Dp)
    out["final_lnb"], j = take(wf, j, Dp)
    head, j = take(wf, j, V * Dp)
    out["head"] = head.reshape(V, Dp)
    out["head_b"], j = take(wf, j, V)
    if i != wt.numel() or j != wf.numel():
        raise ValueError("the pack does not hold these shapes")
    return out


def unpack_weights(pack: Dict[str, torch.Tensor], D: int, FF: int, NL: int, V: int
                   ) -> Dict[str, torch.Tensor]:
    """The plain inverse of ``pack_weights``: ``padded_weights`` with the
    pads removed, at the model's widths D and FF."""
    D_, H, FF_, Dp, FFp = pack["dims"]
    if (D_, FF_) != (D, FF):
        raise ValueError(f"the pack holds D={D_}, FF={FF_}, not D={D}, FF={FF}")
    hd = D // H

    def qkv(w):  # [3Dp, ...] -> [3D, ...], each head's pad removed
        return torch.cat([_unpad_heads(part, 0, H, hd) for part in w.chunk(3)])

    out = {}
    for name, w in padded_weights(pack, NL, V).items():
        kind = name.rsplit(".", 1)[-1]
        if kind == "wqkv":
            w = qkv(w)[:, :D]
        elif kind == "bqkv":
            w = qkv(w)
        elif kind == "wo":
            w = _unpad_heads(w[:D], 1, H, hd)
        elif kind == "w1":
            w = w[:FF, :D]
        elif kind == "w2":
            w = w[:D, :FF]
        elif kind == "b1":
            w = w[:FF]
        elif kind == "head":
            w = w[:, :D]
        elif kind != "head_b":
            w = w[:D]
        out[name] = w
    return out


def fused_decode(model, x0: torch.Tensor, max_len: int, seed: int,
                 temperature: float = 1.0, mode: str = "sample",
                 forced_tokens: Optional[torch.Tensor] = None,
                 top_k: int = 0, top_p: float = 0.0,
                 classes: Optional[torch.Tensor] = None):
    """Run the decode loop: on a CUDA ``x0`` as one launch of the kernel, on
    a CPU ``x0`` through ``fused_decode_reference``.

    model: a transformer-decoder ``StyleVAE``; x0: [B, D] conditioning state
    (``model.decode_init(z, classes)``) in the model's compute dtype; seed:
    the Philox key (``"sample"`` mode); classes: [B] int, needed under
    ``per_step`` conditioning; forced_tokens: [B, max_len] int32
    (``"forced"`` mode).

    Returns (seqs [B, max_len] int32 with SOS at 0 and PAD after EOS,
    scores [B] float32), plus logits [B, max_len, V] float32 in
    ``"forced"`` mode (row 0 zeros). The kernel decodes the rows in the
    groups and clusters of ``plan``, at the padded widths of
    ``padded_widths`` (x0 and the class rows are padded here); ``plan``
    raises for a decoder the kernel does not take (``check_shapes``)."""
    if not x0.is_cuda:
        return fused_decode_reference(model, x0, max_len, seed, temperature,
                                      mode, forced_tokens, top_k, top_p, classes)
    _check_mode(mode, temperature)
    dec = model.decoder
    cfg = dec.config
    tc = cfg.transformer_config
    dt = model.compute_dtype
    B, D, V, T = x0.shape[0], tc.model_size, cfg.output_dim, max_len
    dev = x0.device
    _require(dt in (torch.float32, torch.bfloat16),
             f"compute dtype {dt} is not supported by the kernel")
    _require(x0.dtype == dt and x0.shape == (B, D) and x0.is_contiguous(),
             f"x0 must be a contiguous [B, {D}] {dt} tensor, got "
             f"{tuple(x0.shape)} {x0.dtype}")
    _require(model.device == dev, f"model on {model.device}, x0 on {dev}")
    _require(1 <= T <= tc.max_positions,
             f"max_len {T} outside [1, {tc.max_positions}]")
    forced = None
    if mode == "forced":
        _require(forced_tokens is not None, "forced mode needs forced_tokens")
        forced = forced_tokens
        _require(forced.dtype == torch.int32 and forced.shape == (B, T)
                 and forced.is_contiguous() and forced.device == dev,
                 f"forced_tokens must be a contiguous [B, {T}] int32 tensor on {dev}")
        _require(0 <= int(forced.min()) and int(forced.max()) < V,
                 f"forced_tokens must lie in [0, {V})")
    step_bias = None
    if dec.per_step_conditioning:
        _require(classes is not None and classes.shape == (B,)
                 and classes.device == dev,
                 f"per_step conditioning needs classes [B] on {dev}")
        step_bias = dec.step_bias(classes)

    NL, FF, H = tc.num_layers, D * tc.ffn_multiplier, tc.num_heads
    p = plan(B, D, H, FF, V, NL, T, x0.element_size(), clusters_held(dev))
    Dp, FFp = p["D"], p["FF"]
    pack = pack_weights(model)
    x0 = _pad(x0, B, Dp).contiguous()
    if step_bias is not None:
        step_bias = _pad(step_bias, B, Dp).contiguous()
    cache = torch.empty(NL * 2 * B * T * Dp, dtype=dt, device=dev)  # [NL, 2, B, H, T, Dp/H]
    seqs = torch.full((B, T), PAD_ID, dtype=torch.int32, device=dev)
    scores = torch.zeros(B, dtype=torch.float32, device=dev)
    logits = (torch.zeros(B, T, V, dtype=torch.float32, device=dev)
              if mode == "forced" else None)

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = _Args(
        x0=ptr(x0), pos=ptr(pack["pos"]), emb=ptr(pack["emb"]),
        wt=ptr(pack["wt"]), wf=ptr(pack["wf"]), step_bias=ptr(step_bias),
        forced=ptr(forced), cache=ptr(cache), seqs=ptr(seqs),
        scores=ptr(scores), logits=ptr(logits),
        seed=int(seed) & ((1 << 64) - 1),
        B=B, T=T, D=Dp, H=H, FF=FFp, V=V, NL=NL, mode=MODES[mode],
        pre_ln=int(tc.norm_scheme == "pre"), per_step=int(step_bias is not None),
        top_k=int(top_k), is_bf16=int(dt == torch.bfloat16),
        top_p=float(top_p), temperature=float(temperature),
        scale=pack["scale"], head_scale=pack["head_scale"],
        rows=p["rows"], cluster=p["cluster"], resident=int(p["resident"]), Dl=D,
    )
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mst_fused_decode(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError("fused_decode kernel launch failed: "
                           + lib.mst_cuda_error_string(err).decode())
    fused_decode.launches += 1
    if mode == "forced":
        return seqs, scores, logits
    return seqs, scores


fused_decode.launches = 0

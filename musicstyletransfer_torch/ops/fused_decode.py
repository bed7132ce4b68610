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


def gumbel_noise(seed: int, step: int, batch: int, vocab: int,
                 device: torch.device) -> torch.Tensor:
    """[batch, vocab] Gumbel noise of decode step ``step`` (counter (row,
    step, vocab index, 0), key = the 64-bit seed)."""
    rows = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(vocab, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros_like(cols)
    bits = philox4x32(rows, zero + step, cols, zero, seed, seed >> 32)[0]
    return -torch.log(-torch.log(uniform_from_bits(bits)))


# ----------------------------------------------------------------------------
# The plain PyTorch version


def _check_mode(mode: str, temperature: float) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if mode == "sample" and not temperature > 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")


@torch.inference_mode()
def fused_decode_reference(model, x0: torch.Tensor, max_len: int, seed: int,
                           temperature: float = 1.0, mode: str = "sample",
                           forced_tokens: Optional[torch.Tensor] = None,
                           top_k: int = 0, top_p: float = 0.0,
                           classes: Optional[torch.Tensor] = None):
    """The decode loop step by step through ``VAEDecoder.step_token``.

    Same interface and results as ``fused_decode``: (seqs [B, T] int32,
    scores [B] float32), plus logits [B, T, V] float32 in ``"forced"`` mode
    (row 0 zeros)."""
    _check_mode(mode, temperature)
    if x0.is_cuda:
        fused_decode_reference.cuda_runs += 1
    dec = model.decoder
    B, T, V = x0.shape[0], max_len, dec.config.output_dim
    dev = x0.device
    cache = dec.decoder.init_cache(B, T)
    dec.decoder.step(x0, cache, 0)  # position 0: the conditioning state
    seqs = torch.full((B, T), PAD_ID, dtype=torch.int32, device=dev)
    seqs[:, 0] = SOS_ID
    scores = torch.zeros(B, dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    logits_out = (torch.zeros(B, T, V, dtype=torch.float32, device=dev)
                  if mode == "forced" else None)
    for t in range(1, T):
        if mode != "forced" and bool(done.all()):
            break
        logits = dec.step_token(seqs[:, t - 1], cache, t, classes)
        if mode == "forced":
            logits_out[:, t] = logits
            nxt = forced_tokens[:, t].to(torch.int64)
        elif mode == "greedy":
            nxt = logits.argmax(-1)
        else:
            scaled = filter_support(logits / temperature, top_k, top_p)
            nxt = (scaled + gumbel_noise(seed, t, B, V, dev)).argmax(-1)
        nll = torch.logsumexp(logits, -1) - logits.gather(1, nxt[:, None])[:, 0]
        scores += torch.where(done, 0.0, nll)
        if mode != "forced":
            nxt = torch.where(done, PAD_ID, nxt)
            done = done | (nxt == EOS_ID)
        seqs[:, t] = nxt.to(torch.int32)
    if mode == "forced":
        return seqs, scores, logits_out
    return seqs, scores


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
    ]


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_decode")
    if lib.mst_fused_decode.argtypes is None:
        lib.mst_fused_decode.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.mst_fused_decode.restype = ctypes.c_int
        lib.mst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pack_weights(model) -> Dict[str, torch.Tensor]:
    """The decoder's weights in the kernel's layout, on the model's device.

    ``wt`` (compute dtype), per layer: Wqkv [D, 3D], Wo [D, D], W1 [D, FF],
    W2 [FF, D] (flax's [in, out] layout, so neighbouring threads read
    neighbouring output columns), then bqkv, bo, b1, b2. ``wf`` (float32):
    per layer ln1 scale/bias, ln2 scale/bias; then the final LayerNorm's
    scale/bias (ones/zeros under post-LN); then the head [D, V] and its
    bias. Built once per model and reused while the parameters are
    unchanged (keyed by their storage and version counters)."""
    dec = model.decoder
    params = list(dec.parameters())
    key = tuple((p.device, p.data_ptr(), p._version) for p in params)
    cached = getattr(model, "_fused_decode_pack", None)
    if cached is not None and cached["key"] == key:
        return cached
    dt = model.compute_dtype
    stack = dec.decoder
    D = stack.config.model_size
    wt, wf = [], []
    with torch.no_grad():
        for layer in stack.layers:
            att, ff = layer.attention, layer.ff
            wqkv = torch.cat([att.w_q.weight, att.w_k.weight, att.w_v.weight]).t()
            wt += [wqkv, att.w_o.weight.t(), ff.ff1.weight.t(), ff.ff2.weight.t(),
                   torch.cat([att.w_q.bias, att.w_k.bias, att.w_v.bias]),
                   att.w_o.bias, ff.ff1.bias, ff.ff2.bias]
            wf += [layer.ln1.weight, layer.ln1.bias, layer.ln2.weight,
                   layer.ln2.bias]
        if stack.config.norm_scheme == "pre":
            wf += [stack.final_ln.weight, stack.final_ln.bias]
        else:
            wf += [torch.ones_like(wf[0]), torch.zeros_like(wf[0])]
        wf += [dec.output_layer.weight.t(), dec.output_layer.bias]
        pack = {
            "key": key,
            "wt": torch.cat([w.reshape(-1) for w in wt]).to(dt).contiguous(),
            "wf": torch.cat([w.reshape(-1) for w in wf]).float().contiguous(),
            "emb": dec.token_emb.weight.to(dt).contiguous(),
            "pos": stack.pos_table.contiguous(),
            "scale": float(stack.scale),
            "head_scale": float(sqrt_in(D // stack.config.num_heads, dt)),
        }
    model._fused_decode_pack = pack
    return pack


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


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
    ``"forced"`` mode (row 0 zeros).
    """
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
        step_bias = dec.step_bias(classes).contiguous()

    pack = pack_weights(model)
    NL, FF = tc.num_layers, D * tc.ffn_multiplier
    cache = torch.empty(NL * 2 * B * T * D, dtype=dt, device=dev)
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
        B=B, T=T, D=D, H=tc.num_heads, FF=FF, V=V, NL=NL, mode=MODES[mode],
        pre_ln=int(tc.norm_scheme == "pre"), per_step=int(step_bias is not None),
        top_k=int(top_k), is_bf16=int(dt == torch.bfloat16),
        top_p=float(top_p), temperature=float(temperature),
        scale=pack["scale"], head_scale=pack["head_scale"],
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

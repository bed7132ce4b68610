"""The work of a training step of the VAE with one Mellum2 period as its
decoder (``configs/vae_mellum2.json``), counted from shapes and lengths, for
``train_mfu.mellum2``, ``flash_roofline.mellum2`` and
``expert_gemm_roofline.mellum2``. Peaks and conventions are ``counts``'s: 2
FLOPs a multiply-accumulate, a backward twice its forward.
"""

from __future__ import annotations

import functools
from typing import Iterable, List

import numpy as np

import counts


def _dec(cfg: dict) -> dict:
    """The decoder's widths: the configuration's top level, under the
    published configuration's own keys."""
    return cfg


@functools.lru_cache(maxsize=None)
def _row_pairs(n: int, T: int, causal: bool, window: int) -> int:
    n = max(0, min(n, T))
    if not causal:
        return n * T
    q = np.arange(T)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(T, np.int64)
    return int(np.maximum(np.minimum(q, n - 1) - lo + 1, 0).sum())


def flash_pairs(key_lens: Iterable[int], T: int, causal: bool, window: int = 0) -> int:
    """Unmasked (query, key) pairs of one head: keys below the row's length,
    causal k <= q, and with a window W > 0 also k > q - W."""
    return sum(_row_pairs(int(n), T, causal, window) for n in key_lens)


def decoder_pairs(cfg: dict, key_lens: Iterable[int], T: int) -> List[int]:
    """Each decoder layer's pairs of one head, in layer order."""
    d = _dec(cfg)
    key_lens = list(key_lens)
    by_kind = {kind: flash_pairs(key_lens, T, True,
                                 d["sliding_window"] if kind == "sliding_attention" else 0)
               for kind in set(d["layer_types"])}
    return [by_kind[kind] for kind in d["layer_types"]]


def decoder_token_flops(cfg: dict) -> int:
    """Forward FLOPs of one position through the decoder's products: the
    attention projections, the router and the experts a position is routed
    to (``num_experts_per_tok`` of them, not all)."""
    d = _dec(cfg)
    D, H, Hkv, hd = d["hidden_size"], d["num_attention_heads"], d["num_key_value_heads"], d["head_dim"]
    proj = 2 * D * (H + 2 * Hkv) * hd + 2 * H * hd * D
    experts = d["num_experts_per_tok"] * 2 * 3 * D * d["moe_intermediate_size"]
    return len(d["layer_types"]) * (proj + 2 * D * d["num_experts"] + experts)


def train_step_flops(cfg: dict, seq_lens: Iterable[int]) -> int:
    """Model FLOPs of one training step over the non-PAD positions, forward
    and backward: the encoder as ``counts.encoder_flops``; the decoder's
    latent projection, products (active experts only) and attention pairs
    at the m = n + 1 valid positions, and the vocabulary head at m - 1."""
    d = _dec(cfg)
    D, H, hd = d["hidden_size"], d["num_attention_heads"], d["head_dim"]
    total = 0
    for n in seq_lens:
        m = n + 1
        attn = sum(4 * hd * H * p for p in decoder_pairs(cfg, [m], m))
        total += (counts.encoder_flops(cfg, n) + 2 * cfg["latent_dim"] * D
                  + m * decoder_token_flops(cfg) + attn + 2 * D * cfg["vocab_size"] * (m - 1))
    return 3 * total


def flash_bound_s(cfg: dict, key_lens_enc, key_lens_dec) -> float:
    """Bound of one step's K4 and K5 calls on every layer of both stacks:
    forward 4*hd FLOPs and one exponential a pair and head, backward 10*hd
    and one; bytes of q, out, dO and the gradients at the query heads, k, v
    and theirs at the K/V heads, each once, and lse."""
    B = len(key_lens_enc)
    e = counts.ESIZE[cfg["dtype"]]
    L = cfg["train"]["max_seq_len"]
    total = 0.0
    w = cfg["encoder"]
    H, hd, T = w["num_heads"], w["model_size"] // w["num_heads"], L + 1
    pairs = H * flash_pairs(key_lens_enc, T, False)
    fb, bb = counts.flash_bytes(B, T, H, hd, e)
    total += w["num_layers"] * (counts.bound_s(4 * hd * pairs, fb, cfg["dtype"], pairs)
                                + counts.bound_s(10 * hd * pairs, bb, cfg["dtype"], pairs))
    d = _dec(cfg)
    H, Hkv, hd, T = d["num_attention_heads"], d["num_key_value_heads"], d["head_dim"], L + 2
    q_bytes = B * T * H * hd * e
    kv_bytes = 2 * B * T * Hkv * hd * e
    lse = B * H * T * 4
    fb = 2 * q_bytes + kv_bytes + lse  # q, k, v read; out and lse written
    bb = 4 * q_bytes + 2 * kv_bytes + 2 * lse  # q, k, v, out, dO, lse, delta; dq, dk, dv
    for p in decoder_pairs(cfg, key_lens_dec, T):
        pairs = H * p
        total += (counts.bound_s(4 * hd * pairs, fb, cfg["dtype"], pairs)
                  + counts.bound_s(10 * hd * pairs, bb, cfg["dtype"], pairs))
    return total


def expert_gemm_bound_s(cfg: dict, rows: int) -> float:
    """Bound of one step's grouped expert products over ``rows`` routed
    rows a layer (every (position, expert) pair the kernels compute, PAD
    positions too): forward 2 rows 3 D F FLOPs, backward twice that; bytes
    of the experts' weights (each product's forward reads them once, its
    backward reads them and writes their gradient) and of the rows'
    operands and results; the larger of FLOPs at the bf16 peak and bytes."""
    d = _dec(cfg)
    D, Fw, E = d["hidden_size"], d["moe_intermediate_size"], d["num_experts"]
    e = counts.ESIZE[cfg["dtype"]]
    flops = 3 * 2 * rows * 3 * D * Fw
    weights = E * 3 * D * Fw * e
    acts = rows * (D + 2 * Fw + Fw + D) * e  # x in, gate|up out, h in, y out
    nbytes = weights + acts + 2 * (2 * weights + 2 * acts)
    return len(d["layer_types"]) * counts.bound_s(flops, nbytes, cfg["dtype"])

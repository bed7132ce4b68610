"""The work the inputs need, counted from shapes and lengths, whatever
implements it, and the card's peaks: the yardstick of every roofline and
``mfu`` metric.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 3.35 TB/s
HBM; exponentials 3.9 T/s (FlashAttention-3, section 3). Float32 has one
peak for every metric: the data sheet's dense TF32 tensor-core rate, 495
TFLOP/s, the most the card offers for products of float32 operands (the
CUDA cores give 67 TFLOP/s, and float32-exact routes through the tensor
cores, as three bf16 pieces an operand, at most 989 / 3 TFLOP/s), so no
float32 route can read above 100%. A model FLOP is a multiply or an add of the
model's products (2 per multiply-accumulate); a backward pass is twice its
forward.
"""

from __future__ import annotations

from typing import Iterable

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
PEAK_EXP = 3.9e12
ESIZE = {"bfloat16": 2, "float32": 4}


def dense_flops(w: dict) -> int:
    """Products of one position through one layer's projections and FFN."""
    D = w["model_size"]
    return 2 * (4 * D * D + 2 * D * D * w["ffn_multiplier"])


def encoder_flops(cfg: dict, n: int) -> int:
    """Forward model FLOPs of encoding one row of ``n`` valid tokens (SOS
    counted): every layer over the n positions, attention over n x n pairs,
    and the latent head at position 0."""
    w = cfg["encoder"]
    D = w["model_size"]
    per_layer = n * dense_flops(w) + 4 * D * n * n
    return w["num_layers"] * per_layer + 2 * D * 2 * cfg["latent_dim"]


def decoder_flops(cfg: dict, m: int) -> int:
    """Forward model FLOPs of the decoder over ``m`` valid positions (the
    conditioning one first), causal: the latent projection, every layer,
    attention over m(m+1)/2 pairs, and the vocabulary head at the m - 1
    positions that predict a token."""
    w = cfg["decoder"]
    D = w["model_size"]
    per_layer = m * dense_flops(w) + 4 * D * m * (m + 1) // 2
    return (2 * cfg["latent_dim"] * D + w["num_layers"] * per_layer
            + 2 * D * cfg["vocab_size"] * (m - 1))


def train_step_flops(cfg: dict, seq_lens: Iterable[int]) -> int:
    """Model FLOPs of one training step, forward and backward, over the
    non-PAD positions of a batch whose rows hold ``seq_lens`` tokens (SOS
    counted)."""
    return 3 * sum(encoder_flops(cfg, n) + decoder_flops(cfg, n + 1) for n in seq_lens)


def transfer_flops(cfg: dict, source_len: int, lasts: Iterable[int]) -> int:
    """Model FLOPs of one request: its source (``source_len`` tokens with
    SOS) encoded once for each target class, and each class's row decoded
    through its ``lasts`` position (its EOS, or the last one computed): the
    conditioning position 0 and steps 1..last, each over the positions so
    far."""
    lasts = list(lasts)
    return (len(lasts) * encoder_flops(cfg, source_len)
            + sum(decoder_flops(cfg, t + 1) for t in lasts))


def k1_bytes(cfg: dict, rows: int, T: int) -> int:
    """Bytes one fused decode must move at least: the decoder's weights once
    (layers, embeddings and latent rows in the compute dtype, the vocabulary
    head in float32), each row's conditioning state read, its token row
    [T] int32 and score written."""
    w = cfg["decoder"]
    D, FF, V = w["model_size"], w["model_size"] * w["ffn_multiplier"], cfg["vocab_size"]
    e = ESIZE[cfg["dtype"]]
    layer = 4 * D * D + 4 * D + 2 * D * FF + FF + D + 4 * D
    weights = (w["num_layers"] * layer + V * D + cfg["num_classes"] * D) * e + (D * V + V) * 4
    return weights + rows * (D * e + T * 4 + 4)


def flash_pairs(key_lens: Iterable[int], T: int, causal: bool, H: int) -> int:
    """Unmasked (query, key) pairs x heads of one attention call."""
    pairs = 0
    for n in key_lens:
        n = max(0, min(int(n), T))
        # causal: query q sees min(q + 1, n) keys
        pairs += n * (n + 1) // 2 + (T - n) * n if causal else n * T
    return pairs * H


def flash_bytes(B: int, T: int, H: int, hd: int, esize: int) -> tuple:
    """(forward, backward) bytes of one flash call: forward reads q, k, v and
    writes out and lse; backward reads q, k, v, out, dO, lse and writes dq,
    dk, dv."""
    qkv = B * T * H * 3 * hd * esize
    ctx = B * T * H * hd * esize
    lse = B * H * T * 4
    return qkv + ctx + lse + 4 * B, 2 * qkv + 2 * ctx + lse + 4 * B


def bound_s(flops: float, nbytes: float, dtype: str, exps: float = 0.0) -> float:
    """The least time: the largest of the products at the dtype's peak, the
    exponentials, and the bytes."""
    return max(flops / PEAK_FLOPS[dtype], exps / PEAK_EXP, nbytes / PEAK_BYTES)


def flash_bound_s(cfg: dict, key_lens_enc, key_lens_dec) -> float:
    """Bound of one training step's flash calls (K4 forward and K5 backward
    on every layer of both stacks): forward 4*hd FLOPs and one exponential a
    pair, backward 10*hd FLOPs and one exponential a pair."""
    total = 0.0
    B = len(key_lens_enc)
    e = ESIZE[cfg["dtype"]]
    L = cfg["train"]["max_seq_len"]
    for part, lens, T, causal in (("encoder", key_lens_enc, L + 1, False),
                                  ("decoder", key_lens_dec, L + 2, True)):
        w = cfg[part]
        H, hd = w["num_heads"], w["model_size"] // w["num_heads"]
        pairs = flash_pairs(lens, T, causal, H)
        fb, bb = flash_bytes(B, T, H, hd, e)
        total += w["num_layers"] * (bound_s(4 * hd * pairs, fb, cfg["dtype"], pairs)
                                    + bound_s(10 * hd * pairs, bb, cfg["dtype"], pairs))
    return total

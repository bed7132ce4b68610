"""Sampled autoregressive decode and style transfer (counterpart of
``musicstyletransfer_tpu/inference/decode.py``).

``decode_sampled`` runs the whole decode loop through ``ops.fused_decode``:
one launch of the CUDA kernel for tensors on the card, the plain PyTorch
loop for tensors on the CPU. Sampling is seeded by an integer (the kernel's
Philox key) rather than a JAX key; the same seed gives the same draws on
either route wherever the two compute the same logits.

Beam search is not ported yet (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.vae import StyleVAE
from ..ops.fused_decode import fused_decode

_NEG_INF = -1e30  # filtered-out logits (avoids inf-inf NaNs in softmax)


def _encode_deterministic(model: StyleVAE, tokens: torch.Tensor,
                          seq_lens: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """z = mu: deterministic encode at inference."""
    mu, _ = model.encode(tokens, seq_lens, classes)
    return mu


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Sort-based top-k / nucleus filtering (``decode.py:51-72``): top_k > 0
    keeps the k highest logits (ties kept); 0 < top_p keeps the smallest
    set whose cumulative probability reaches top_p (the argmax always
    kept). Filtered entries become -1e30. The kernel computes the same keep
    sets without a sort (``ops.fused_decode.filter_support``)."""
    if top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG_INF, logits)
    if top_p > 0.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        threshold = torch.where(keep, sorted_desc, torch.inf).amin(-1, keepdim=True)
        logits = torch.where(logits < threshold, _NEG_INF, logits)
    return logits


@torch.inference_mode()
def decode_sampled(model: StyleVAE, z: torch.Tensor, classes: torch.Tensor,
                   max_len: int, seed: int, temperature: float = 1.0,
                   top_k: int = 0, top_p: float = 0.0,
                   greedy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral decode from (z, classes): (seqs [B, max_len] int32 with SOS
    at 0 and PAD after EOS, scores [B] = sum of -log p of emitted tokens
    under the unfiltered, untempered distribution). ``greedy`` takes the
    argmax instead of sampling."""
    x0 = model.decode_init(z, classes).contiguous()
    return fused_decode(
        model, x0, max_len, seed, temperature,
        mode="greedy" if greedy else "sample",
        top_k=0 if greedy else top_k, top_p=0.0 if greedy else top_p,
        classes=classes,
    )


@torch.inference_mode()
def sample_sequences(model: StyleVAE, tokens: torch.Tensor, seq_lens: torch.Tensor,
                     classes: torch.Tensor, max_len: int, seed: int,
                     temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                     greedy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode + decode. tokens: [B, L+1] SOS-prefixed sources; classes: [B]
    target styles (style transfer = a different class than encoded)."""
    z = _encode_deterministic(model, tokens, seq_lens, classes)
    return decode_sampled(model, z, classes, max_len, seed, temperature,
                          top_k=top_k, top_p=top_p, greedy=greedy)


@torch.inference_mode()
def style_transfer_all_classes(model: StyleVAE, tokens: torch.Tensor,
                               seq_lens: torch.Tensor, max_len: int, num_classes: int,
                               seed: int, temperature: float = 1.0, top_k: int = 0,
                               top_p: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transfer a batch into every target class in one encode and one decode
    of C*B rows (the target class also conditions the encoder, as in the
    reference). Returns (seqs [C, B, max_len], scores [C, B])."""
    B = tokens.shape[0]
    C = num_classes
    classes = torch.arange(C, dtype=torch.long, device=tokens.device).repeat_interleave(B)
    seqs, scores = sample_sequences(
        model, tokens.repeat(C, 1), seq_lens.repeat(C), classes, max_len, seed,
        temperature, top_k=top_k, top_p=top_p,
    )
    return seqs.reshape(C, B, max_len), scores.reshape(C, B)

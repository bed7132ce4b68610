"""Sampled autoregressive decode and style transfer (counterpart of
``musicstyletransfer_tpu/inference/decode.py``).

``decode_sampled`` runs a transformer decoder's whole decode loop through
``ops.fused_decode``: one launch of the CUDA kernel for tensors on the card,
the plain PyTorch loop for tensors on the CPU. A decoder K1 does not take
(``StyleVAE.k1_decodes``: the LSTM, and a transformer block with grouped K/V
heads, a window, rotary positions, RMSNorm or experts) takes
``decode_stepwise``, a plain PyTorch step loop over the model's cached
``decode_step`` on either device (the JAX package's ``supports_fused_decode``
refuses the LSTM too, and its XLA loop decodes it). Sampling is seeded by an
integer (the kernel's Philox key) rather than a JAX key; the same seed gives
the same draws on every route wherever they compute the same logits.

``beam_search`` and ``decode_beam`` run the batched beam search step by
step through the model's cached ``decode_step`` (plain PyTorch: the JAX
package has no kernel for it either), reordering the cache rows of the
surviving hypotheses with ``index_select``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import tracing
from ..midi.vocab import EOS_ID, PAD_ID, SOS_ID
from ..models.vae import StyleVAE
from ..ops.fused_decode import decode_loop, fused_decode

_NEG_INF = -1e30  # filtered-out logits (avoids inf-inf NaNs in softmax)


def _encode_deterministic(model: StyleVAE, tokens: torch.Tensor,
                          seq_lens: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """z = mu: deterministic encode at inference."""
    with tracing.span("decode.encode"):
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
    mode = "greedy" if greedy else "sample"
    if not model.k1_decodes:
        return decode_stepwise(model, z, classes, max_len, seed, temperature, mode,
                               top_k=0 if greedy else top_k, top_p=0.0 if greedy else top_p)
    with tracing.span("decode.k1"):
        x0 = model.decode_init(z, classes).contiguous()
        return fused_decode(
            model, x0, max_len, seed, temperature, mode=mode,
            top_k=0 if greedy else top_k, top_p=0.0 if greedy else top_p,
            classes=classes,
        )


@torch.inference_mode()
def decode_stepwise(model: StyleVAE, z: torch.Tensor, classes: torch.Tensor, max_len: int,
                    seed: int, temperature: float = 1.0, mode: str = "sample",
                    forced_tokens: Optional[torch.Tensor] = None, top_k: int = 0,
                    top_p: float = 0.0):
    """The decode loop one step at a time through ``model.decode_step`` from
    ``model.decode_prefill`` (the route of every decoder K1 does not take): ``ops.fused_decode.
    decode_loop``, the kernel's semantics and noise. Returns (seqs [B,
    max_len] int32 with SOS at 0, scores [B] float32), plus logits [B,
    max_len, V] float32 in ``"forced"`` mode (row 0 zeros)."""
    cache = model.decode_prefill(z, classes, max_len)
    return decode_loop(lambda tokens, t: model.decode_step(tokens, cache, t, classes),
                       z.shape[0], max_len, model.decoder.config.output_dim, z.device, seed,
                       temperature, mode, forced_tokens, top_k, top_p)


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
                               top_p: float = 0.0, greedy: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transfer a batch into every target class in one encode and one decode
    of C*B rows (the target class also conditions the encoder, as in the
    reference); ``greedy`` takes the argmax. Returns (seqs [C, B, max_len],
    scores [C, B])."""
    B = tokens.shape[0]
    C = num_classes
    classes = torch.arange(C, dtype=torch.long, device=tokens.device).repeat_interleave(B)
    seqs, scores = sample_sequences(
        model, tokens.repeat(C, 1), seq_lens.repeat(C), classes, max_len, seed,
        temperature, top_k=top_k, top_p=top_p, greedy=greedy,
    )
    return seqs.reshape(C, B, max_len), scores.reshape(C, B)


@torch.inference_mode()
def beam_search(model: StyleVAE, tokens: torch.Tensor, seq_lens: torch.Tensor,
                classes: torch.Tensor, max_len: int, beam_size: int,
                length_penalty: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode + batched beam-search decode (``decode.py:304-327`` of the JAX
    package). ``length_penalty`` alpha > 0 ranks the final hypotheses by
    score / len^alpha (GNMT length normalization; 0 = the raw cumulative
    score). Returns (seqs [B, max_len] the best hypothesis of each row,
    scores [B])."""
    z = _encode_deterministic(model, tokens, seq_lens, classes)
    return decode_beam(model, z, classes, max_len, beam_size, length_penalty)


@torch.inference_mode()
def decode_beam(model: StyleVAE, z: torch.Tensor, classes: torch.Tensor, max_len: int,
                beam_size: int, length_penalty: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search from (z, classes), ``decode.py:330-426`` of the JAX
    package: K hypotheses a row, scores the cumulative -log p (lower is
    better), only beam 0 live at first so identical expansions do not tie,
    a finished hypothesis extends only with PAD at no cost, the top K of
    the K*V expansions kept each step (ties to the lower index, as
    ``lax.top_k``)."""
    B, K = z.shape[0], beam_size
    V = model.decoder.config.output_dim
    dev = z.device
    classes_rep = classes.repeat_interleave(K)
    cache = model.decode_prefill(z.repeat_interleave(K, dim=0), classes_rep, max_len + 1)
    seqs = torch.full((B * K, max_len), PAD_ID, dtype=torch.int32, device=dev)
    seqs[:, 0] = SOS_ID
    scores = torch.where(torch.arange(K, device=dev) == 0, 0.0, torch.inf).repeat(B, 1)
    offset = (torch.arange(B, device=dev) * K)[:, None]
    done = torch.zeros(B * K, dtype=torch.bool, device=dev)
    pad_only = torch.full((V,), torch.inf, device=dev)
    pad_only[PAD_ID] = 0.0
    t = 1
    while t < max_len and not bool(done.all()):
        logits = model.decode_step(seqs[:, t - 1].long(), cache, t, classes_rep)
        nll = -torch.log_softmax(logits.float(), dim=-1)
        nll = torch.where(done[:, None], pad_only[None, :], nll)
        folded = (scores.reshape(B * K, 1) + nll).reshape(B, K * V)
        order = torch.sort(folded, dim=-1, stable=True)
        scores, top = order.values[:, :K], order.indices[:, :K]
        src = (top // V + offset).reshape(B * K)
        word = (top % V).reshape(B * K)
        seqs = seqs.index_select(0, src)
        seqs[:, t] = word.to(torch.int32)
        # a transformer's (k, v) per layer, an LSTM's (c, h): rows reordered alike
        cache = [(k.index_select(0, src), v.index_select(0, src)) for k, v in cache]
        done = done.index_select(0, src) | (word == EOS_ID)
        t += 1
    seqs = seqs.reshape(B, K, max_len)
    if length_penalty > 0.0:
        # over the generated tokens only: the SOS at position 0 adds no score
        lens = ((seqs != PAD_ID).sum(-1) - 1).float()
        normed = scores / lens.clamp(min=1.0) ** length_penalty
        best = normed.argmin(-1)
        rows = torch.arange(B, device=dev)
        return seqs[rows, best], normed[rows, best]
    return seqs[:, 0], scores[:, 0]

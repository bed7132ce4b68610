"""Losses: PAD-masked token cross-entropy, the variational KL and the GAN
family's binary cross-entropy (counterpart of
``musicstyletransfer_tpu/training/loss.py:27-119``).

CE comes from logits via log-softmax; KL uses the (mu, logvar)
parameterisation; per-sample CE normalisation is "valid" (mean over
non-PAD positions) or "length" (mean over the whole time axis).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from ..midi.vocab import PAD_ID


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(q(z|x) || N(0, I)), summed over latent dims."""
    return 0.5 * torch.sum(torch.exp(logvar) + mu * mu - 1.0 - logvar, dim=-1)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         label_smoothing: float = 0.0,
                         normalize: str = "valid") -> torch.Tensor:
    """Per-sample cross-entropy [B] of logits [B, T, V] against labels [B, T];
    positions where ``labels == PAD_ID`` contribute zero."""
    logp = F.log_softmax(logits, dim=-1)
    V = logits.shape[-1]
    picked = logp.gather(-1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = label_smoothing / (V - 1)
        on = 1.0 - label_smoothing
        nll = -(on * picked + smooth * (logp.sum(-1) - picked))
    else:
        nll = -picked
    mask = (labels != PAD_ID).to(nll.dtype)
    masked = nll * mask
    if normalize == "valid":
        return masked.sum(-1) / mask.sum(-1).clamp_min(1.0)
    if normalize == "length":
        return masked.mean(-1)  # reference arithmetic (loss.py:23)
    raise ValueError(f"unknown normalize mode {normalize!r}")


def vae_loss(logits: torch.Tensor, labels: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, kl_weight: Union[float, torch.Tensor],
             label_smoothing: float = 0.0, normalize: str = "valid",
             free_bits: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total = mean CE + kl_weight * mean KL; ``free_bits`` > 0 floors the
    per-dimension KL before the sum. Returns (total, {ce_loss, kl_loss,
    total_loss}), all scalars."""
    ce = masked_cross_entropy(logits, labels, label_smoothing, normalize)
    if free_bits > 0.0:
        per_dim = 0.5 * (torch.exp(logvar) + mu * mu - 1.0 - logvar)
        kl = per_dim.clamp_min(free_bits).sum(-1)
    else:
        kl = kl_divergence(mu, logvar)
    total = ce.mean() + kl_weight * kl.mean()
    return total, {"ce_loss": ce.mean(), "kl_loss": kl.mean(), "total_loss": total}


def binary_cross_entropy(pred: torch.Tensor, label: torch.Tensor, from_sigmoid: bool = False,
                         label_smoothing: float = 0.0,
                         negative_label_downweighting: bool = True) -> torch.Tensor:
    """Per-sample BCE [B] (the mean over every non-batch axis) of logits, or
    of probabilities with ``from_sigmoid``, against labels in {0, 1}:
    labels smoothed towards 0.5 by ``label_smoothing``, both logs guarded by
    1e-12, and with ``negative_label_downweighting`` each sample's
    label-0 terms scaled by its count of 1-labels over its count of the
    others (``loss.py:97-119`` of the JAX package)."""
    if not from_sigmoid:
        pred = torch.sigmoid(pred)
    s_label = (1.0 - label_smoothing) * label + label_smoothing * 0.5
    bce = -(s_label * torch.log(1e-12 + pred) + (1.0 - s_label) * torch.log(1e-12 + (1.0 - pred)))
    if negative_label_downweighting:
        axes = tuple(range(1, label.dim()))
        n_pos = (label == 1.0).sum(dim=axes, keepdim=True)
        n_neg = (label != 1.0).sum(dim=axes, keepdim=True)
        downweight = n_pos / (n_neg + 1e-12)
        bce = torch.where(label == 0.0, downweight * bce, bce)
    return bce.mean(dim=tuple(range(1, bce.dim())))

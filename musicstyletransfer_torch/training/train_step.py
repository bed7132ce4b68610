"""One training step and the deterministic evaluation step (counterpart of
``musicstyletransfer_tpu/training/train_step.py:99-162, 347-401``).

A step is forward (training mode: reparameterised z, dropout), ``vae_loss``,
backward and one optimizer update. Its metrics are added to (sum, count)
device scalars that the caller carries from step to step, so the host waits
for the device only where it reads them (the trainer's log boundaries).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from ..midi.vocab import PAD_ID
from ..models.vae import StyleVAE
from .loss import kl_divergence, masked_cross_entropy, vae_loss
from .metrics import Pair, accumulate, step_metrics
from .optimizer import Adam


@dataclasses.dataclass(frozen=True)
class LossConfig:
    kl_weight: float = 1.0
    label_smoothing: float = 0.0
    normalize: str = "valid"
    # Linear KL warmup over this many steps (0 = constant kl_weight).
    kl_anneal_steps: int = 0
    # Per-dimension KL floor (posterior-collapse mitigation; 0 disables).
    free_bits: float = 0.0

    def kl_weight_at(self, step: int) -> float:
        if self.kl_anneal_steps <= 0:
            return self.kl_weight
        return self.kl_weight * min(step / self.kl_anneal_steps, 1.0)


def train_step(model: StyleVAE, optimizer: Adam, loss_config: LossConfig, step: int,
               metric_acc: Optional[Dict[str, Pair]], tokens: torch.Tensor,
               seq_lens: torch.Tensor, classes: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> Dict[str, Pair]:
    """One update of ``model`` (put in training mode) on one batch; ``step``
    is the number of steps taken before it (for the KL anneal). ``generator``
    draws eps and the dropout masks unless ``eps`` is given. Returns
    ``metric_acc`` plus this step's (sum, count) pairs, including the raw
    gradients' global norm."""
    model.train()
    logits, mu, logvar = model(tokens, seq_lens, classes, eps=eps, generator=generator)
    total, scalars = vae_loss(logits, labels, mu, logvar,
                              kl_weight=loss_config.kl_weight_at(step),
                              label_smoothing=loss_config.label_smoothing,
                              normalize=loss_config.normalize,
                              free_bits=loss_config.free_bits)
    for p in optimizer.params:
        p.grad = None
    total.backward()
    grad = optimizer.flat_grad()
    optimizer.step(grad)
    with torch.no_grad():
        metrics = step_metrics(logits.detach(), labels, {k: v.detach() for k, v in scalars.items()})
        one = torch.ones((), device=grad.device)
        metrics["grad_norm"] = (torch.sqrt(torch.sum(grad * grad)), one)
        return accumulate(metric_acc or {}, metrics)


@torch.no_grad()
def eval_step(model: StyleVAE, loss_config: LossConfig, tokens: torch.Tensor,
              seq_lens: torch.Tensor, classes: torch.Tensor, labels: torch.Tensor,
              n_valid: int) -> Dict[str, Pair]:
    """Deterministic evaluation (z = mu, no dropout) of one batch whose rows
    from ``n_valid`` on are wrap-padding duplicates, masked out of every
    metric; loss metrics are summed per valid row."""
    model.eval()
    logits, mu, logvar = model(tokens, seq_lens, classes)
    B = labels.shape[0]
    row_mask = torch.arange(B, device=labels.device) < n_valid
    labels = torch.where(row_mask[:, None], labels, PAD_ID)
    ce = masked_cross_entropy(logits, labels, loss_config.label_smoothing,
                              loss_config.normalize)
    kl = kl_divergence(mu, logvar)
    rm = row_mask.float()
    n = rm.sum()
    metrics = step_metrics(logits, labels, {})
    metrics["ce_loss"] = ((ce * rm).sum(), n)
    metrics["kl_loss"] = ((kl * rm).sum(), n)
    metrics["total_loss"] = (((ce + loss_config.kl_weight * kl) * rm).sum(), n)
    return metrics


def batch_tensors(batch, device: Union[str, torch.device]):
    """(tokens, seq_lens, classes, labels) of a host ``Batch`` as int64
    tensors on ``device``."""
    return tuple(torch.as_tensor(a).to(device=device, dtype=torch.long, non_blocking=True)
                 for a in (batch.tokens, batch.seq_lens, batch.classes, batch.labels))

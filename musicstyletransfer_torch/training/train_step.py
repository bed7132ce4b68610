"""One training step and the deterministic evaluation step (counterpart of
``musicstyletransfer_tpu/training/train_step.py:99-162, 347-401``).

A step is forward (training mode: reparameterised z, dropout), ``vae_loss``,
backward, under a mesh the gradient's reduction (``Optimizer.reduce_gradients``:
the mean over the data group, which is the global batch's gradient because
the loss is a batch mean of per-sample terms over equal local batches), and
one optimizer update. ``step_body`` runs it on a ``TrainState``
whose every tensor lives on the device and is updated in place: the step
count (the KL anneal's weight is computed from it on the device) and the
(sum, count) metric accumulators. Nothing in a step reads the device on the
host, so a CUDA graph can capture consecutive steps (``training/graph.py``)
and the host waits for the device only where it reads the metrics (the
trainer's log boundaries). ``train_step`` is the functional form of one
step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import torch

from ..convert import flax_names
from ..midi.vocab import PAD_ID
from ..models.vae import StyleVAE
from .loss import kl_divergence, masked_cross_entropy, vae_loss
from .metrics import Pair, accumulate, step_metrics
from .optimizer import Optimizer

# The metrics of a step, in the order of a TrainState's vectors (the JAX
# package's METRIC_KEYS, train_step.py:64).
METRIC_KEYS = ("ppl", "acc", "top5_acc", "ce_loss", "kl_loss", "total_loss", "grad_norm")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    kl_weight: float = 1.0
    label_smoothing: float = 0.0
    normalize: str = "valid"
    # Linear KL warmup over this many steps (0 = constant kl_weight).
    kl_anneal_steps: int = 0
    # Per-dimension KL floor (posterior-collapse mitigation; 0 disables).
    free_bits: float = 0.0

    def kl_weight_at(self, step: Union[int, torch.Tensor]):
        """The KL weight after ``step`` steps: a float for an int ``step``, a
        float32 device scalar for a device ``step`` (as the JAX package
        computes it inside its step)."""
        if self.kl_anneal_steps <= 0:
            return self.kl_weight
        if isinstance(step, torch.Tensor):
            return self.kl_weight * torch.clamp(step.float() / self.kl_anneal_steps, max=1.0)
        return self.kl_weight * min(step / self.kl_anneal_steps, 1.0)


def metric_names(model: StyleVAE, per_param_grad_norms: bool = False) -> list:
    """The names a step accumulates: ``METRIC_KEYS``, then with
    ``per_param_grad_norms`` one ``grad_norm/<flax path>`` per parameter (the
    JAX package's names, train_step.py:138-145)."""
    names = list(METRIC_KEYS)
    if per_param_grad_norms:
        names += [f"grad_norm/{n}" for n in flax_names(model)]
    return names


class TrainState:
    """The device state a training step updates in place: ``step`` (int64,
    the steps taken) and, for each of ``names``, a (sum, count) pair held
    in the float32 vectors ``sums`` and ``counts``."""

    def __init__(self, names: Sequence[str], device: Union[str, torch.device], step: int = 0):
        self.names = list(names)
        self.step = torch.full((), step, dtype=torch.int64, device=device)
        self.sums = torch.zeros(len(self.names), device=device)
        self.counts = torch.zeros(len(self.names), device=device)

    def metrics(self) -> Dict[str, Pair]:
        """{name: (sum, count)}, views of the accumulators."""
        return {n: (self.sums[i], self.counts[i]) for i, n in enumerate(self.names)}

    def reset_metrics(self) -> None:
        self.sums.zero_()
        self.counts.zero_()


def create_train_state(model: StyleVAE) -> TrainState:
    """A fresh ``TrainState`` for ``model`` on its device (the JAX package's
    state also carries the parameters and the optimizer's state, which the
    port's model and ``Optimizer`` hold)."""
    return TrainState(metric_names(model), model.device)


def make_train_step(model: StyleVAE, optimizer: Optimizer, loss_config: LossConfig,
                    mesh=None):
    """``step(state, tokens, seq_lens, classes, labels, generator=None)``:
    one ``step_body`` under ``mesh`` (its metrics accumulate in ``state``),
    returning ``state``."""
    from ..parallel.mesh import use_mesh

    def step(state: TrainState, tokens, seq_lens, classes, labels,
             generator: Optional[torch.Generator] = None) -> TrainState:
        with use_mesh(mesh):
            step_body(model, optimizer, loss_config, state, tokens, seq_lens, classes, labels,
                      generator)
        return state

    return step


def make_eval_step(model: StyleVAE, loss_config: LossConfig):
    """``eval(tokens, seq_lens, classes, labels, n_valid)``: ``eval_step``
    of ``model``."""

    def evaluate(tokens, seq_lens, classes, labels, n_valid: int) -> Dict[str, Pair]:
        return eval_step(model, loss_config, tokens, seq_lens, classes, labels, n_valid)

    return evaluate


def step_body(model: StyleVAE, optimizer: Optimizer, loss_config: LossConfig,
              state: TrainState, tokens: torch.Tensor, seq_lens: torch.Tensor,
              classes: torch.Tensor, labels: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              eps: Optional[torch.Tensor] = None) -> None:
    """One update of ``model`` (put in training mode) on one batch, with
    every effect in place: the parameters and the optimizer's state,
    ``state.step`` + 1, and this step's metrics added to ``state``'s
    accumulators (the raw gradients' global norm among them, and one norm
    per parameter where ``state`` names them). ``generator`` draws eps and
    the dropout masks unless ``eps`` is given."""
    model.train()
    logits, mu, logvar = model(tokens, seq_lens, classes, eps=eps, generator=generator)
    total, scalars = vae_loss(logits, labels, mu, logvar,
                              kl_weight=loss_config.kl_weight_at(state.step),
                              label_smoothing=loss_config.label_smoothing,
                              normalize=loss_config.normalize,
                              free_bits=loss_config.free_bits)
    for p in optimizer.params:
        p.grad = None
    total.backward()
    grad = optimizer.flat_grad()
    optimizer.reduce_gradients(grad)
    optimizer.step(grad)
    with torch.no_grad():
        metrics = step_metrics(logits.detach(), labels,
                               {k: v.detach() for k, v in scalars.items()})
        sums = [metrics[k][0].float() for k in METRIC_KEYS[:-1]]
        counts = [metrics[k][1].float() for k in METRIC_KEYS[:-1]]
        norms = torch.sqrt(optimizer.sq_sum(grad)).reshape(1)
        if len(state.names) > len(METRIC_KEYS):
            norms = torch.cat([norms, optimizer.param_norms(grad)])
        sums = torch.cat([torch.stack(sums), norms])
        counts = torch.cat([torch.stack(counts), torch.ones(len(norms), device=grad.device)])
        state.sums.add_(sums)
        state.counts.add_(counts)
        state.step.add_(1)


def train_step(model: StyleVAE, optimizer: Optimizer, loss_config: LossConfig, step: int,
               metric_acc: Optional[Dict[str, Pair]], tokens: torch.Tensor,
               seq_lens: torch.Tensor, classes: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> Dict[str, Pair]:
    """``step_body`` in functional form: ``step`` is the number of steps
    taken before this one (for the KL anneal); returns ``metric_acc`` plus
    this step's (sum, count) pairs."""
    state = TrainState(METRIC_KEYS, tokens.device, step)
    step_body(model, optimizer, loss_config, state, tokens, seq_lens, classes, labels,
              generator, eps)
    return accumulate(metric_acc or {}, state.metrics())


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

"""PAD-ignoring training metrics as (sum, count) pairs that stay on the
device (counterpart of ``musicstyletransfer_tpu/training/metrics.py``):
perplexity, accuracy and top-5 accuracy; ``MetricAccumulator`` adds them up
on the host at log boundaries; ``ScalarLog`` writes the logged scalars."""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..midi.vocab import PAD_ID

Pair = Tuple[torch.Tensor, torch.Tensor]


def masked_log_perplexity(logits: torch.Tensor, labels: torch.Tensor) -> Pair:
    """(sum of -log p(label), #valid); exp(sum/count) is the perplexity."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    mask = labels != PAD_ID
    return (nll * mask).sum(), mask.sum()


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> Pair:
    mask = labels != PAD_ID
    return ((logits.argmax(-1) == labels) & mask).sum(), mask.sum()


def masked_topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 5) -> Pair:
    """Label in the top k, by its rank: fewer than k entries outrank it,
    where an entry outranks it when greater, or equal at a lower index
    (``top_k``'s lowest-index-first tie rule)."""
    label_logit = logits.gather(-1, labels.long()[..., None])
    vocab_idx = torch.arange(logits.shape[-1], device=logits.device)
    outranked = ((logits > label_logit)
                 | ((logits == label_logit) & (vocab_idx < labels[..., None]))).sum(-1)
    mask = labels != PAD_ID
    return ((outranked < k) & mask).sum(), mask.sum()


def step_metrics(logits: torch.Tensor, labels: torch.Tensor,
                 loss_scalars: Dict[str, torch.Tensor]) -> Dict[str, Pair]:
    """Every per-step (sum, count) pair, all device tensors."""
    out: Dict[str, Pair] = {
        "ppl": masked_log_perplexity(logits, labels),
        "acc": masked_accuracy(logits, labels),
        "top5_acc": masked_topk_accuracy(logits, labels, k=5),
    }
    one = torch.ones((), device=logits.device)
    for name, val in loss_scalars.items():
        out[name] = (val, one)
    return out


def accumulate(acc: Dict[str, Pair], metrics: Dict[str, Pair]) -> Dict[str, Pair]:
    """acc + metrics, key by key, as float32 device scalars (no host sync)."""
    out = dict(acc)
    for k, (s, c) in metrics.items():
        s, c = s.detach().float(), c.detach().float()
        if k in out:
            s, c = out[k][0] + s, out[k][1] + c
        out[k] = (s, c)
    return out


class MetricAccumulator:
    """Host-side running (sum, count) store; ``get`` reports means, and
    exp(mean) for the log-space ``ppl``."""

    LOG_SPACE = {"ppl"}

    def __init__(self) -> None:
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, float] = {}

    def update(self, metrics: Dict[str, Pair]) -> None:
        """Fetch device pairs: one host sync for the whole dict."""
        names = list(metrics)
        if not names:
            return
        flat = torch.stack([torch.stack([metrics[n][0].float(), metrics[n][1].float()])
                            for n in names]).cpu().tolist()
        for name, (s, c) in zip(names, flat):
            self._sums[name] = self._sums.get(name, 0.0) + s
            self._counts[name] = self._counts.get(name, 0.0) + c

    def get(self) -> Dict[str, float]:
        out = {}
        for name, s in self._sums.items():
            c = self._counts[name]
            mean = s / c if c else float("nan")
            if name in self.LOG_SPACE:
                mean = math.exp(min(mean, 50.0))
            out[name] = mean
        return out


class ScalarLog:
    """Scalars of a run under ``logdir``: one JSON object a write appended to
    ``scalars.jsonl`` (the batch count under ``"step"``, a non-finite value
    as its string), and TensorBoard event files through tensorboardX where
    it imports, as the JAX trainers write them (``trainer.py:190-204``,
    ``gan_trainer.py:271-281``), each tag ``prefix`` + the scalar's name.
    tensorboardX is optional there and here: without it only the JSON lines
    are written."""

    def __init__(self, logdir: str, prefix: str = ""):
        self.logdir = logdir
        self.prefix = prefix
        self._writer = None
        self._opened = False

    def _tensorboard(self):
        if not self._opened:
            self._opened = True
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                print("tensorboardX not installed; TensorBoard scalars disabled "
                      f"({self.logdir}/scalars.jsonl is written)")
            else:
                self._writer = SummaryWriter(logdir=self.logdir)
        return self._writer

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        os.makedirs(self.logdir, exist_ok=True)
        line = {"step": int(step)}
        line.update({k: (v if math.isfinite(v) else str(v)) for k, v in scalars.items()})
        with open(os.path.join(self.logdir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")
        writer = self._tensorboard()
        if writer is not None:
            for k, v in scalars.items():
                writer.add_scalar(self.prefix + k, v, global_step=int(step))
            writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        self._opened = False

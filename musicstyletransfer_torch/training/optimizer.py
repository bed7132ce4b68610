"""The optimizer of the training CLI, optax's semantics written out in torch
(counterpart of ``musicstyletransfer_tpu/training/optimizer.py:38-111``).

``--optimizer-params`` "k1:v1,k2:v2" extras, applied in optax's order:

- ``clip_gradient:c``: elementwise clip to [-c, c] (MXNet semantics);
- ``clip_global_norm:n``: scale by n / ||g|| when ||g|| >= n;
- Adam (``beta1``, ``beta2``, ``epsilon``): bias-corrected moments, eps
  outside the sqrt;
- the learning rate: constant, ``warmup_steps`` linear from 0, and/or
  ``decay_steps`` cosine to 0, evaluated at optax's count (the number of
  updates applied before this one, so a warmup's first step has rate 0);
- ``skip_nonfinite:K`` (``optax.apply_if_finite`` around the whole chain):
  a step whose RAW gradients hold a NaN or Inf applies nothing and leaves
  the Adam moments and counts untouched; after K such steps in a row the
  next one is applied anyway.

Every decision is a device tensor, so a step never waits for the host. The
parameters are re-pointed into one flat float32 buffer, and the moments are
flat buffers too: a step is a few whole-buffer operations whatever the
number of tensors. ``adamw``, ``sgd``, ``rmsprop`` and ``wd`` are not ported
yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch


@dataclasses.dataclass
class OptimizerConfig:
    optimizer: str = "adam"
    optimizer_params: str = ""
    learning_rate: float = 3e-4

    def params_to_dict(self) -> Dict[str, float]:
        """Parse "k1:v1,k2:v2"; pairs with != 1 delimiter are ignored
        (reference: trainer.py:23-35)."""
        out: Dict[str, float] = {}
        for key_val in self.optimizer_params.strip().split(","):
            parts = key_val.split(":")
            if len(parts) != 2:
                continue
            out[str(parts[0])] = float(parts[1])
        return out


class Adam:
    """Adam over ``params`` (which it re-points into one flat buffer) with
    the clips, the schedule and the non-finite guard of ``OptimizerConfig``."""

    def __init__(self, params: List[torch.nn.Parameter], config: OptimizerConfig):
        extra = config.params_to_dict()
        name = config.optimizer.lower()
        if name != "adam":
            raise NotImplementedError(
                f"--optimizer {config.optimizer} is not ported to PyTorch yet "
                "(ROADMAP queue 1, item 4); the training recipes use adam")
        if extra.get("wd", extra.get("weight_decay", 0.0)):
            raise NotImplementedError("the wd / weight_decay extra is not ported to "
                                      "PyTorch yet (ROADMAP queue 1, item 4)")
        self.clip = extra.get("clip_gradient")
        self.max_norm = extra.get("clip_global_norm")
        self.skip_nonfinite = int(extra.get("skip_nonfinite", 0))
        self.warmup = int(extra.get("warmup_steps", 0))
        self.decay = int(extra.get("decay_steps", 0))
        self.peak = float(config.learning_rate)
        self.b1 = float(extra.get("beta1", 0.9))
        self.b2 = float(extra.get("beta2", 0.999))
        self.eps = float(extra.get("epsilon", 1e-8))

        self.params = list(params)
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(-1).float() for p in self.params])
            offset = 0
            for p in self.params:
                n = p.numel()
                p.data = self.flat[offset:offset + n].view_as(p)
                offset += n
        dev = self.flat.device
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)  # updates applied
        self.notfinite_count = torch.zeros((), dtype=torch.int64, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int64, device=dev)

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """optax's schedule at ``count`` (a float tensor)."""
        peak, warmup, decay = self.peak, self.warmup, self.decay

        def cosine(c, steps):
            c = c.clamp(max=float(steps))
            return peak * 0.5 * (1.0 + torch.cos(math.pi * c / steps))

        if warmup:
            ramp = peak * count.clamp(0.0, float(warmup)) / warmup
            if not decay:
                return ramp
            return torch.where(count < warmup, ramp, cosine(count - warmup, decay))
        if decay:
            return cosine(count, decay)
        return torch.full_like(count, peak)

    def flat_grad(self) -> torch.Tensor:
        """The parameters' gradients as one float32 vector (zeros for a
        parameter that got none)."""
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .reshape(-1).float() for p in self.params])

    @torch.no_grad()
    def step(self, grad: torch.Tensor) -> torch.Tensor:
        """Apply one update from the flat raw gradient; returns whether it
        was applied (a bool device tensor)."""
        apply = torch.ones((), dtype=torch.bool, device=grad.device)
        if self.skip_nonfinite:
            finite = torch.isfinite(grad).all()
            self.notfinite_count = torch.where(finite, 0, self.notfinite_count + 1)
            self.total_notfinite = torch.where(finite, self.total_notfinite,
                                               self.total_notfinite + 1)
            apply = finite | (self.notfinite_count > self.skip_nonfinite)
        u = grad
        if self.clip is not None:
            u = u.clamp(-self.clip, self.clip)
        if self.max_norm is not None:
            norm = torch.sqrt(torch.sum(u * u))
            u = torch.where(norm < self.max_norm, u, u / norm * self.max_norm)
        count_inc = (self.count + 1).float()
        mu = (1.0 - self.b1) * u + self.b1 * self.mu
        nu = (1.0 - self.b2) * (u * u) + self.b2 * self.nu
        mu_hat = mu / (1.0 - self.b1 ** count_inc)
        nu_hat = nu / (1.0 - self.b2 ** count_inc)
        update = -self.learning_rate(self.count.float()) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        if self.skip_nonfinite:
            self.mu = torch.where(apply, mu, self.mu)
            self.nu = torch.where(apply, nu, self.nu)
            update = torch.where(apply, update, 0.0)
            self.count = self.count + apply.long()
        else:
            self.mu, self.nu = mu, nu
            self.count = self.count + 1
        self.flat.add_(update)
        return apply

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {"mu": self.mu, "nu": self.nu, "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for k, v in state.items():
            cur = getattr(self, k)
            if v.shape != cur.shape:
                raise ValueError(f"optimizer state {k}: shape {tuple(v.shape)}, "
                                 f"expected {tuple(cur.shape)}")
            setattr(self, k, v.to(device=cur.device, dtype=cur.dtype).clone())

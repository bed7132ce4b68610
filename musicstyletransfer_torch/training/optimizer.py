"""The optimizer of the training CLI, optax's semantics written out in torch
(counterpart of ``musicstyletransfer_tpu/training/optimizer.py:38-111`` and
of the ``optax.MultiSteps`` wrapper of ``training/trainer.py:143-147``).

``--optimizer``: ``adam``, ``adamw`` (decoupled decay, 1e-2 unless ``wd``
says otherwise), ``sgd`` (``momentum``, default 0) or ``rmsprop``
(``gamma1`` the decay, ``epsilon`` inside the square root, as optax).
``--optimizer-params`` "k1:v1,k2:v2" extras, applied in optax's order:

- ``clip_gradient:c``: elementwise clip to [-c, c] (MXNet semantics);
- ``clip_global_norm:n``: scale by n / ||g|| when ||g|| >= n;
- ``wd`` (or ``weight_decay``), for every optimizer but adamw: wd * param
  added to the gradient before the core (MXNet semantics: the decay goes
  through the learning rate like any gradient term);
- the core: Adam (``beta1``, ``beta2``, ``epsilon``: bias-corrected
  moments, eps outside the sqrt), AdamW, SGD with momentum, RMSProp;
- the learning rate: constant, ``warmup_steps`` linear from 0, and/or
  ``decay_steps`` cosine to 0, evaluated at optax's count (the number of
  updates applied before this one, so a warmup's first step has rate 0);
- ``skip_nonfinite:K`` (``optax.apply_if_finite`` around the whole chain):
  a step whose RAW gradients hold a NaN or Inf applies nothing and leaves
  the moments and counts untouched; after K such steps in a row the next
  one is applied anyway.

``accumulate_steps`` k > 1 is ``optax.MultiSteps`` around all of that: every
step adds its gradient into a running mean, and every k-th step hands the
mean of the k gradients to the chain above (the non-finite guard sees the
mean); the other steps change no parameter.

Every decision is a device tensor and every piece of state is updated in
place, so a step never waits for the host and a CUDA graph that captured it
replays it on the same tensors (``load_state_dict`` copies into them too).
The parameters are re-pointed into one flat float32 buffer, and the state
is flat buffers too: a step is a few whole-buffer operations whatever the
number of tensors.

Under a mesh (``sync``, a ``parallel.mesh.FlatSync``) the buffers hold this
rank's parameters (its shards under tensor parallelism), and three things
are made global: the gradient (``reduce_gradients``: summed over the model
group where each rank saw a time chunk, averaged over the data group), the
sum of squares behind ``clip_global_norm`` and the logged norms (sharded
entries summed over the model group, whole ones counted once: optax's true
global norm) and the non-finite guard's decision, the same on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop")


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


def build_optimizer(config: OptimizerConfig, params) -> "Optimizer":
    """``config``'s optimizer over ``params`` (the JAX package's
    ``build_optimizer`` returns an optax transformation; the port's
    optimizer holds its parameters in its flat buffer)."""
    return Optimizer(list(params), config)


class Optimizer:
    """``config``'s optimizer over ``params`` (which it re-points into one
    flat buffer), with the clips, the schedule, the non-finite guard and,
    for ``accumulate_steps`` > 1, gradient accumulation."""

    def __init__(self, params: List[torch.nn.Parameter], config: OptimizerConfig,
                 accumulate_steps: int = 1, sync=None):
        extra = config.params_to_dict()
        self.sync = sync
        self.name = config.optimizer.lower()
        if self.name not in OPTIMIZERS:
            raise ValueError(f"unsupported optimizer {config.optimizer!r}")
        self.clip = extra.get("clip_gradient")
        self.max_norm = extra.get("clip_global_norm")
        self.skip_nonfinite = int(extra.get("skip_nonfinite", 0))
        self.warmup = int(extra.get("warmup_steps", 0))
        self.decay = int(extra.get("decay_steps", 0))
        self.peak = float(config.learning_rate)
        self.b1 = float(extra.get("beta1", 0.9))
        self.b2 = float(extra.get("beta2", 0.999))
        self.eps = float(extra.get("epsilon", 1e-8))
        self.momentum = float(extra.get("momentum", 0.0))
        self.gamma1 = float(extra.get("gamma1", 0.9))
        wd = float(extra.get("wd", extra.get("weight_decay", 0.0)))
        # adamw's decay is decoupled (inside the core); the others' is MXNet's
        self.adamw_wd = (wd or 1e-2) if self.name == "adamw" else 0.0
        self.wd = 0.0 if self.name == "adamw" else wd
        self.k = max(1, int(accumulate_steps))

        self.params = list(params)
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(-1).float() for p in self.params])
            offset = 0
            for p in self.params:
                n = p.numel()
                p.data = self.flat[offset:offset + n].view_as(p)
                offset += n
        dev = self.flat.device

        def scalar():
            return torch.zeros((), dtype=torch.int64, device=dev)

        self.state: Dict[str, torch.Tensor] = {"count": scalar()}  # updates applied
        if self.name in ("adam", "adamw"):
            self.state["mu"] = torch.zeros_like(self.flat)
        if self.name in ("adam", "adamw", "rmsprop"):
            self.state["nu"] = torch.zeros_like(self.flat)
        if self.name == "sgd":
            self.state["trace"] = torch.zeros_like(self.flat)
        if self.skip_nonfinite:
            self.state["notfinite_count"] = scalar()
            self.state["total_notfinite"] = scalar()
        if self.k > 1:
            self.state["mini_step"] = scalar()
            self.state["acc_grad"] = torch.zeros_like(self.flat)

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

    def reduce_gradients(self, grad: torch.Tensor) -> None:
        """In place: the flat gradient made the global batch's (a no-op
        without a mesh)."""
        if self.sync is not None:
            self.sync.reduce_(grad)

    def sq_sum(self, u: torch.Tensor) -> torch.Tensor:
        """The global sum of squares of a flat vector."""
        if self.sync is not None:
            return self.sync.sq_sum(u)
        return torch.sum(u * u)

    def param_norms(self, flat: torch.Tensor) -> torch.Tensor:
        """The global norm of each parameter's piece of ``flat`` [P]."""
        norms = torch.stack(torch._foreach_norm(self.views(flat)))
        if self.sync is None:
            return norms
        return torch.sqrt(self.sync.param_sq_sums(norms * norms))

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """``flat`` cut into one view per parameter, in parameter order."""
        return list(flat.split([p.numel() for p in self.params]))

    @torch.no_grad()
    def step(self, grad: torch.Tensor) -> None:
        """One step from the flat raw gradient, every state tensor updated in
        place: under accumulation the running mean, and every k-th step the
        update of the mean (optax.MultiSteps with its gradient mean)."""
        if self.k == 1:
            self._update(grad, None)
        else:
            mini, acc = self.state["mini_step"], self.state["acc_grad"]
            mean = acc + (grad - acc) / (mini + 1).float()
            emit = mini == self.k - 1
            self._update(mean, emit)
            acc.copy_((1 - emit.float()) * mean)  # a NaN mean stays NaN, as in optax
            mini.copy_((mini + 1) % self.k)
        self.params_changed()

    def params_changed(self) -> None:
        """Bump the parameters' version counters after a write to ``flat``.
        Each parameter was re-pointed into ``flat`` through ``.data``, which
        keeps its own counter, so a write to ``flat`` does not reach it; a
        cache keyed by the counters (the fused decode's weight pack) must
        see the new values."""
        torch.autograd.graph.increment_version(self.params)

    def _update(self, grad: torch.Tensor, emit) -> None:
        """The chain (``optax.apply_if_finite`` around it under
        ``skip_nonfinite``) on ``grad``. With ``emit`` (a bool device tensor:
        MultiSteps' k-th step), its state moves only where ``emit`` holds and
        its update is multiplied by ``emit``, as optax's wrapper does."""
        st = self.state
        apply = None  # whether the guard lets the update through (None: always)
        if self.skip_nonfinite:
            finite = torch.isfinite(grad).all()
            if self.sync is not None:
                finite = self.sync.all_finite(finite)
            notfinite = torch.where(finite, 0, st["notfinite_count"] + 1)
            total = torch.where(finite, st["total_notfinite"], st["total_notfinite"] + 1)
            apply = finite | (notfinite > self.skip_nonfinite)
            if emit is not None:
                notfinite = torch.where(emit, notfinite, st["notfinite_count"])
                total = torch.where(emit, total, st["total_notfinite"])
            st["notfinite_count"].copy_(notfinite)
            st["total_notfinite"].copy_(total)
        u = grad
        if self.clip is not None:
            u = u.clamp(-self.clip, self.clip)
        if self.max_norm is not None:
            norm = torch.sqrt(self.sq_sum(u))
            u = torch.where(norm < self.max_norm, u, u / norm * self.max_norm)
        if self.wd:
            u = u + self.wd * self.flat
        count = st["count"]
        moments = {}
        if self.name in ("adam", "adamw"):
            count_inc = (count + 1).float()
            moments["mu"] = mu = (1.0 - self.b1) * u + self.b1 * st["mu"]
            moments["nu"] = nu = (1.0 - self.b2) * (u * u) + self.b2 * st["nu"]
            mu_hat = mu / (1.0 - self.b1 ** count_inc)
            nu_hat = nu / (1.0 - self.b2 ** count_inc)
            step = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.adamw_wd:
                step = step + self.adamw_wd * self.flat
        elif self.name == "rmsprop":
            moments["nu"] = nu = (1.0 - self.gamma1) * (u * u) + self.gamma1 * st["nu"]
            step = torch.rsqrt(nu + self.eps) * u
        else:
            moments["trace"] = step = u + self.momentum * st["trace"]
        update = -self.learning_rate(count.float()) * step
        keep = apply if emit is None else (emit if apply is None else apply & emit)
        if keep is None:
            for k, v in moments.items():
                st[k].copy_(v)
            count.add_(1)
            self.flat.add_(update)
            return
        for k, v in moments.items():
            st[k].copy_(torch.where(keep, v, st[k]))
        count.add_(keep.long())
        if apply is not None:
            update = torch.where(apply, update, 0.0)
        if emit is not None:
            update = emit.float() * update  # NaN stays NaN off the emit, as in optax
        self.flat.add_(update)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.state)

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy ``state`` into the optimizer's own tensors (a captured graph
        keeps reading them)."""
        if set(state) != set(self.state):
            raise ValueError(f"optimizer state holds {sorted(state)}, expected "
                             f"{sorted(self.state)}")
        for k, v in state.items():
            cur = self.state[k]
            if v.shape != cur.shape:
                raise ValueError(f"optimizer state {k}: shape {tuple(v.shape)}, "
                                 f"expected {tuple(cur.shape)}")
            cur.copy_(v.to(device=cur.device, dtype=cur.dtype))

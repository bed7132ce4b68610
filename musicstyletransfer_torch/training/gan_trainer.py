"""Adversarial training of the sequence GAN (counterpart of
``musicstyletransfer_tpu/training/gan_trainer.py``).

``GANSteps`` holds the two models, their Adam optimizers (no clipping, one
learning rate each), the noise generator and on-device (sum, count)
accumulators of ``GAN_METRIC_KEYS``; every step updates them in place and
reads nothing on the host, so consecutive steps capture into one CUDA graph.

- ``d_step``: fake token distributions softmax(G(noise) / temperature)
  without gradients, real ones one-hot; BCE over each sample's real and fake
  per-step predictions concatenated on time, labels [1]*L + [0]*L (label
  smoothing and negative-label downweighting as configured), plus
  0.5 * r1_gamma * R1, R1 the mean over samples of the summed squared
  gradient of sum D(real) with respect to the real inputs
  (``torch.autograd.grad(..., create_graph=True)``; the LSTM is the explicit
  cell loop of ``models/lstm.py``, which has the double backward cuDNN's RNN
  lacks).
- ``g_step``: the non-saturating BCE(D(G(noise)), 1), its gradients taken
  with respect to the generator's parameters alone (D's ``.grad`` is never
  written).

``GANTrainer.fit`` runs a D step on every batch and a G step after the D
step of batch n when n % discriminator_update_steps == 0, n counting the
batches of the run across epochs (from 0 again after a resume, as the JAX
package counts). On CUDA the batches go in groups, one CUDA-graph replay a
group (``GraphedGANGroups``): a group ends where n reaches a multiple of
discriminator_update_steps, a log, checkpoint or sampling boundary, or the
end of an epoch, so every tick falls where the JAX loop has it; the CPU runs
the same steps eagerly. Metrics are read on the host only at ``log_every``
and appended to ``<logdir>/scalars.jsonl`` (the JAX package writes
TensorBoard files).

Checkpoint N of a folder is ``generator/params.N.pt`` (the generator's flat
parameters, its Adam state and the noise generator's state) and
``discriminator/params.N.pt``, plus ``torch/params.npz`` and
``torch/config.json`` (the generator in the flax layout, for ``cli.gan
--generate``). Resume restores the newest pair only if both halves load and
fit; otherwise it trains from scratch, never a trained G against a fresh D.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import params_to_jax
from ..midi.vocab import EOS_ID, PAD_ID
from ..models.config import GANConfig
from ..models.gan import Discriminator, Generator, generate_tokens, init_gan_params
from ..utils import resolve_device
from . import checkpoint as ckpt
from .graph import GraphedGroups
from .loss import binary_cross_entropy
from .optimizer import Optimizer, OptimizerConfig

GAN_METRIC_KEYS = ("d_loss", "d_acc_real", "d_acc_fake", "g_loss", "d_r1")
MESH_NOT_PORTED = ("mesh= (data-parallel GAN training) is not ported to PyTorch yet "
                   "(ROADMAP queue 1, item 9c)")


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    """Knobs from the reference's scripts/train.sh:6-21 (the JAX package's
    defaults, ``gan_trainer.py:68-95``)."""

    discriminator_update_steps: int = 5   # D updates per G update
    g_learning_rate: float = 5e-5
    d_learning_rate: float = 5e-5
    label_smoothing: float = 0.0
    negative_label_downweighting: bool = False
    r1_gamma: float = 0.1  # R1 penalty on real inputs; 0 (--parity-gan) turns it off
    checkpoint_frequency: int = 5000
    sampling_frequency: int = 1000
    num_samples: int = 8
    temperature: float = 1.0
    logdir: Optional[str] = None
    log_every: int = 50
    seed: int = 0


def _flat_grads(grads, params) -> torch.Tensor:
    return torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1).float()
                      for g, p in zip(grads, params)])


class GANSteps:
    """The D and G updates of ``gen`` and ``disc`` (on one device), every
    effect in place: parameters, Adam state, the noise generator, and the
    metric sums and counts (``sums``/``counts``, in ``GAN_METRIC_KEYS``
    order)."""

    def __init__(self, config: GANConfig, train_config: GANTrainConfig, gen: Generator,
                 disc: Discriminator, generator: torch.Generator):
        self.config = config
        self.train_config = train_config
        self.gen = gen.train()
        self.disc = disc.train()
        self.generator = generator
        self.g_opt = Optimizer(list(gen.parameters()),
                               OptimizerConfig("adam", "", train_config.g_learning_rate))
        self.d_opt = Optimizer(list(disc.parameters()),
                               OptimizerConfig("adam", "", train_config.d_learning_rate))
        dev = self.g_opt.flat.device
        self.sums = torch.zeros(len(GAN_METRIC_KEYS), device=dev)
        self.counts = torch.zeros(len(GAN_METRIC_KEYS), device=dev)
        self._d_count = torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0], device=dev)
        self._g_count = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0], device=dev)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a step updates in place."""
        return [self.g_opt.flat, *self.g_opt.state.values(), self.d_opt.flat,
                *self.d_opt.state.values(), self.sums, self.counts]

    def noise(self, batch: int) -> torch.Tensor:
        gc = self.config.generator_config
        return torch.randn((batch, gc.max_seq_len, gc.noise_dim), generator=self.generator,
                           device=self.sums.device)

    def fake_dists(self, classes: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Soft generated sequences [B, L, V]: softmax(logits / temperature),
        the temperature of the rollout's own soft feedback."""
        temperature = self.train_config.temperature
        logits, _ = self.gen(noise, classes, hard=False, temperature=temperature,
                             draw_tokens=False)
        return torch.softmax(logits / temperature, dim=-1)

    def d_step(self, real_tokens: torch.Tensor, classes: torch.Tensor,
               noise: Optional[torch.Tensor] = None) -> None:
        """One discriminator update on real token rows [B, L] (no SOS)."""
        tc = self.train_config
        noise = self.noise(classes.shape[0]) if noise is None else noise
        with torch.no_grad():
            fake = self.fake_dists(classes, noise)
        real = F.one_hot(real_tokens.long(), self.config.discriminator_config.input_dim).float()
        if tc.r1_gamma > 0.0:
            real.requires_grad_(True)
            pred_real = self.disc(real, classes)
            (gin,) = torch.autograd.grad(pred_real.sum(), real, create_graph=True)
            r1 = gin.float().square().sum(dim=(1, 2)).mean()
        else:
            pred_real = self.disc(real, classes)
            r1 = torch.zeros((), device=real.device)
        pred_fake = self.disc(fake, classes)
        pred = torch.cat([pred_real, pred_fake], dim=1)
        label = torch.cat([torch.ones_like(pred_real), torch.zeros_like(pred_fake)], dim=1)
        loss = binary_cross_entropy(
            pred, label, label_smoothing=tc.label_smoothing,
            negative_label_downweighting=tc.negative_label_downweighting).mean()
        loss = loss + 0.5 * tc.r1_gamma * r1
        params = self.d_opt.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        self.d_opt.step(_flat_grads(grads, params))
        with torch.no_grad():
            zero = torch.zeros((), device=loss.device)
            self.sums.add_(torch.stack([loss.detach(), (pred_real > 0.0).float().mean(),
                                        (pred_fake < 0.0).float().mean(), zero, r1.detach()]))
            self.counts.add_(self._d_count)

    def g_step(self, classes: torch.Tensor, noise: Optional[torch.Tensor] = None) -> None:
        """One generator update against the current discriminator."""
        noise = self.noise(classes.shape[0]) if noise is None else noise
        pred = self.disc(self.fake_dists(classes, noise), classes)
        loss = binary_cross_entropy(pred, torch.ones_like(pred),
                                    negative_label_downweighting=False).mean()
        params = self.g_opt.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        self.g_opt.step(_flat_grads(grads, params))
        with torch.no_grad():
            self.sums.add_(F.pad(loss.detach()[None], (3, 1)))
            self.counts.add_(self._g_count)

    def run_group(self, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  g_after: Sequence[bool]) -> None:
        """Eager steps: a D step on each (tokens, classes), and a G step after
        it where ``g_after`` says."""
        for (tokens, classes), g in zip(batches, g_after):
            self.d_step(tokens, classes)
            if g:
                self.g_step(classes)

    def metrics(self) -> Dict[str, float]:
        """The means since the last reset (a host read), for keys with a count."""
        sums, counts = self.sums.tolist(), self.counts.tolist()
        return {k: s / c for k, s, c in zip(GAN_METRIC_KEYS, sums, counts) if c > 0}

    def reset_metrics(self) -> None:
        self.sums.zero_()
        self.counts.zero_()


class GraphedGANGroups(GraphedGroups):
    """Groups of D/G steps of ``steps`` as CUDA-graph replays (the rules of
    ``training/graph.py``), one graph per pattern of a group: which batches
    a G step follows."""

    def __init__(self, steps: GANSteps, max_batches: int):
        def body(inputs: List[torch.Tensor], g_after: Tuple[bool, ...]) -> None:
            tokens, classes = inputs
            steps.run_group([(tokens[i], classes[i]) for i in range(len(g_after))], g_after)

        super().__init__(body, steps.tensors, [steps.g_opt, steps.d_opt], steps.generator,
                         max_batches, warmup_key=(True,))

    def run(self, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
            g_after: Sequence[bool]) -> None:
        if len(g_after) != len(batches):
            raise ValueError(f"a group of {len(batches)} batches and {len(g_after)} flags")
        super().run(batches, tuple(bool(g) for g in g_after))


def group_pattern(start: int, n: int, k: int) -> List[bool]:
    """Which of the batches start .. start+n-1 a G step follows (n % k == 0)."""
    return [(start + i) % k == 0 for i in range(n)]


class GANTrainer:
    """The epoch loop alternating D and G updates (D : G =
    discriminator_update_steps : 1) on ``device``: None is CUDA, raising
    where there is no card."""

    def __init__(self, config: GANConfig, train_config: GANTrainConfig,
                 out_samples: Optional[str] = None,
                 device: Optional[torch.device] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        self.config = config
        self.train_config = train_config
        self.out_samples = out_samples
        # None is CUDA, raising without a card (``utils.resolve_device``)
        self.device = torch.device(device) if device is not None else resolve_device()
        self.steps: Optional[GANSteps] = None
        self.graphs: Optional[GraphedGANGroups] = None

    def _build(self) -> None:
        tc = self.train_config
        gen, disc = init_gan_params(self.config, tc.seed)
        noise = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.steps = GANSteps(self.config, tc, gen.to(self.device), disc.to(self.device), noise)
        k = max(1, tc.discriminator_update_steps)
        self.graphs = (GraphedGANGroups(self.steps, k) if self.device.type == "cuda" else None)

    @property
    def gen(self) -> Generator:
        return self.steps.gen

    # -- checkpoints: {folder}/generator/params.N.pt + {folder}/discriminator/params.N.pt

    def _save(self, folder: str, index: int) -> None:
        s = self.steps
        for sub, opt, extra in (("generator", s.g_opt, {"noise": s.generator.get_state()}),
                                ("discriminator", s.d_opt, {})):
            os.makedirs(os.path.join(folder, sub), exist_ok=True)
            ckpt.save_checkpoint(os.path.join(folder, sub), index,
                                 {"params": opt.flat, "optimizer": opt.state_dict(), **extra})
        export_generator(folder, index, self.config, s.gen)

    def _try_resume(self, folder: str) -> int:
        """Restore the newest checkpoint pair; 0 (fresh states kept) when
        there is none or either half does not load or fit."""
        gen_folder = os.path.join(folder, "generator")
        indices = ckpt.checkpoint_indices(gen_folder)
        if not indices:
            return 0
        idx = indices[-1]
        s = self.steps
        try:
            g = ckpt.restore_checkpoint(gen_folder, idx)
            d = ckpt.restore_checkpoint(os.path.join(folder, "discriminator"), idx)
            for state, opt in ((g, s.g_opt), (d, s.d_opt)):
                _check_fits(state, opt)
        except Exception as exc:  # a corrupt or foreign pair: train from scratch
            print(f"GAN resume failed ({exc!r}); training from scratch")
            return 0
        with torch.no_grad():
            for state, opt in ((g, s.g_opt), (d, s.d_opt)):
                opt.load_state_dict(state["optimizer"])
                opt.flat.copy_(state["params"])
                opt.params_changed()
        s.generator.set_state(g["noise"])
        print(f"resumed GAN from checkpoint {idx}")
        return idx

    def fit(self, dataset, model_folder: str, epochs: int) -> Dict[str, float]:
        cfg = self.train_config
        os.makedirs(model_folder, exist_ok=True)
        self._build()
        ckpt_idx = self._try_resume(model_folder)
        k = max(1, cfg.discriminator_update_steps)
        ticks = [f for f in (cfg.log_every, cfg.checkpoint_frequency,
                             cfg.sampling_frequency if self.out_samples else 0) if f > 0]
        n_batches = 0
        since_log = 0
        last: Dict[str, float] = {}
        t0 = time.time()
        for epoch in range(epochs):
            group: list = []
            batches = iter(dataset)
            while True:
                batch = next(batches, None)
                if batch is not None:
                    group.append(batch_tensors(batch, self.device))
                    end = n_batches + len(group)
                    if end % k and not any(end % f == 0 for f in ticks):
                        continue
                if not group:
                    break
                self._run(group, n_batches)
                n_batches += len(group)
                since_log += len(group)
                group = []
                if n_batches % cfg.log_every == 0:
                    last.update(self._log(epoch, n_batches, t0))
                    since_log = 0
                if cfg.checkpoint_frequency > 0 and n_batches % cfg.checkpoint_frequency == 0:
                    ckpt_idx += 1
                    self._save(model_folder, ckpt_idx)
                if (self.out_samples and cfg.sampling_frequency > 0
                        and n_batches % cfg.sampling_frequency == 0):
                    self.sample_to_midi(os.path.join(self.out_samples, f"step-{n_batches}"))
                if batch is None:
                    break
        ckpt_idx += 1
        self._save(model_folder, ckpt_idx)
        if since_log:
            # the trailing window, so the result reflects the final model
            last.update(self._log(epochs - 1, n_batches, t0))
        return last

    def _run(self, group, start: int) -> None:
        pattern = group_pattern(start, len(group), max(1, self.train_config.discriminator_update_steps))
        if self.graphs is not None:
            self.graphs.run(group, pattern)
        else:
            self.steps.run_group(group, pattern)

    def _log(self, epoch: int, n_batches: int, t0: float) -> Dict[str, float]:
        vals = self.steps.metrics()
        self.steps.reset_metrics()
        line = " ".join(f"{k}={v:.4f}" for k, v in sorted(vals.items()))
        rate = n_batches / max(time.time() - t0, 1e-9)
        print(f"[gan] epoch {epoch} batch {n_batches} {line} ({rate:.1f} updates/s)")
        if self.train_config.logdir:
            os.makedirs(self.train_config.logdir, exist_ok=True)
            row = {"step": n_batches}
            row.update({k: (v if math.isfinite(v) else str(v)) for k, v in vals.items()})
            with open(os.path.join(self.train_config.logdir, "scalars.jsonl"), "a") as f:
                f.write(json.dumps(row) + "\n")
        return vals

    def generate_class_rows(self, gen: Optional[Generator] = None) -> Dict[int, list]:
        """num_samples token rows a class, each cut at the first EOS or PAD
        (training rows end in PAD; EOS is honoured too). Class c draws from a
        generator seeded with seed + 1000 + c on the model's device."""
        gen = gen if gen is not None else self.gen
        cfg = self.train_config
        dev = next(gen.parameters()).device
        rows: Dict[int, list] = {}
        was_training = gen.training
        gen.eval()
        try:
            for c in range(self.config.generator_config.num_classes):
                classes = torch.full((cfg.num_samples,), c, dtype=torch.long, device=dev)
                draws = torch.Generator(device=dev).manual_seed(cfg.seed + 1000 + c)
                tokens = generate_tokens(gen, classes, draws, cfg.temperature).cpu().numpy()
                out = []
                for row in tokens:
                    stop = np.flatnonzero((row == EOS_ID) | (row == PAD_ID))
                    out.append(row[: stop[0]] if stop.size else row)
                rows[c] = out
        finally:
            gen.train(was_training)
        return rows

    def sample_to_midi(self, out_dir: str, gen: Optional[Generator] = None) -> list:
        """num_samples MIDIs a class: ``gan-out-{i}.class-{c}.mid``."""
        from ..midi.codec import MelodyWriter, melody_from_ids

        os.makedirs(out_dir, exist_ok=True)
        writer = MelodyWriter()
        paths = []
        for c, rows in self.generate_class_rows(gen).items():
            for i, row in enumerate(rows):
                path = os.path.join(out_dir, f"gan-out-{i}.class-{c}.mid")
                writer.write_to_file(path, melody_from_ids(row))
                paths.append(path)
        return paths


def batch_tensors(batch, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real token rows [B, L] without the SOS, classes [B]) on ``device``."""
    return (torch.as_tensor(np.asarray(batch.tokens)[:, 1:]).to(device=device, dtype=torch.long),
            torch.as_tensor(np.asarray(batch.classes)).to(device=device, dtype=torch.long))


def _check_fits(state, opt: Optimizer) -> None:
    """Raise unless a checkpoint half fits ``opt`` (checked before anything is
    copied, so a pair that fails leaves the fresh states untouched)."""
    params = state["params"]
    if params.shape != opt.flat.shape:
        raise ValueError(f"{params.numel()} parameters in the checkpoint, "
                         f"{opt.flat.numel()} in the model")
    saved = state["optimizer"]
    if set(saved) != set(opt.state) or any(saved[k].shape != v.shape
                                            for k, v in opt.state.items()):
        raise ValueError("the optimizer state does not fit")


def export_generator(folder: str, index: int, config: GANConfig, gen: Generator) -> None:
    """``<folder>/torch/{params.npz,config.json}``: the generator in the flax
    layout and ``{"checkpoint": index, "gan_config": ...}``."""
    out = os.path.join(folder, ckpt.EXPORT_DIR)
    os.makedirs(out, exist_ok=True)
    tmp = os.path.join(out, f"params.{os.getpid()}.tmp.npz")
    np.savez(tmp, **params_to_jax(gen))
    os.replace(tmp, os.path.join(out, "params.npz"))
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump({"checkpoint": int(index), "gan_config": dataclasses.asdict(config)},
                  f, indent=2, sort_keys=True)
        f.write("\n")

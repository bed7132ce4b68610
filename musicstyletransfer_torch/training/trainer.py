"""The fit loop (counterpart of ``musicstyletransfer_tpu/training/trainer.py``):
epochs of steps, metrics logged every ``log_every`` steps, checkpoints every
``checkpoint_frequency`` steps with a validation pass, a generation-health
probe and early stopping after ``num_checkpoints_not_improved`` checkpoints
without a better validation loss, in-training sampling, and resume from the
newest checkpoint that restores.

Scalars are printed and appended to ``<logdir>/scalars.jsonl``, one JSON
object per write with the batch count under ``"step"`` (the JAX package
writes TensorBoard files; the port needs no tensorboard package).

``steps_per_dispatch`` is accepted: it groups N batches and runs them as N
single steps, with the log, checkpoint and sampling ticks at group
boundaries as in the JAX package (whose N steps run as one program). Not
ported yet (ROADMAP queue 1, item 4): meshes and multi-process runs,
profiling, input prefetch, gradient accumulation and a choice of random
number generator (the port draws from one ``torch.Generator``).

Resume restores the parameters, the Adam state, the step, the generator
and, unlike the JAX package, the order of the training batches, so a run
resumed from a checkpoint at an epoch boundary continues as it would have
uninterrupted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import time
from typing import Dict, Optional

import torch

from ..data.dataset import Dataset
from ..midi.vocab import EOS_ID, PAD_ID
from ..models.vae import StyleVAE
from . import checkpoint as ckpt
from .metrics import MetricAccumulator, accumulate
from .optimizer import Adam, OptimizerConfig
from .train_step import LossConfig, batch_tensors, eval_step, train_step


@dataclasses.dataclass
class TrainConfig:
    """Reference: trainer.py:38-57 (TrainConfig)."""

    batch_size: int = 1
    sampling_frequency: int = 1000
    checkpoint_frequency: int = 5000
    num_checkpoints_not_improved: int = 10
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    kl_loss_weight: float = 1.0
    kl_anneal_steps: int = 0  # linear KL warmup (0 = constant)
    free_bits: float = 0.0  # per-dim KL floor (posterior-collapse guard)
    label_smoothing: float = 0.0
    logdir: str = "/tmp/out"
    log_every: int = 50  # reference: trainer.py:139
    seed: int = 0
    # Retain only the newest N checkpoints (0 = keep all).
    keep_checkpoints: int = 0
    # Per-checkpoint generation-health probe: style-transfer this many rows
    # (from the validation set, else the train set) into every class at
    # max_len 2 * (L + 1) and log termination rate and mean length. 0
    # disables; cli.main defaults it to 8.
    gen_health_rows: int = 0
    steps_per_dispatch: int = 1


class Trainer:
    def __init__(self, config: TrainConfig, model: StyleVAE, sampler=None):
        """``model`` lives on the device it trains on; its parameters are
        re-pointed into the optimizer's flat buffer."""
        self.config = config
        self.model = model
        self.sampler = sampler
        self.device = model.device
        self.optimizer = Adam(list(model.parameters()), config.optimizer)
        self.loss_config = LossConfig(
            kl_weight=config.kl_loss_weight,
            label_smoothing=config.label_smoothing,
            kl_anneal_steps=config.kl_anneal_steps,
            free_bits=config.free_bits,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.step = 0
        self.progress = ckpt.TrainingProgress()
        self._metric_acc = None
        self._health_batch = None
        self._health_classes = 0
        self._dataset = None
        self._batches_at_start = 0
        self._last_log = None
        self._last_ckpt_batches = 0
        self._stop_requested = False

    # ------------------------------------------------------------------

    def fit(self, dataset: Dataset, model_folder: str, epochs: int,
            validation_dataset: Optional[Dataset] = None) -> None:
        start_time = time.time()
        os.makedirs(model_folder, exist_ok=True)
        self._dataset = dataset
        cfg = self.config
        self._health_batch = None
        if cfg.gen_health_rows > 0:
            # Taken before the resume, which then restores the batch order
            # that this draw would otherwise shift (without validation data
            # the probe rows come from the training set).
            src = validation_dataset if validation_dataset is not None else dataset
            self._health_classes = src.num_classes()
            b = next(iter(src))
            n = min(cfg.gen_health_rows, int(b.tokens.shape[0]))
            self._health_batch = tuple(torch.as_tensor(x[:n]).long().to(self.device)
                                       for x in (b.tokens, b.seq_lens))
        self._load_latest_checkpoint(model_folder)
        self._batches_at_start = self.progress.n_batches
        self._last_log = None
        self._stop_requested = False
        restore_handlers = self._install_signal_handlers()
        try:
            self._fit_loop(dataset, model_folder, epochs, validation_dataset, start_time)
        finally:
            restore_handlers()

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT: finish the current batch, checkpoint, return."""
        previous = {}

        def restore():
            for sig, handler in previous.items():
                signal.signal(sig, handler)

        def _request_stop(signum, frame):
            print(f"Signal {signum}: checkpointing and stopping after this batch.")
            self._stop_requested = True
            restore()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not the main thread
                break
        return restore

    def _fit_loop(self, dataset, model_folder, epochs, validation_dataset,
                  start_time) -> None:
        self._last_ckpt_batches = self.progress.n_batches
        n_per = max(1, self.config.steps_per_dispatch)
        group: list = []
        for epoch in range(epochs):
            for batch in dataset:
                group.append(batch)
                if len(group) < n_per:
                    continue
                if self._run_group(group, epoch, model_folder, validation_dataset,
                                   start_time, dataset):
                    return
                group = []
            for b in group:  # the epoch's remainder, one step at a time
                if self._run_group([b], epoch, model_folder, validation_dataset,
                                   start_time, dataset):
                    return
            group = []
        if self.progress.n_batches != self._last_ckpt_batches:
            self._checkpoint(model_folder, validation_dataset)
            print(f"Final checkpoint {self.progress.n_checkpoints} written.")

    def _run_group(self, group, epoch, model_folder, validation_dataset,
                   start_time, dataset) -> bool:
        """Run a group of batches, then the ticks that the group crossed.
        Returns True when training should stop."""
        cfg = self.config
        prev = self.progress.n_batches
        for batch in group:
            self.train_batch(batch)
        self.progress.n_batches += len(group)
        nb = self.progress.n_batches

        if self._stop_requested:
            self._checkpoint(model_folder, validation_dataset)
            print(f"Stopped on signal; checkpoint {self.progress.n_checkpoints} written.")
            return True
        if nb // cfg.log_every > prev // cfg.log_every:
            self._periodic_log(epoch, start_time)
        if nb // cfg.checkpoint_frequency > prev // cfg.checkpoint_frequency:
            self._checkpoint(model_folder, validation_dataset)
            if (self.progress.num_checkpoints_not_improved
                    == cfg.num_checkpoints_not_improved):
                print("Maximum checkpoints not improved reached. Stopping training.")
                return True
        if (self.sampler is not None and cfg.sampling_frequency > 0
                and nb // cfg.sampling_frequency > prev // cfg.sampling_frequency):
            with self._eval_mode():
                self.sampler.process_batch(group[-1],
                                           os.path.join(model_folder, f"samples/step-{nb}"),
                                           dataset.num_classes())
        return False

    def train_batch(self, batch) -> None:
        """One training step on a host batch."""
        self._metric_acc = train_step(
            self.model, self.optimizer, self.loss_config, self.step, self._metric_acc,
            *batch_tensors(batch, self.device), generator=self.generator)
        self.step += 1

    @contextlib.contextmanager
    def _eval_mode(self):
        self.model.eval()
        try:
            yield
        finally:
            self.model.train()

    # ------------------------------------------------------------------

    def _eval_pass(self, validation_dataset: Dataset) -> float:
        acc: Dict = {}
        with self._eval_mode():
            for batch in validation_dataset:
                acc = accumulate(acc, eval_step(self.model, self.loss_config,
                                                *batch_tensors(batch, self.device),
                                                batch.num_valid))
        host = MetricAccumulator()
        host.update(acc)
        vals = host.get()
        self._write_scalars({f"validation_{k}": v for k, v in vals.items()})
        print("Validation: " + " ".join(f"{k}={v:.3f}" for k, v in sorted(vals.items())))
        # Under KL annealing the total's beta rises across checkpoints, so
        # track the beta-independent reconstruction CE (as the JAX package).
        if self.config.kl_anneal_steps > 0:
            return vals["ce_loss"]
        return vals["total_loss"]

    def _checkpoint(self, model_folder: str, validation_dataset) -> None:
        self._last_ckpt_batches = self.progress.n_batches
        self.progress.n_checkpoints += 1
        n = self.progress.n_checkpoints
        print(f"\nCheckpoint {n} reached.")
        data_rng = getattr(self._dataset, "_rng", None)
        ckpt.save_checkpoint(model_folder, n, {
            "params": self.optimizer.flat,
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
            "data_rng": data_rng.bit_generator.state if data_rng is not None else None,
        })
        ckpt.export_inference(model_folder, n, self.model)
        self.progress.save(model_folder)
        if self.config.keep_checkpoints > 0:
            ckpt.prune_checkpoints(model_folder, self.config.keep_checkpoints)
        self._metric_acc = None  # reset running metrics (trainer.py:210)

        if self._health_batch is not None:
            vals = self._generation_health()
            self._write_scalars(vals)
            print("Generation health: "
                  + " ".join(f"{k}={v:.3f}" for k, v in sorted(vals.items())))
        if self.optimizer.skip_nonfinite:
            skipped = int(self.optimizer.total_notfinite)
            if skipped:
                print(f"Non-finite gradient updates skipped: {skipped}")
            self._write_scalars({"nonfinite_updates_skipped": skipped})

        if validation_dataset is None:
            return
        loss = self._eval_pass(validation_dataset)
        if loss < self.progress.best_reconstruction_loss:
            print(f"Loss improved from {self.progress.best_reconstruction_loss} to {loss}.")
            self.progress.best_reconstruction_loss = loss
            self.progress.num_checkpoints_not_improved = 0
        else:
            self.progress.num_checkpoints_not_improved += 1
            print(f"Loss did not improve. {self.progress.num_checkpoints_not_improved} "
                  f"out of {self.config.num_checkpoints_not_improved} unsuccessful "
                  "checkpoints")
            print(f"Best loss thus far: {self.progress.best_reconstruction_loss}")
        self.progress.save(model_folder)

    def _generation_health(self) -> Dict[str, float]:
        """Transfer the fixed probe rows into every class with the current
        parameters (fixed seed) and summarise termination and length."""
        from ..inference.decode import style_transfer_all_classes

        tokens, seq_lens = self._health_batch
        with self._eval_mode():
            seqs, _ = style_transfer_all_classes(
                self.model, tokens, seq_lens, max_len=2 * int(tokens.shape[1]),
                num_classes=self._health_classes, seed=self.config.seed)
        seqs = seqs.cpu().numpy()  # [C, B, T']
        terminated = (seqs == EOS_ID).any(axis=-1)
        lengths = (seqs != PAD_ID).sum(axis=-1) - 1  # minus SOS
        return {
            "gen_termination_rate": float(terminated.mean()),
            "gen_min_class_termination": float(terminated.mean(axis=1).min()),
            "gen_mean_len": float(lengths.mean()),
        }

    def _load_latest_checkpoint(self, model_folder: str) -> None:
        """Resume from the newest checkpoint that restores, falling back to
        older ones; start from scratch when none does."""
        print(f"Looking into folder {model_folder} for a valid training.")
        indices = ckpt.checkpoint_indices(model_folder)
        if not indices:
            print("No checkpoint was found. Starting training from scratch")
        for idx in reversed(indices):
            print(f"Checkpoint {idx} found. Resuming training.")
            try:
                state = ckpt.restore_checkpoint(model_folder, idx)
                self._restore(state)
            except Exception as exc:  # a corrupt checkpoint: try the previous one
                print(f"Checkpoint {idx} could not be restored ({exc!r}); "
                      + ("trying the previous checkpoint" if idx != indices[0]
                         else "starting training from scratch"))
                continue
            try:
                self.progress = ckpt.TrainingProgress.load(model_folder)
            except FileNotFoundError:
                pass
            if self.progress.n_checkpoints > idx:
                print(f"Bookkeeping ({self.progress.n_checkpoints}) is ahead of the "
                      f"restored checkpoint ({idx}); reconciling.")
                self.progress.n_checkpoints = idx
                self.progress.n_batches = self.step
            return

    def _restore(self, state) -> None:
        params = state["params"]
        if params.shape != self.optimizer.flat.shape:
            raise ValueError(f"{params.numel()} parameters in the checkpoint, "
                             f"{self.optimizer.flat.numel()} in the model")
        self.optimizer.load_state_dict(state["optimizer"])
        with torch.no_grad():
            self.optimizer.flat.copy_(params)
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        data_rng = getattr(self._dataset, "_rng", None)
        if data_rng is not None and state.get("data_rng") is not None:
            data_rng.bit_generator.state = state["data_rng"]

    # ------------------------------------------------------------------

    def _write_scalars(self, scalars: Dict[str, float]) -> None:
        os.makedirs(self.config.logdir, exist_ok=True)
        line = {"step": self.progress.n_batches}
        line.update({k: (v if math.isfinite(v) else str(v)) for k, v in scalars.items()})
        with open(os.path.join(self.config.logdir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")

    def _periodic_log(self, epoch: int, start_time: float) -> None:
        host = MetricAccumulator()
        host.update(self._metric_acc or {})
        self._metric_acc = None
        vals = host.get()
        self._write_scalars(vals)
        now = time.time()
        ups = (self.progress.n_batches - self._batches_at_start) / max(now - start_time, 1e-9)
        window = ""
        if self._last_log is not None:
            prev_batches, prev_time = self._last_log
            wups = (self.progress.n_batches - prev_batches) / max(now - prev_time, 1e-9)
            window = f" (window: {wups:.1f})"
        self._last_log = (self.progress.n_batches, now)
        line = " ".join(f"{k}={v:.3f}" for k, v in sorted(vals.items()))
        print(f"Epoch [{epoch}] Batch [{self.progress.n_batches}] "
              f"updates/sec: {ups:.2f}{window} {line}")


"""The fit loop (counterpart of ``musicstyletransfer_tpu/training/trainer.py``):
epochs of steps, metrics logged every ``log_every`` steps, checkpoints every
``checkpoint_frequency`` steps with a validation pass, a generation-health
probe and early stopping after ``num_checkpoints_not_improved`` checkpoints
without a better validation loss, in-training sampling, and resume from the
newest checkpoint that restores.

Scalars are printed and appended to ``<logdir>/scalars.jsonl``, one JSON
object per write with the batch count under ``"step"`` (the JAX package
writes TensorBoard files; the port needs no tensorboard package).

``steps_per_dispatch`` groups N batches, with the log, checkpoint and
sampling ticks at group boundaries as in the JAX package, whose N steps run
as one program. On CUDA a group is one replay of a CUDA graph of its N steps
(``training/graph.py``; an epoch's shorter remainder gets a graph of its own
length); on the CPU its steps run one after the other. Batches reach the
device through ``data/prefetch.py`` (``prefetch`` deep, 0 disables),
``grad_accum_steps`` k applies the mean gradient of k steps every k-th step
(``optax.MultiSteps``), ``log_param_grad_norms`` logs one gradient norm per
parameter, and ``profile_dir`` gets a ``torch.profiler`` trace of the steps
``[profile_start, profile_stop)``, snapped to group boundaries. The port
draws its random numbers from one ``torch.Generator`` whatever
``--rng-impl`` says.

With a ``mesh`` (``parallel/mesh.py``, one process per card) the trainer
shards the model onto it (``shard_model``: tensor parallelism, or the time
axis under ring attention), each step reduces the gradient
(``Optimizer.reduce_gradients``) and runs the collectives inside the group's
CUDA graph, the metric sums are reduced over the data group at log
boundaries, and the validation pass evaluates this rank's rows and reduces
them. A checkpoint gathers every sharded parameter and optimizer buffer to
full tensors, which only the primary process writes (the others wait at a
barrier), so any world, ``cli.sample`` included, restores it; resume loads
the full state on every process, shards it and checks that every process
resumed at the same step. Logs and scalars come from the primary; the
generation-health probe and in-training sampling are off, as in the JAX
package (``trainer.py:117-164, 226-227``). A stop signal takes effect at the
next log boundary, where the processes agree on it.

Resume restores the parameters, the optimizer's state, the step, the
generator and, unlike the JAX package, the order of the training batches,
so a run resumed from a checkpoint at an epoch boundary continues as it
would have uninterrupted. It copies into the tensors a captured graph
reads.
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
import torch.distributed as dist

from ..data.dataset import Dataset
from ..data.prefetch import DeviceBatch, PrefetchingDataset
from ..midi.vocab import EOS_ID, PAD_ID
from ..models.vae import StyleVAE
from ..parallel.distributed import _slice_batch, assert_in_sync
from ..parallel.mesh import FlatSync, gather_flat, shard_flat, shard_model, use_mesh
from . import checkpoint as ckpt
from .graph import GraphedSteps
from .metrics import MetricAccumulator, accumulate
from .optimizer import Optimizer, OptimizerConfig
from .train_step import (LossConfig, TrainState, batch_tensors, eval_step, metric_names,
                         step_body)


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
    # When set, a torch.profiler trace of steps [profile_start, profile_stop)
    # is written here.
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_stop: int = 20
    # Host->device input prefetch depth (0 disables; data/prefetch.py).
    prefetch: int = 2
    # Per-parameter gradient-norm scalars (reference: trainer.py:257-270).
    log_param_grad_norms: bool = False
    # Gradient accumulation: apply the optimizer every k steps
    # (optax.MultiSteps); effective batch = k * batch_size.
    grad_accum_steps: int = 1


class Trainer:
    def __init__(self, config: TrainConfig, model: StyleVAE, sampler=None, mesh=None):
        """``model`` lives on the device it trains on, whole (the same on
        every process of a ``mesh``, which shards it); its parameters are
        re-pointed into the optimizer's flat buffer."""
        self.config = config
        self.model = model
        self.mesh = mesh
        self.primary = mesh is None or mesh.is_primary
        self.device = model.device
        sync = None
        self.layout = None
        if mesh is not None:
            self.layout = shard_model(model, mesh)
            sync = FlatSync(mesh, self.layout, self.device)
            if sampler is not None:
                print("Mesh run: in-training sampling disabled")
                sampler = None
        self.sampler = sampler
        self.optimizer = Optimizer(list(model.parameters()), config.optimizer,
                                   accumulate_steps=config.grad_accum_steps, sync=sync)
        self.loss_config = LossConfig(
            kl_weight=config.kl_loss_weight,
            label_smoothing=config.label_smoothing,
            kl_anneal_steps=config.kl_anneal_steps,
            free_bits=config.free_bits,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        # the step count and the metric sums, on the device
        self.state = TrainState(metric_names(model, config.log_param_grad_norms), self.device)
        self.graphs = (GraphedSteps(model, self.optimizer, self.loss_config, self.state,
                                    self.generator, max(1, config.steps_per_dispatch))
                       if self.device.type == "cuda" else None)
        self.progress = ckpt.TrainingProgress()
        self._profiler = None
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
        if cfg.gen_health_rows > 0 and self.mesh is None:
            # Taken before the resume, which then restores the batch order
            # that this draw would otherwise shift (without validation data
            # the probe rows come from the training set).
            src = validation_dataset if validation_dataset is not None else dataset
            self._health_classes = src.num_classes()
            b = next(iter(src))
            n = min(cfg.gen_health_rows, int(b.tokens.shape[0]))
            self._health_batch = tuple(torch.as_tensor(x[:n]).long().to(self.device)
                                       for x in (b.tokens, b.seq_lens))
        with use_mesh(self.mesh):
            self._load_latest_checkpoint(model_folder)
        self._batches_at_start = self.progress.n_batches
        self._last_log = None
        self._stop_requested = False
        if cfg.prefetch > 0:
            dataset = PrefetchingDataset(dataset, cfg.prefetch, self.device)
        restore_handlers = self._install_signal_handlers()
        try:
            with use_mesh(self.mesh):
                self._fit_loop(dataset, model_folder, epochs, validation_dataset, start_time)
        finally:
            restore_handlers()
            if self._profiler is not None:  # training ended inside the window
                self._stop_profiler()

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT: finish the current batch, checkpoint, return."""
        previous = {}

        def restore():
            for sig, handler in previous.items():
                signal.signal(sig, handler)

        def _request_stop(signum, frame):
            self._log(f"Signal {signum}: checkpointing and stopping after this batch.")
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
            if group and self._run_group(group, epoch, model_folder, validation_dataset,
                                         start_time, dataset):  # the epoch's remainder
                return
            group = []
        if self.progress.n_batches != self._last_ckpt_batches:
            self._checkpoint(model_folder, validation_dataset)
            self._log(f"Final checkpoint {self.progress.n_checkpoints} written.")

    def _run_group(self, group, epoch, model_folder, validation_dataset,
                   start_time, dataset) -> bool:
        """Run a group of batches, then the ticks that the group crossed.
        Returns True when training should stop."""
        cfg = self.config
        prev = self.progress.n_batches
        if cfg.profile_dir is not None:
            # Snapped to group boundaries (the JAX package's trainer.py:348-360):
            # a running trace stops at the first boundary at or after
            # profile_stop, and starts before the group that covers
            # profile_start.
            if self._profiler is not None and prev >= cfg.profile_stop:
                self._stop_profiler()
            if prev <= cfg.profile_start < prev + len(group) and self._profiler is None:
                self._start_profiler()
        staged = [b if isinstance(b, DeviceBatch) else DeviceBatch(b, batch_tensors(b, self.device))
                  for b in group]
        self.train_batches([b.tensors for b in staged])
        self.progress.n_batches += len(group)
        nb = self.progress.n_batches

        log_tick = nb // cfg.log_every > prev // cfg.log_every
        stop = self._stop_requested
        if self.mesh is not None:  # every process stops at one boundary, or none
            stop = log_tick and self._agree(stop)
        if stop:
            self._checkpoint(model_folder, validation_dataset)
            self._log(f"Stopped on signal; checkpoint {self.progress.n_checkpoints} written.")
            return True
        if log_tick:
            self._periodic_log(epoch, start_time)
        if nb // cfg.checkpoint_frequency > prev // cfg.checkpoint_frequency:
            self._checkpoint(model_folder, validation_dataset)
            if (self.progress.num_checkpoints_not_improved
                    == cfg.num_checkpoints_not_improved):
                self._log("Maximum checkpoints not improved reached. Stopping training.")
                return True
        if (self.sampler is not None and cfg.sampling_frequency > 0
                and nb // cfg.sampling_frequency > prev // cfg.sampling_frequency):
            with self._eval_mode():
                self.sampler.process_batch(staged[-1].batch,
                                           os.path.join(model_folder, f"samples/step-{nb}"),
                                           dataset.num_classes())
        return False

    def train_batches(self, group) -> None:
        """One training step per (tokens, seq_lens, classes, labels) of
        ``group``: one graph replay on CUDA, eager steps on the CPU."""
        with use_mesh(self.mesh):
            if self.graphs is not None:
                self.graphs.run(group)
                return
            for tensors in group:
                step_body(self.model, self.optimizer, self.loss_config, self.state, *tensors,
                          generator=self.generator)

    def _log(self, msg: str) -> None:
        if self.primary:
            print(msg)

    def _agree(self, flag: bool) -> bool:
        """Whether any process of the mesh raised ``flag``."""
        x = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(x)
        return bool(x.item() > 0)

    def _reduce_pairs(self, sums: torch.Tensor, counts: torch.Tensor):
        """(sum, count) vectors summed over the data group (copies)."""
        if self.mesh is None:
            return sums, counts
        both = torch.stack([sums, counts]).float()
        self.mesh.all_reduce_data_sum_(both)
        return both[0], both[1]

    @property
    def step(self) -> int:
        """The steps taken (a host read of the device count)."""
        return int(self.state.step)

    def _start_profiler(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def _stop_profiler(self) -> None:
        self._profiler.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        suffix = "" if self.mesh is None else f"-proc{self.mesh.rank}"  # a trace a process
        path = os.path.join(self.config.profile_dir, f"trace{suffix}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        self._log(f"Profiler trace written to {path}")

    @contextlib.contextmanager
    def _eval_mode(self):
        self.model.eval()
        try:
            yield
        finally:
            self.model.train()

    # ------------------------------------------------------------------

    def _eval_pass(self, validation_dataset: Dataset) -> float:
        """Every process iterates the whole validation set and evaluates its
        data rank's rows; the (sum, count) pairs are summed over the data
        group."""
        acc: Dict = {}
        with self._eval_mode():
            for batch in validation_dataset:
                if self.mesh is not None:
                    rows = batch.batch_size // self.mesh.dp
                    lo = self.mesh.data_rank * rows
                    batch = _slice_batch(batch, lo, lo + rows)
                acc = accumulate(acc, eval_step(self.model, self.loss_config,
                                                *batch_tensors(batch, self.device),
                                                batch.num_valid))
        names = list(acc)
        sums, counts = self._reduce_pairs(torch.stack([acc[n][0] for n in names]),
                                          torch.stack([acc[n][1] for n in names]))
        host = MetricAccumulator()
        host.update({n: (sums[i], counts[i]) for i, n in enumerate(names)})
        vals = host.get()
        self._write_scalars({f"validation_{k}": v for k, v in vals.items()})
        self._log("Validation: " + " ".join(f"{k}={v:.3f}" for k, v in sorted(vals.items())))
        # Under KL annealing the total's beta rises across checkpoints, so
        # track the beta-independent reconstruction CE (as the JAX package).
        if self.config.kl_anneal_steps > 0:
            return vals["ce_loss"]
        return vals["total_loss"]

    def _full(self, flat: torch.Tensor) -> torch.Tensor:
        """A flat buffer of this rank made the whole model's (a collective
        over the model group under tensor parallelism)."""
        if self.layout is None:
            return flat
        return gather_flat(flat, self.layout, self.mesh)

    def _checkpoint(self, model_folder: str, validation_dataset) -> None:
        self._last_ckpt_batches = self.progress.n_batches
        self.progress.n_checkpoints += 1
        n = self.progress.n_checkpoints
        self._log(f"\nCheckpoint {n} reached.")
        data_rng = getattr(self._dataset, "_rng", None)
        local = self.optimizer.flat.numel()
        params = self._full(self.optimizer.flat)
        opt_state = {k: (self._full(v) if v.numel() == local else v)
                     for k, v in self.optimizer.state_dict().items()}
        if self.primary:
            ckpt.save_checkpoint(model_folder, n, {
                "params": params,
                "optimizer": opt_state,
                "step": self.step,
                "generator": self.generator.get_state(),
                "data_rng": data_rng.bit_generator.state if data_rng is not None else None,
            })
            ckpt.export_inference(model_folder, n, self._whole_model(params))
            self.progress.save(model_folder)
            if self.config.keep_checkpoints > 0:
                ckpt.prune_checkpoints(model_folder, self.config.keep_checkpoints)
        if self.mesh is not None:
            dist.barrier()  # the files exist before any process reads them
        self.state.reset_metrics()  # reset running metrics (trainer.py:210)

        if self._health_batch is not None:
            vals = self._generation_health()
            self._write_scalars(vals)
            self._log("Generation health: "
                  + " ".join(f"{k}={v:.3f}" for k, v in sorted(vals.items())))
        if self.optimizer.skip_nonfinite:
            skipped = int(self.optimizer.state["total_notfinite"])
            if skipped:
                self._log(f"Non-finite gradient updates skipped: {skipped}")
            self._write_scalars({"nonfinite_updates_skipped": skipped})

        if validation_dataset is None:
            return
        loss = self._eval_pass(validation_dataset)
        if loss < self.progress.best_reconstruction_loss:
            self._log(f"Loss improved from {self.progress.best_reconstruction_loss} to {loss}.")
            self.progress.best_reconstruction_loss = loss
            self.progress.num_checkpoints_not_improved = 0
        else:
            self.progress.num_checkpoints_not_improved += 1
            self._log(f"Loss did not improve. {self.progress.num_checkpoints_not_improved} "
                      f"out of {self.config.num_checkpoints_not_improved} unsuccessful "
                      "checkpoints")
            self._log(f"Best loss thus far: {self.progress.best_reconstruction_loss}")
        if self.primary:
            self.progress.save(model_folder)

    def _whole_model(self, params: torch.Tensor) -> StyleVAE:
        """The model whole, from the full flat parameters: the model itself
        unless a mesh sliced it, else a copy on the CPU."""
        if self.layout is None or all(s.dim is None for s in self.layout):
            return self.model
        whole = StyleVAE(self.model.config)
        with torch.no_grad():
            offset = 0
            for p in whole.parameters():
                p.copy_(params[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
        return whole

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
        self._log(f"Looking into folder {model_folder} for a valid training.")
        indices = ckpt.checkpoint_indices(model_folder)
        if not indices:
            self._log("No checkpoint was found. Starting training from scratch")
        for idx in reversed(indices):
            self._log(f"Checkpoint {idx} found. Resuming training.")
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
                self._log(f"Bookkeeping ({self.progress.n_checkpoints}) is ahead of the "
                          f"restored checkpoint ({idx}); reconciling.")
                self.progress.n_checkpoints = idx
                self.progress.n_batches = self.step
            break
        if self.mesh is not None:
            # every process must resume at one step, or the run mixes states
            assert_in_sync(self.mesh, float(self.step), "the resumed training step")

    def _restore(self, state) -> None:
        """Copy a checkpoint's full state into this rank's tensors (its
        slices of them under tensor parallelism)."""
        params = state["params"]
        full = sum(s.numel for s in self.layout) if self.layout else self.optimizer.flat.numel()
        if params.numel() != full:
            raise ValueError(f"{params.numel()} parameters in the checkpoint, {full} in the model")
        if self.layout is not None:
            params = shard_flat(params, self.layout, self.mesh)
            state = dict(state, optimizer={
                k: (shard_flat(v, self.layout, self.mesh) if v.numel() == full else v)
                for k, v in state["optimizer"].items()})
        self.optimizer.load_state_dict(state["optimizer"])
        with torch.no_grad():
            self.optimizer.flat.copy_(params)
            self.state.step.fill_(int(state["step"]))
        self.optimizer.params_changed()
        self.generator.set_state(state["generator"])
        data_rng = getattr(self._dataset, "_rng", None)
        if data_rng is not None and state.get("data_rng") is not None:
            data_rng.bit_generator.state = state["data_rng"]

    # ------------------------------------------------------------------

    def _write_scalars(self, scalars: Dict[str, float]) -> None:
        if not self.primary:
            return
        os.makedirs(self.config.logdir, exist_ok=True)
        line = {"step": self.progress.n_batches}
        line.update({k: (v if math.isfinite(v) else str(v)) for k, v in scalars.items()})
        with open(os.path.join(self.config.logdir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")

    def _periodic_log(self, epoch: int, start_time: float) -> None:
        sums, counts = self._reduce_pairs(self.state.sums, self.state.counts)
        host = MetricAccumulator()
        host.update({n: (sums[i], counts[i]) for i, n in enumerate(self.state.names)})
        self.state.reset_metrics()
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
        self._log(f"Epoch [{epoch}] Batch [{self.progress.n_batches}] "
              f"updates/sec: {ups:.2f}{window} {line}")


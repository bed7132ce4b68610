"""The multi-process dry run: every parallel path of the port, once, on a
tiny model, across a world of N processes (counterpart of
``__graft_entry__.dryrun_multichip``, body ``_dryrun_body``).

    python -m musicstyletransfer_torch.dryrun --processes N [--cpu]

spawns N ranks: one process a card on NCCL (raising where the host has
fewer than N cards), or with ``--cpu`` N CPU processes on gloo. Each rank
runs the legs in order; rank 0 prints one ``dryrun <leg> OK: ...`` line a
leg (``SKIPPED (...)`` where the JAX leg skips, on an odd world), then one
summary line. A failed rank fails the run (the others are stopped) and the
command exits non-zero; nothing is caught.

The legs, on the model of ``_make_dryrun_model`` (D=32, 2 heads, FFN 128,
2 layers, L=8, float32, dropout 0.1):

- a training step (``Trainer(mesh=)``) at tp=2, tp=1 and, where 4 divides
  N, tp=4; and at tp=2 with the attention core forced
  (``attention_core_min_seq_len=1``);
- ``sharded_sample_sequences`` on a pure-DP mesh with K1 forced
  (``use_fused=True``; its plain version on the CPU), greedy, D=128;
- a ring-attention training step (tp=2, L=10);
- pipeline parallelism: MLP stages at pp = 4 (or 2) against the stages in
  sequence, and a 4-layer 16-head stack as 2 stages whose forward and
  gradients equal the sequential stack's;
- a GAN data-parallel D and G step (``make_gan_steps(mesh=)``);
- the streaming engine under ``mesh=`` (the slots over the data axis): one
  MIDI request transferred into every class.

The JAX body's last leg, ``_dryrun_real_shape_lowering``, lowers XLA
programs at the shipped shapes without running them; it has no torch
counterpart and is left out.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

VOCAB, CLASSES = 293, 2


def _log(mesh, msg: str) -> None:
    if mesh.is_primary:
        print(msg, flush=True)


def dryrun_model(L: int = 8, core_min: int = 0, ring: bool = False, size: int = 32,
                 layers: int = 2, dropout: float = 0.1):
    """``_make_dryrun_model``'s model: D=32, 2 heads, FFN 128, 2 layers,
    float32; ``core_min`` > 0 routes attention through the core at T >=
    core_min; ``ring`` sets ring_attention."""
    from .models import (DecoderConfig, EncoderConfig, ModelConfig, StyleVAE,
                         TransformerConfig, init_params)

    tc = TransformerConfig(model_size=size, num_layers=layers, num_heads=2, dropout=dropout,
                           vocab_size=VOCAB, sequence_sharding=True,
                           use_flash_attention=core_min > 0,
                           attention_core_min_seq_len=core_min or 256, ring_attention=ring)
    config = ModelConfig(
        EncoderConfig(tc, latent_dim=16, num_classes=CLASSES, input_dim=VOCAB),
        DecoderConfig(tc, latent_dim=16, num_classes=CLASSES, output_dim=VOCAB),
        dtype="float32")
    return init_params(StyleVAE(config), 0)


def dryrun_batch(B: int, L: int, seed: int):
    """(tokens [B, L+1] SOS-prefixed, seq_lens, classes, labels) of random
    body tokens."""
    rng = np.random.default_rng(seed)
    tokens = np.concatenate([np.ones((B, 1), np.int64), rng.integers(3, VOCAB, (B, L))], 1)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), 2, np.int64)], 1)
    seq_lens = np.full(B, L + 1, np.int64)
    classes = rng.integers(0, CLASSES, B)
    return [torch.as_tensor(a) for a in (tokens, seq_lens, classes, labels)]


def _train_step(tp: int, L: int = 8, core_min: int = 0, ring: bool = False, seed: int = 0):
    """One sharded training step on the (N/tp, tp) mesh: (the global batch's
    mean total loss, the mesh)."""
    from .parallel import make_mesh, shard_batch
    from .training import OptimizerConfig, TrainConfig, Trainer

    mesh = make_mesh(tp)
    model = dryrun_model(L, core_min, ring).to(mesh.device)
    trainer = Trainer(TrainConfig(optimizer=OptimizerConfig("adam", "clip_gradient:1.0", 1e-3),
                                  prefetch=0, logdir=os.path.join(tempfile.gettempdir(), "unused")),
                      model, mesh=mesh)
    batch = [x.to(mesh.device) for x in dryrun_batch(2 * mesh.dp, L, seed)]
    trainer.train_batches([shard_batch(batch, mesh)])
    sums, counts = trainer._reduce_pairs(trainer.state.sums, trainer.state.counts)
    total = float(sums[trainer.state.names.index("total_loss")]
                  / counts[trainer.state.names.index("total_loss")])
    if not np.isfinite(total) or trainer.step != 1:
        raise RuntimeError(f"train step at tp={tp}: loss {total}, step {trainer.step}")
    return total, mesh


def leg_train_steps(world: int) -> List[int]:
    tps = [2] if world % 2 == 0 else [1]
    if 1 not in tps:
        tps.append(1)
    if world % 4 == 0:
        tps.append(4)
    for tp in tps:
        total, mesh = _train_step(tp)
        _log(mesh, f"dryrun train step OK: mesh={dict(mesh.shape)}, total_loss={total:.4f}")
    if world % 2 == 0:
        total, mesh = _train_step(2, core_min=1)
        _log(mesh, f"dryrun train step OK: mesh={dict(mesh.shape)} (attention core), "
                   f"total_loss={total:.4f}")
    return tps


def leg_sharded_sample(world: int) -> None:
    from .inference import sharded_sample_sequences
    from .parallel import make_mesh

    mesh = make_mesh(1)
    L = 8
    model = dryrun_model(L, size=128, layers=1, dropout=0.0).to(mesh.device).eval()
    tokens, seq_lens, classes, _ = (x.to(mesh.device) for x in dryrun_batch(2 * world, L, 1))
    seqs, scores = sharded_sample_sequences(model, tokens, seq_lens, classes, 2 * (L + 1),
                                            torch.Generator(device=mesh.device).manual_seed(7),
                                            mesh, greedy=True, use_fused=True)
    if tuple(seqs.shape) != (2 * world, 2 * (L + 1)) or not bool((seqs[:, 0] == 1).all()):
        raise RuntimeError(f"sharded sample: shape {tuple(seqs.shape)}, first column "
                           f"{seqs[:, 0].tolist()}")
    if not bool(torch.isfinite(scores.float()).all()):
        raise RuntimeError("sharded sample: non-finite scores")
    _log(mesh, f"dryrun sharded fused sample OK: mesh={dict(mesh.shape)}, B={2 * world}")


def leg_ring(world: int) -> None:
    tp = 2 if world % 2 == 0 else 1
    total, mesh = _train_step(tp, L=10, ring=True, seed=2)
    _log(mesh, f"dryrun ring-attention train step OK: mesh={dict(mesh.shape)}, "
               f"total_loss={total:.4f}")


def leg_pipeline(world: int) -> None:
    """MLP stages against the stages in sequence (1e-6), then a 4-layer
    16-head stack (D=64) as 2 stages of 2 layers: forward 1e-5 and the
    gradients of mean(out**2) 2e-4 against the sequential stack."""
    from .models.config import TransformerConfig
    from .models.transformer import TransformerStack
    from .parallel import make_mesh, pipeline_apply, pipeline_transformer_stack
    from .parallel.pipeline import sequential_apply

    pp = 4 if world % 4 == 0 else (2 if world % 2 == 0 else 1)
    if pp == 1:
        if dist.get_rank() == 0:
            print("dryrun pipeline SKIPPED (no even mesh axis)", flush=True)
        return
    mesh = make_mesh(pp)
    dev = mesh.device
    rng = np.random.default_rng(3)
    d, B = 8, 8
    params = {"w": torch.tensor(rng.normal(scale=0.5, size=(pp, d, d)), dtype=torch.float32,
                                device=dev),
              "b": torch.tensor(rng.normal(scale=0.1, size=(pp, d)), dtype=torch.float32,
                                device=dev)}
    x = torch.tensor(rng.normal(size=(B, d)), dtype=torch.float32, device=dev)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    with torch.no_grad():
        got = pipeline_apply(stage, params, x, mesh=mesh, microbatches=4)
    err = float((got - sequential_apply(stage, params, x, pp)).abs().max())
    if err > 1e-6:
        raise RuntimeError(f"pipeline pp={pp}: max|err| {err} against the stages in sequence")
    _log(mesh, f"dryrun pipeline OK: pp={pp}, microbatches=4, max|err| {err:.3g}")

    mesh = make_mesh(2)
    cfg = TransformerConfig(model_size=64, num_layers=4, num_heads=16, dropout=0.0)
    torch.manual_seed(5)
    stack = TransformerStack(cfg, True, torch.float32).to(dev)
    T = 8
    xt = torch.tensor(rng.normal(size=(4, T, 64)), dtype=torch.float32, device=dev)
    lens = torch.tensor([T, T - 2, T - 4, 3], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    out = pipeline_transformer_stack(stack, xt, mask, mesh=mesh, microbatches=2)
    out.pow(2).mean().backward()
    grads = {n: p.grad.clone() for n, p in stack.named_parameters()}
    for g in grads.values():
        mesh.all_reduce_model_sum_(g)  # each rank holds its own stage's
    stack.zero_grad()
    ref = stack.eval()(xt, mask)
    ref.pow(2).mean().backward()
    out_err = float((out - ref).abs().max())
    grad_err = max(float((grads[n] - p.grad).abs().max()) for n, p in stack.named_parameters())
    if out_err > 1e-5 or grad_err > 2e-4:
        raise RuntimeError(f"transformer pipeline: out max|err| {out_err}, grads {grad_err}")
    _log(mesh, f"dryrun transformer pipeline OK: 4 layers as pp=2 stages of 2, out max|err| "
               f"{out_err:.3g}, grads == sequential (max|err| {grad_err:.3g})")


def leg_gan(world: int) -> None:
    from .models.config import DiscriminatorConfig, GANConfig, GeneratorConfig
    from .parallel import make_mesh, shard_batch
    from .training import GANTrainConfig, make_gan_steps

    mesh = make_mesh(1)
    L = 8
    cfg = GANConfig(GeneratorConfig(n_layers=1, hidden_dim=32, emb_dim=16, noise_dim=8,
                                    num_classes=CLASSES, output_dim=VOCAB, max_seq_len=L),
                    DiscriminatorConfig(n_layers=1, hidden_dim=32, emb_dim=16,
                                        num_classes=CLASSES, input_dim=VOCAB),
                    dtype="float32")
    steps = make_gan_steps(cfg, GANTrainConfig(), mesh=mesh)
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(3, VOCAB, (2 * world, L)), device=mesh.device)
    classes = torch.as_tensor(rng.integers(0, CLASSES, 2 * world), device=mesh.device)
    tokens, classes = shard_batch([tokens, classes], mesh)
    steps.d_step(tokens, classes)
    steps.g_step(classes)
    m = steps.metrics()
    if not (np.isfinite(m["d_loss"]) and np.isfinite(m["g_loss"])):
        raise RuntimeError(f"GAN step: {m}")
    _log(mesh, f"dryrun GAN dp step OK: mesh={dict(mesh.shape)}, d_loss={m['d_loss']:.4f}, "
               f"g_loss={m['g_loss']:.4f}")


def leg_streaming(world: int) -> None:
    """One request through StreamingTransferEngine(mesh=) on a pure-DP mesh
    of ``world`` slots (one a rank); the followers serve until the
    primary's stop."""
    from .inference.streaming import StreamingTransferEngine
    from .midi import smf
    from .midi.codec import Melody, MelodyWriter
    from .midi.vocab import note_on_id, timeshift_id
    from .parallel import make_mesh
    from .training.checkpoint import export_inference

    mesh = make_mesh(1)
    with tempfile.TemporaryDirectory() as folder:  # each rank exports the same seeded model
        export_inference(folder, 1, dryrun_model(8, layers=1, dropout=0.0))
        eng = StreamingTransferEngine(folder, checkpoint=-1, slots=world, max_seq_len=8,
                                      segment_steps=4, admit_size=CLASSES, greedy=True,
                                      mesh=mesh, harvest_delay_s=0.0)
        if eng.local_slots * mesh.dp != world or mesh.dp != world:
            raise RuntimeError(f"engine slots: {eng.local_slots} a rank over {mesh.dp}")
        if not mesh.is_primary:
            eng.serve_follower()
            return
        melody = Melody(tokens=np.asarray([note_on_id(60), timeshift_id(120), note_on_id(64)],
                                          np.int32))
        result = eng.submit_midi(smf.dump_midifile(MelodyWriter().to_midifile(melody)))
        eng.stop()
    if set(result.tokens_by_class) != set(range(CLASSES)):
        raise RuntimeError(f"streaming: classes {sorted(result.tokens_by_class)}")
    _log(mesh, f"dryrun streaming mesh OK: mesh={dict(mesh.shape)}, slots={world} "
               f"({eng.local_slots} a rank)")


def body(world: int) -> None:
    """Every leg, in ``_dryrun_body``'s order, on this rank."""
    tps = leg_train_steps(world)
    leg_sharded_sample(world)
    leg_ring(world)
    leg_pipeline(world)
    leg_gan(world)
    leg_streaming(world)
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({world}) OK: train tp={tps}"
              + (" (+tp=2 attention core)" if world % 2 == 0 else "")
              + f", sharded fused sample dp={world}, ring-attention sp, pipeline pp, GAN dp, "
              "streaming mesh (the XLA real-shape lowering has no torch counterpart)",
              flush=True)


def run_rank(rank: int, world: int, port: int, cpu: bool) -> None:
    from .parallel import initialize_distributed

    if cpu:
        torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           None if cpu else torch.device("cuda", rank))
    try:
        body(world)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(processes: int, cpu: bool, timeout: float = 300.0) -> int:
    """Spawn the ranks; rank 0 writes to this process's output, the others
    to files shown where a rank fails. A rank that fails, or a run longer
    than ``timeout`` seconds (the run takes ~12 s on 4 CPU processes, ~50 s
    on 4 cards), stops every rank. Returns the exit code."""
    if not cpu and torch.cuda.device_count() < processes:
        raise RuntimeError(f"--processes {processes} needs {processes} CUDA cards, the host "
                           f"has {torch.cuda.device_count()} (--cpu runs gloo on the CPU)")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    logs, procs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(processes):
            cmd = [sys.executable, "-m", "musicstyletransfer_torch.dryrun", "--rank", str(r),
                   "--processes", str(processes), "--port", str(port)] + (["--cpu"] if cpu else [])
            out = None if r == 0 else open(os.path.join(tmp, f"rank{r}.log"), "w")
            logs.append(out)
            procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                          stderr=subprocess.STDOUT if out else None))
        deadline = time.time() + timeout
        failed: Optional[int] = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.time() > deadline:
                failed = bad[0] if bad else -1
                break
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            if f is not None:
                f.close()
        codes = [p.returncode for p in procs]
        if failed is None and all(c == 0 for c in codes):
            return 0
        for r in range(1, processes):
            if codes[r] != 0:
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    sys.stderr.write(f"--- rank {r} (exit {codes[r]}) ---\n{f.read()[-4000:]}")
        print(f"dryrun: failed (exit codes {codes}"
              + (", timed out" if failed == -1 else "") + ")", file=sys.stderr, flush=True)
        return 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--processes", type=int, required=True)
    parser.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        run_rank(args.rank, args.processes, args.port, args.cpu)
        return 0
    return launch(args.processes, args.cpu)


if __name__ == "__main__":
    sys.exit(main())

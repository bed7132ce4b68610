"""Argparse surface matching the reference flag names.

The PyTorch port's own copy of ``musicstyletransfer_tpu/cli/flags.py`` (the port imports
nothing of the JAX package); the two stay in step, and
``tests/test_torch_host_layers.py`` holds them to the same results.

Reference: VarAutoEncoder/config.py:1-75. Flags, grouping, defaults and the
``parse_known_args`` behavior are preserved; TPU-era additions are grouped
under 'TPU'. In the port, ``--gpu`` (or neither flag) runs on CUDA and
``--cpu`` on the CPU (``musicstyletransfer_torch.utils.resolve_device``).
"""

from __future__ import annotations

import argparse


def str2bool(v: str) -> bool:
    return v.lower() in ("true", "1")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()

    net = parser.add_argument_group("Network")
    net.add_argument("--e-n-layers", type=int, default=1)
    net.add_argument("--e-rnn-hidden-dim", type=int, default=128)
    net.add_argument(
        "--e-emb-hidden-dim", type=int, default=64,
        help="accepted for reference CLI parity; INERT (the reference never "
             "reads it either — embeddings are model_size-dimensional)",
    )
    net.add_argument("--e-dropout", type=float, default=0.0)
    net.add_argument("--e-num-heads", type=int, default=8)
    net.add_argument("--latent-dim", type=int, default=64)
    net.add_argument("--d-n-layers", type=int, default=1)
    net.add_argument("--d-rnn-hidden-dim", type=int, default=128)
    net.add_argument("--d-dropout", type=float, default=0.0)
    net.add_argument(
        "--decoder-type", choices=["transformer", "lstm"], default="transformer"
    )

    data = parser.add_argument_group("Data")
    data.add_argument("--batch-size", type=int, default=1)
    data.add_argument("--max-seq-len", type=int, default=64)
    data.add_argument("--slices-per-quarter-note", type=float, default=4)
    data.add_argument("--data", type=str, default="data")
    data.add_argument("--validation-data", type=str, default=None)
    data.add_argument("--minimum-pattern-length", type=int, default=16)
    data.add_argument(
        "--pattern-identifier", type=str, choices=["recurring", ""], default=""
    )

    train = parser.add_argument_group("Training")
    train.add_argument("--epochs", type=int, default=5000)
    train.add_argument("--learning-rate", type=float, default=3e-4)
    train.add_argument("--optimizer", type=str, default="adam")
    train.add_argument("--optimizer-params", type=str, default="")
    train.add_argument("--validation-split", type=float, default=0.1)
    train.add_argument("--kl-loss", type=float, default=1.0)
    train.add_argument("--label-smoothing", type=float, default=0.0)
    train.add_argument("--negative-label-downscaling", action="store_true")
    train.add_argument("--beam-size", type=int, default=5)
    train.add_argument(
        "--sampling-type", choices=["beam-search", "sampling"], default="sampling"
    )

    misc = parser.add_argument_group("Misc")
    misc.add_argument(
        "--load-checkpoint", type=int, default=1,
        help="accepted for reference CLI parity; INERT (the reference never "
             "reads it either — resume always picks the latest checkpoint)",
    )
    misc.add_argument("--checkpoint-frequency", type=int, default=5000)
    misc.add_argument("--sampling-frequency", type=int, default=1000)
    misc.add_argument("--num-checkpoints-not-improved", type=int, default=10)
    misc.add_argument("--out-samples", "-o", type=str, default=None)
    misc.add_argument("--model-output", "-m", type=str, default="models")
    misc.add_argument("--checkpoint", "-c", type=int, default=-1)
    misc.add_argument("--gpu", action="store_true",
                      help="run on CUDA (the default; fails without a card)")
    misc.add_argument("--toy", action="store_true")
    misc.add_argument("--visualize-samples", action="store_true")
    misc.add_argument("--verbose", action="store_true")

    tpu = parser.add_argument_group("TPU")
    tpu.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel ways over the device mesh's 'model' axis",
    )
    tpu.add_argument(
        "--dtype", choices=["bfloat16", "float32"], default="bfloat16",
        help="activation compute dtype (params stay float32)",
    )
    tpu.add_argument("--logdir", type=str, default="/tmp/out",
                     help="TensorBoard logdir (reference hardcodes /tmp/out)")
    tpu.add_argument("--seed", type=int, default=0)
    tpu.add_argument("--cpu", action="store_true",
                     help="run on the CPU (tests/dev)")
    tpu.add_argument("--use-flash-attention", action="store_true",
                     help="Pallas fused attention in the transformer stacks")
    tpu.add_argument("--norm-scheme", choices=["post", "pre"],
                     default="post",
                     help="residual-norm placement: 'post' is the "
                          "reference's post-LN block; 'pre' is the "
                          "modern pre-LN block whose backward flows "
                          "through an identity residual path (stable at "
                          "the wide config where post-LN's backward "
                          "measurably runs away; BASELINE.md)")
    tpu.add_argument("--attention-core-xla-backward", action="store_true",
                     help="route the short-T attention core's backward "
                          "through XLA einsums instead of the Pallas "
                          "backward kernel (overflow-robust at extreme "
                          "gradient spikes; see BASELINE.md wide NaN "
                          "post-mortem)")
    tpu.add_argument("--prefetch", type=int, default=2,
                     help="host->device input prefetch depth (0 disables)")
    tpu.add_argument("--grad-accum-steps", type=int, default=1,
                     help="gradient accumulation micro-steps")
    tpu.add_argument("--steps-per-dispatch", type=int, default=1,
                     help="train steps fused into one dispatched program "
                          "(lax.scan); amortizes host dispatch on small "
                          "configs — semantics identical, ticks snap to "
                          "dispatch boundaries")
    tpu.add_argument("--log-param-grad-norms", action="store_true",
                     help="per-parameter gradient-norm TB scalars")
    tpu.add_argument("--profile-dir", type=str, default=None,
                     help="write a jax.profiler trace of steps 10-20 here")
    tpu.add_argument("--temperature", type=float, default=1.0,
                     help="sampling temperature for ancestral decoding")
    tpu.add_argument("--top-k", type=int, default=0,
                     help="restrict sampling to the k most likely tokens "
                          "(0 = off)")
    tpu.add_argument("--top-p", type=float, default=0.0,
                     help="nucleus sampling: smallest token set with "
                          "cumulative probability >= p (0 = off)")
    tpu.add_argument("--kl-anneal-steps", type=int, default=0,
                     help="linear KL warmup steps (0 = constant weight)")
    tpu.add_argument("--free-bits", type=float, default=0.0,
                     help="per-dimension KL floor (posterior-collapse guard)")
    tpu.add_argument("--remat", action="store_true",
                     help="rematerialize transformer layers in backward")
    tpu.add_argument("--ring-attention", action="store_true",
                     help="sequence-parallel ring attention: shard the time "
                          "axis over the mesh's model axis and rotate K/V "
                          "chunks via ppermute (with --tp N carrying the "
                          "ring; any max-seq-len works — the time axis is "
                          "padded to the ring internally)")
    tpu.add_argument("--keep-checkpoints", type=int, default=0,
                     help="retain only the newest N checkpoints (0 = all)")
    tpu.add_argument("--gen-health-rows", type=int, default=8,
                     help="per-checkpoint generation-health probe: "
                          "style-transfer this many validation rows into "
                          "every class and log termination rate + mean "
                          "generated length (teacher-forced CE misses "
                          "decode collapse; 0 disables)")
    tpu.add_argument("--rng-impl", default="rbg",
                     choices=["rbg", "unsafe_rbg", "threefry2x32"],
                     help="training PRNG; rbg = TPU hardware RNG (1.6x "
                          "faster scaled-config steps), threefry2x32 = "
                          "cross-platform bit-reproducible")
    tpu.add_argument("--length-penalty", type=float, default=0.0,
                     help="beam-search length normalization alpha (0 = off)")
    tpu.add_argument("--class-conditioning",
                     choices=["initial", "per_step"], default="initial",
                     help="decoder class conditioning: 'initial' = only the "
                          "prepended conditioning state (reference "
                          "behavior); 'per_step' = also add the class "
                          "embedding to every decoder position's input "
                          "(measured-necessary for register transfer at "
                          "long sequence lengths; transformer decoder only)")

    dist = parser.add_argument_group(
        "Distributed (multi-process / multi-host; parallel/distributed.py)"
    )
    dist.add_argument("--dist-coordinator", type=str, default=None,
                      help="coordinator host:port; presence enables "
                           "jax.distributed multi-process mode")
    dist.add_argument("--dist-num-processes", type=int, default=1)
    dist.add_argument("--dist-process-id", type=int, default=0)
    dist.add_argument("--dist-num-cpu-devices", type=int, default=None,
                      help="virtual CPU devices per process (CPU fleets "
                           "only; inert on TPU pods)")
    return parser


def get_config(argv=None) -> argparse.Namespace:
    """parse_known_args like the reference (config.py:73-75)."""
    config, _unparsed = build_parser().parse_known_args(argv)
    return config

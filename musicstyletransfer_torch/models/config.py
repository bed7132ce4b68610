"""Model configuration, read from ``<model>/torch/config.json``.

Dataclass twins of ``musicstyletransfer_tpu/models/config.py`` (and of the
GAN family's configs in ``musicstyletransfer_tpu/models/gan.py:53-95``) with
the same field names and defaults. The JSON is written by
``scripts/export-torch-weights.py`` and by the port's own trainer
(``training/checkpoint.py``); unknown keys are ignored on load, the way the
JAX loader ignores unknown YAML keys.

``ring_attention`` acts on a mesh whose model axis is > 1
(``parallel/mesh.py``; ``cli.main --ring-attention --tp N`` with ``--dist-*``):
each rank runs the stacks on its chunk of the time axis and attention goes
around the ring (``models/transformer.py``, ``ops/ring_attention.py``). The
model axis then carries time, not heads, so no parameter is sliced over it.
Without such a mesh it is inert, as the JAX package's ``_ring_eligible`` is,
except that it keeps the attention core out. ``sequence_sharding`` is
recorded for the JAX package's sake: the port shards time exactly where the
ring runs, so the flag adds nothing of its own.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


def _known(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    model_size: int = 128
    dropout: float = 0.0
    num_layers: int = 1
    num_heads: int = 8
    vocab_size: Optional[int] = None
    ffn_multiplier: int = 4
    max_positions: int = 10000
    # The attention dispatch (models/transformer.py): with
    # use_flash_attention, T in [attention_core_min_seq_len,
    # min(flash_min_seq_len, 1024)) runs the attention core (K2 forward, K3
    # backward, ops/attention_core.py); T >= flash_min_seq_len is the flash
    # route (K4 forward, K5 backward, ops/flash_attention.py).
    # attention_core_xla_backward routes the core's backward through the
    # plain twin of the JAX package's XLA backward instead of K3.
    use_flash_attention: bool = False
    flash_min_seq_len: int = 1024
    attention_core_min_seq_len: int = 256
    attention_core_xla_backward: bool = False
    norm_scheme: str = "post"  # "post" | "pre" (pre adds a final LayerNorm)
    sequence_sharding: bool = False
    ring_attention: bool = False
    remat: bool = False  # recompute each layer in the backward (training)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformerConfig":
        return cls(**_known(cls, d))


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    """The legacy LSTM decoder (``decoder_type="lstm"``, ``models/lstm.py``)."""

    n_layers: int = 1
    hidden_dim: int = 128
    dropout: float = 0.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LSTMConfig":
        return cls(**_known(cls, d))


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    transformer_config: TransformerConfig = dataclasses.field(
        default_factory=TransformerConfig
    )
    latent_dim: int = 64
    num_classes: int = 2
    input_dim: int = 293

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EncoderConfig":
        kw = _known(cls, d)
        kw["transformer_config"] = TransformerConfig.from_dict(
            d.get("transformer_config") or {}
        )
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    transformer_config: TransformerConfig = dataclasses.field(
        default_factory=TransformerConfig
    )
    latent_dim: int = 64
    num_classes: int = 2
    output_dim: int = 293
    decoder_type: str = "transformer"  # "transformer" | "lstm"
    lstm_config: Optional[LSTMConfig] = None  # the LSTM decoder's widths
    class_conditioning: str = "initial"  # "initial" | "per_step" (transformer only)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DecoderConfig":
        kw = _known(cls, d)
        kw["transformer_config"] = TransformerConfig.from_dict(
            d.get("transformer_config") or {}
        )
        if d.get("lstm_config") is not None:
            kw["lstm_config"] = LSTMConfig.from_dict(d["lstm_config"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    encoder_config: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    decoder_config: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    dtype: str = "bfloat16"  # activation compute type; parameters stay float32

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        return cls(
            encoder_config=EncoderConfig.from_dict(d.get("encoder_config") or {}),
            decoder_config=DecoderConfig.from_dict(d.get("decoder_config") or {}),
            dtype=d.get("dtype", "bfloat16"),
        )


def load_config(path: str) -> Tuple[ModelConfig, int]:
    """``config.json`` -> (ModelConfig, checkpoint index it was exported from)."""
    with open(path) as f:
        blob = json.load(f)
    return ModelConfig.from_dict(blob["model_config"]), int(blob["checkpoint"])


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """The GAN generator (``--g-*`` and ``--noise-dim`` of ``cli.gan``)."""

    n_layers: int = 1
    hidden_dim: int = 256
    emb_dim: int = 256
    noise_dim: int = 64
    num_classes: int = 2
    output_dim: int = 293
    max_seq_len: int = 64

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GeneratorConfig":
        return cls(**_known(cls, d))


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """The GAN discriminator (``--d-*`` of ``cli.gan``); ``projection`` adds
    the class-projection term to every step's logit."""

    n_layers: int = 1
    hidden_dim: int = 256
    emb_dim: int = 256
    num_classes: int = 2
    input_dim: int = 293
    projection: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DiscriminatorConfig":
        return cls(**_known(cls, d))


@dataclasses.dataclass(frozen=True)
class GANConfig:
    generator_config: GeneratorConfig = dataclasses.field(default_factory=GeneratorConfig)
    discriminator_config: DiscriminatorConfig = dataclasses.field(
        default_factory=DiscriminatorConfig
    )
    dtype: str = "bfloat16"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GANConfig":
        return cls(
            generator_config=GeneratorConfig.from_dict(d.get("generator_config") or {}),
            discriminator_config=DiscriminatorConfig.from_dict(
                d.get("discriminator_config") or {}),
            dtype=d.get("dtype", "bfloat16"),
        )


def load_gan_config(path: str) -> Tuple[GANConfig, int]:
    """A GAN folder's ``config.json`` -> (GANConfig, checkpoint index)."""
    with open(path) as f:
        blob = json.load(f)
    return GANConfig.from_dict(blob["gan_config"]), int(blob["checkpoint"])

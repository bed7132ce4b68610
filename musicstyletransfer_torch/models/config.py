"""Model configuration, read from ``<model>/torch/config.json``.

Dataclass twins of ``musicstyletransfer_tpu/models/config.py`` with the
same field names and defaults for everything the port computes with. The
JSON is written by ``scripts/export-torch-weights.py``; keys the port has
no use for (dropout, the TPU attention-dispatch knobs, sharding, remat) are
ignored on load, the way the JAX loader ignores unknown YAML keys.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple


def _known(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    model_size: int = 128
    num_layers: int = 1
    num_heads: int = 8
    ffn_multiplier: int = 4
    max_positions: int = 10000
    norm_scheme: str = "post"  # "post" | "pre" (pre adds a final LayerNorm)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformerConfig":
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
    decoder_type: str = "transformer"  # "lstm" is not ported yet
    class_conditioning: str = "initial"  # "initial" | "per_step"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DecoderConfig":
        kw = _known(cls, d)
        kw["transformer_config"] = TransformerConfig.from_dict(
            d.get("transformer_config") or {}
        )
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

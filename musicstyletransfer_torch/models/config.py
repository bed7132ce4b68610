"""Model configuration, read from ``<model>/torch/config.json``.

Dataclass twins of ``musicstyletransfer_tpu/models/config.py`` with the
same field names and defaults. The JSON is written by
``scripts/export-torch-weights.py`` and by the port's own trainer
(``training/checkpoint.py``); unknown keys are ignored on load, the way the
JAX loader ignores unknown YAML keys.

Options the port does not have yet are refused, never run some other way:
``remat``, ``ring_attention`` and ``sequence_sharding`` raise
``NotImplementedError`` when a model is built (``TransformerConfig.check``),
and the flash route (T >= ``flash_min_seq_len`` with
``use_flash_attention``) raises when it is reached.
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
    # route (K4/K5), not ported yet. attention_core_xla_backward routes the
    # core's backward through the plain twin of the JAX package's XLA
    # backward instead of K3.
    use_flash_attention: bool = False
    flash_min_seq_len: int = 1024
    attention_core_min_seq_len: int = 256
    attention_core_xla_backward: bool = False
    norm_scheme: str = "post"  # "post" | "pre" (pre adds a final LayerNorm)
    sequence_sharding: bool = False
    ring_attention: bool = False
    remat: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformerConfig":
        return cls(**_known(cls, d))

    def check(self) -> None:
        """Raise for the options the port does not implement yet."""
        missing = {
            "remat": "ROADMAP queue 1, item 7 (torch.utils.checkpoint)",
            "ring_attention": "ROADMAP queue 1, item 9 (multi-GPU)",
            "sequence_sharding": "ROADMAP queue 1, item 9 (multi-GPU)",
        }
        for name, item in missing.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"TransformerConfig.{name}=True is not ported to PyTorch "
                    f"yet: {item}")


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

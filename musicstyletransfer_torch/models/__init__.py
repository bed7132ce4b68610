from .config import DecoderConfig, EncoderConfig, ModelConfig, TransformerConfig
from .vae import StyleVAE, VAEDecoder, VAEEncoder

__all__ = [
    "DecoderConfig",
    "EncoderConfig",
    "ModelConfig",
    "StyleVAE",
    "TransformerConfig",
    "VAEDecoder",
    "VAEEncoder",
]

from .config import (DecoderConfig, DiscriminatorConfig, EncoderConfig, GANConfig,
                     GeneratorConfig, LSTMConfig, ModelConfig, TransformerConfig)
from .gan import Discriminator, Generator
from .lstm import LSTMCell, LSTMDecoder
from .vae import StyleVAE, VAEDecoder, VAEEncoder

__all__ = [
    "DecoderConfig",
    "Discriminator",
    "DiscriminatorConfig",
    "EncoderConfig",
    "GANConfig",
    "Generator",
    "GeneratorConfig",
    "LSTMCell",
    "LSTMConfig",
    "LSTMDecoder",
    "ModelConfig",
    "StyleVAE",
    "TransformerConfig",
    "VAEDecoder",
    "VAEEncoder",
]

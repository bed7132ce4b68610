from .config import (Config, DecoderConfig, DiscriminatorConfig, EncoderConfig, GANConfig,
                     GeneratorConfig, LSTMConfig, ModelConfig, TransformerConfig,
                     register_config)
from .gan import (Discriminator, Generator, generate_tokens, init_gan_params,
                  make_discriminator, make_generator)
from .lstm import LSTMCell, LSTMDecoder
from .vae import StyleVAE, VAEDecoder, VAEEncoder, init_params, make_model

__all__ = [
    "Config",
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
    "generate_tokens",
    "init_gan_params",
    "init_params",
    "make_discriminator",
    "make_generator",
    "make_model",
    "register_config",
]

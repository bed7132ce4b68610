"""Class-conditional sequence VAE (counterpart of ``musicstyletransfer_tpu/models/vae.py``).

``StyleVAE.forward`` in training mode samples the reparameterised
z = mu + eps * exp(logvar / 2) (``vae.py:238-245``) and applies dropout; in
eval mode it uses z = mu, as ``encode`` and generation do. Token lookups are plain gathers; the JAX package's one-hot embedding matmul
(``vae.py:37-49``) is a TPU workaround and is not carried over.
``decoder_type="lstm"`` builds the legacy ``LSTMDecoder`` (``models/lstm.py``)
in place of the transformer decoder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..midi.vocab import PAD_ID
from ..parallel.mesh import current_mesh

from .config import DecoderConfig, EncoderConfig, ModelConfig
from .lstm import LSTMCell, LSTMDecoder
from .transformer import Cache, Dense, TransformerStack, compute_dtype

# flax's lecun_normal: a normal truncated at two standard deviations, its
# stddev divided by that truncation's own stddev so the variance is 1/fan_in.
_TRUNCATED_STD = 0.87962566103423978


class VAEEncoder(nn.Module):
    """Token + class embeddings -> transformer -> position-0 state -> (mu, logvar)."""

    def __init__(self, config: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        d = c.transformer_config.model_size
        self.compute_dtype = dtype
        self.token_emb = nn.Embedding(c.input_dim, d)
        self.class_emb = nn.Embedding(c.num_classes, d)
        self.encoder = TransformerStack(c.transformer_config, causal=False, dtype=dtype)
        self.latent_proj = Dense(d, 2 * c.latent_dim, torch.float32)

    def forward(self, tokens: torch.Tensor, classes: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.compute_dtype
        key_mask = tokens != PAD_ID
        x = self.token_emb(tokens).to(dt) + self.class_emb(classes).to(dt)[:, None, :]
        h0 = self.encoder(x, key_mask, generator)[:, 0, :]  # position-0 readout
        mu, logvar = self.latent_proj(h0.float()).chunk(2, dim=-1)
        # The JAX package clamps logvar to +-8 (vae.py:82-90).
        return mu, logvar.clamp(-8.0, 8.0)


class VAEDecoder(nn.Module):
    """Causal transformer decoder with a prepended conditioning state -> logits."""

    def __init__(self, config: DecoderConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        d = c.transformer_config.model_size
        self.config = config
        self.compute_dtype = dtype
        self.latent2hid = Dense(c.latent_dim, d, dtype)
        self.class_emb = nn.Embedding(c.num_classes, d)
        self.token_emb = nn.Embedding(c.output_dim, d)
        self.decoder = TransformerStack(c.transformer_config, causal=True, dtype=dtype)
        self.output_layer = Dense(d, c.output_dim, torch.float32)

    @property
    def per_step_conditioning(self) -> bool:
        return self.config.class_conditioning == "per_step"

    def initial_state(self, z: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
        """[B, D] conditioning state latent2hid(z) + class_emb(class)."""
        dt = self.compute_dtype
        return self.latent2hid(z) + self.class_emb(classes).to(dt)

    def step_bias(self, classes: Optional[torch.Tensor]) -> torch.Tensor:
        """[B, D] class row added to every token embedding under ``per_step``."""
        if classes is None:
            raise ValueError("class_conditioning='per_step' decoders need the "
                             "classes at every decode step")
        return self.class_emb(classes).to(self.compute_dtype)

    def embed(self, tokens: torch.Tensor,
              classes: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.token_emb(tokens).to(self.compute_dtype)
        if self.per_step_conditioning:
            bias = self.step_bias(classes)
            x = x + (bias[:, None, :] if x.dim() == 3 else bias)
        return x

    def forward(self, tokens: torch.Tensor, seq_lens: torch.Tensor,
                z: torch.Tensor, classes: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced: SOS-prefixed tokens [B, L+1] -> logits [B, L+1, V]."""
        init = self.initial_state(z, classes)[:, None, :]
        x = torch.cat([init, self.embed(tokens, classes)], dim=1)  # [B, L+2, D]
        positions = torch.arange(x.shape[1], device=x.device)
        key_mask = positions[None, :] < (seq_lens[:, None] + 1)
        h = self.decoder(x, key_mask, generator)[:, 1:, :]  # drop the conditioning position
        return self.output_layer(h.float())

    def step_embedded(self, x_t: torch.Tensor, cache: Cache, t: int) -> torch.Tensor:
        return self.output_layer(self.decoder.step(x_t, cache, t).float())

    def step_token(self, token_t: torch.Tensor, cache: Cache, t: int,
                   classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, V] at position t from token ids [B]; updates ``cache``."""
        return self.step_embedded(self.embed(token_t, classes), cache, t)

    def step_ragged(self, token_t: torch.Tensor, cache: Cache, t: torch.Tensor,
                    classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [S, V] with a position per row, t [S] (``vae.py:176-189``
        of the JAX package: the streaming engine's slots); updates ``cache``."""
        h = self.decoder.step_ragged(self.embed(token_t, classes), cache, t)
        return self.output_layer(h.float())

    def prefill(self, z: torch.Tensor, classes: torch.Tensor, max_len: int) -> Cache:
        """A fresh cache with position 0 (the conditioning state) processed."""
        cache = self.decoder.init_cache(z.shape[0], max_len)
        self.decoder.step(self.initial_state(z, classes), cache, 0)
        return cache


class StyleVAE(nn.Module):
    """Encoder + decoder; parameter names mirror the flax tree (``convert.py``)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        dc = config.decoder_config
        if dc.decoder_type not in ("transformer", "lstm"):
            raise ValueError(f"unknown decoder_type {dc.decoder_type!r}")
        if dc.decoder_type == "lstm" and dc.class_conditioning != "initial":
            raise ValueError(
                "class_conditioning='per_step' requires the transformer "
                "decoder (the legacy LSTM keeps the reference's "
                "initial-state conditioning)"
            )
        self.config = config
        self.compute_dtype = compute_dtype(config.dtype)
        self.encoder = VAEEncoder(config.encoder_config, self.compute_dtype)
        decoder = LSTMDecoder if dc.decoder_type == "lstm" else VAEDecoder
        self.decoder = decoder(dc, self.compute_dtype)

    @property
    def is_lstm(self) -> bool:
        return isinstance(self.decoder, LSTMDecoder)

    @property
    def device(self) -> torch.device:
        return self.decoder.output_layer.weight.device

    def forward(self, tokens: torch.Tensor, seq_lens: torch.Tensor,
                classes: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(logits, mu, logvar). In training mode z = mu + eps * exp(logvar/2)
        with ``eps`` [B, latent] as given, else drawn from ``generator``,
        which also draws the dropout masks; in eval mode z = mu."""
        mu, logvar = self.encoder(tokens, classes, generator)
        z = mu
        if self.training:
            if eps is None:
                mesh = current_mesh()  # this rank's rows of the global batch's draw
                eps = (torch.randn(mu.shape, generator=generator, device=mu.device)
                       if mesh is None else
                       mesh.draw(torch.randn, mu.shape, generator, mu.device))
            z = mu + eps * torch.exp(0.5 * logvar)
        return self.decoder(tokens, seq_lens, z, classes, generator), mu, logvar

    def encode(self, tokens: torch.Tensor, seq_lens: torch.Tensor,
               classes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        del seq_lens  # lengths are implied by the PAD mask
        return self.encoder(tokens, classes)

    def decode_init(self, z: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
        return self.decoder.initial_state(z, classes)

    def decode_prefill(self, z: torch.Tensor, classes: torch.Tensor,
                       max_len: int) -> Cache:
        return self.decoder.prefill(z, classes, max_len)

    def decode_step(self, token_t: torch.Tensor, cache: Cache, t: int,
                    classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder.step_token(token_t, cache, t, classes)

    def decode_step_ragged(self, token_t: torch.Tensor, cache: Cache, t: torch.Tensor,
                           classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder.step_ragged(token_t, cache, t, classes)


def make_model(config: ModelConfig) -> StyleVAE:
    return StyleVAE(config)


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Seeded initialisation with flax's default initializers (the JAX
    package's ``init_params``; the numbers differ, the distributions do
    not): Dense kernels lecun_normal and biases zero, an LSTM cell's hidden
    kernels orthogonal, embeddings normal(0, 1/sqrt(features)), LayerNorms
    one and zero. Drawn on the CPU, so a seed gives the same weights on
    every device. Serves any module built of these layers (``StyleVAE``,
    the GAN's ``Generator`` and ``Discriminator``)."""
    g = torch.Generator().manual_seed(seed)
    recurrent = {id(getattr(cell, f"h{gate}")) for cell in model.modules()
                 if isinstance(cell, LSTMCell) for gate in "ifgo"}
    for module in model.modules():
        if isinstance(module, nn.Linear):
            w = torch.empty(module.weight.shape)
            if id(module) in recurrent:
                nn.init.orthogonal_(w, generator=g)
            else:
                std = module.in_features ** -0.5 / _TRUNCATED_STD
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
            module.weight.copy_(w)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            w = torch.randn(module.weight.shape, generator=g) * module.embedding_dim ** -0.5
            module.weight.copy_(w)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model

"""The class-conditional sequence GAN (counterpart of
``musicstyletransfer_tpu/models/gan.py``).

- ``Generator``: a class-conditional initial LSTM state (``class2state``),
  and at every step the input ``noise2emb(noise_t) + prev_emb +
  class2emb(c)`` through the LSTM stack, float32 ``out`` logits over h, and
  the next step's ``prev_emb``: in *soft* mode softmax(logits /
  temperature) contracted with the ``token_emb`` table (differentiable end
  to end), in *hard* mode the embedding of the token drawn by Gumbel-max.
- ``Discriminator``: token distributions (one-hot for real data, soft for
  generated) through a bias-free ``token_emb`` product plus a class
  embedding, an LSTM stack from float32 zero carries, and a float32 logit a
  step from ``head``, plus <h_t, class_proj[c]> with ``projection``.

The parameter names are the flax tree's (``convert.py``): the generator's
step modules under ``cell`` (``cell/lstm{i}``, ``cell/noise2emb``,
``cell/out``, ``cell/token_emb``; ``nn.scan`` broadcasts one set), the
discriminator's cells at the top level as ``OptimizedLSTMCell_{i}`` (where
``nn.RNN`` inside ``@nn.compact`` puts them).

Random numbers: ``jax.random.categorical(key, x)`` is ``argmax(gumbel +
x)``. ``Generator.forward`` takes the rollout's Gumbel noise [L, B, V] as an
argument, or draws it from the caller's ``torch.Generator`` step by step;
``generate_tokens`` draws the noise [B, L, noise_dim] first and then the
rollout, as the JAX package splits its key.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .config import DiscriminatorConfig, GANConfig, GeneratorConfig
from .lstm import LSTMCell, run_lstm, zero_carry
from .transformer import Dense, compute_dtype


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise drawn from ``generator``: -log(E), E ~ Exp(1)."""
    e = torch.empty(shape, device=device).exponential_(generator=generator)
    return -torch.log(e)


class _GeneratorCell(nn.Module):
    """The rollout step's modules (flax ``cell``)."""

    def __init__(self, c: GeneratorConfig, dtype: torch.dtype):
        super().__init__()
        self.noise2emb = Dense(c.noise_dim, c.emb_dim, dtype)
        for i in range(c.n_layers):
            self.add_module(f"lstm{i}", LSTMCell(c.emb_dim if i == 0 else c.hidden_dim,
                                                 c.hidden_dim, dtype))
        self.out = Dense(c.hidden_dim, c.output_dim, torch.float32)
        self.token_emb = nn.Embedding(c.output_dim, c.emb_dim)


class Generator(nn.Module):
    """noise [B, L, noise_dim] + classes [B] -> (logits [B, L, V], tokens [B, L])."""

    def __init__(self, config: GeneratorConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.config = config
        self.compute_dtype = dtype
        self.class2state = nn.Embedding(c.num_classes, 2 * c.hidden_dim)
        self.class2emb = nn.Embedding(c.num_classes, c.emb_dim)
        self.cell = _GeneratorCell(c, dtype)

    def forward(self, noise: torch.Tensor, classes: torch.Tensor, hard: bool = False,
                temperature: float = 1.0, gumbel_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, draw_tokens: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The rollout over L = noise.shape[1] steps. Each step's token is
        argmax(logits / temperature + gumbel), the Gumbel from
        ``gumbel_noise[t]`` ([L, B, V]) or else drawn from ``generator``.
        Soft mode with ``draw_tokens=False`` (training: its tokens are never
        used) draws nothing and returns tokens None."""
        c, dt = self.config, self.compute_dtype
        B, L, _ = noise.shape
        cell = self.cell
        cells = [getattr(cell, f"lstm{i}") for i in range(c.n_layers)]
        weights = [lc.weights() for lc in cells]
        h0, c0 = self.class2state(classes).to(dt).chunk(2, dim=-1)
        carries = [(c0, h0) for _ in cells]
        prev = torch.zeros(B, c.emb_dim, dtype=dt, device=noise.device)
        cemb = self.class2emb(classes).to(dt)
        noise_emb = cell.noise2emb(noise)  # [B, L, E], one GEMM for every step
        table = cell.token_emb.weight.to(dt)
        draw = hard or draw_tokens
        logits_all, tokens_all = [], []
        for t in range(L):
            h = noise_emb[:, t] + prev + cemb
            for i, lc in enumerate(cells):
                w_i, w_h, b_h = weights[i]
                carries[i] = lc.step(carries[i], lc.input_products(h, w_i), w_h, b_h)
                h = carries[i][1]
            logits = cell.out(h.float())
            scaled = logits / temperature
            logits_all.append(logits)
            if draw:
                g = (gumbel_noise[t] if gumbel_noise is not None
                     else gumbel(scaled.shape, generator, scaled.device))
                tokens = (scaled + g).argmax(-1)
                tokens_all.append(tokens)
            if hard:
                prev = table[tokens]
            else:
                prev = torch.softmax(scaled, dim=-1).to(dt) @ table
        tokens = torch.stack(tokens_all, dim=1).to(torch.int32) if draw else None
        return torch.stack(logits_all, dim=1), tokens


class Discriminator(nn.Module):
    """Token distributions [B, L, V] + classes [B] -> per-step logits [B, L]."""

    def __init__(self, config: DiscriminatorConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.config = config
        self.compute_dtype = dtype
        self.token_emb = nn.Linear(c.input_dim, c.emb_dim, bias=False)
        self.class_emb = nn.Embedding(c.num_classes, c.emb_dim)
        for i in range(c.n_layers):
            self.add_module(f"OptimizedLSTMCell_{i}",
                            LSTMCell(c.emb_dim if i == 0 else c.hidden_dim, c.hidden_dim, dtype))
        self.head = Dense(c.hidden_dim, 1, torch.float32)
        if c.projection:
            self.class_proj = nn.Embedding(c.num_classes, c.hidden_dim)

    def forward(self, token_dists: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
        c, dt = self.config, self.compute_dtype
        x = token_dists.to(dt) @ self.token_emb.weight.to(dt).t()
        x = x + self.class_emb(classes).to(dt)[:, None, :]
        for i in range(c.n_layers):
            carry = zero_carry(x.shape[0], c.hidden_dim, x.device)
            x, _ = run_lstm(getattr(self, f"OptimizedLSTMCell_{i}"), x, carry)
        h = x.float()
        logits = self.head(h)[..., 0]
        if c.projection:
            proj = self.class_proj(classes)
            logits = logits + torch.einsum("blh,bh->bl", h, proj)
        return logits


def make_generator(config: GANConfig) -> Generator:
    return Generator(config.generator_config, compute_dtype(config.dtype))


def make_discriminator(config: GANConfig) -> Discriminator:
    return Discriminator(config.discriminator_config, compute_dtype(config.dtype))


def init_gan_params(config: GANConfig, seed: int) -> Tuple[Generator, Discriminator]:
    """(generator, discriminator) with flax's initializers (``vae.init_params``),
    the generator drawn from ``seed`` and the discriminator from ``seed + 1``,
    on the CPU."""
    from .vae import init_params

    return (init_params(make_generator(config), seed),
            init_params(make_discriminator(config), seed + 1))


@torch.no_grad()
def generate_tokens(gen: Generator, classes: torch.Tensor, generator: torch.Generator,
                    temperature: float = 1.0) -> torch.Tensor:
    """Hard token rows [B, max_seq_len] int32 for ``classes``: the noise
    [B, L, noise_dim] drawn from ``generator`` first, then the rollout's
    Gumbel noise."""
    c = gen.config
    noise = torch.randn((classes.shape[0], c.max_seq_len, c.noise_dim),
                        generator=generator, device=classes.device)
    _, tokens = gen(noise, classes, hard=True, temperature=temperature, generator=generator)
    return tokens

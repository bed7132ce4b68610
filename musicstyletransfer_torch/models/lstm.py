"""The LSTM cell of the GAN family and of the legacy LSTM decoder
(counterparts of flax's ``nn.OptimizedLSTMCell`` / ``nn.RNN`` and of
``musicstyletransfer_tpu/models/lstm.py``).

``LSTMCell`` is flax's ``OptimizedLSTMCell``: gates i, f, g, o; input
kernels ``ii/if/ig/io`` without bias, hidden kernels ``hi/hf/hg/ho`` with
bias; c' = f * c + i * g, h' = o * tanh(c'); the carry is ordered (c, h).
Its cast points are flax's: input, hidden state, kernels and biases are cast
to the compute dtype, each product rounded to it, the bias added to the
hidden product, then the input product; the gates in the compute dtype, and
c', h' in the dtype the carry promotes to (a float32 carry, as ``nn.RNN``
starts the discriminator with, keeps c' and h' in float32).

The cell is written out step by step in plain PyTorch ops, never through
``nn.LSTM``: cuDNN's RNN has no double backward (the GAN's R1 penalty needs
one), and a plain step loop captures into a CUDA graph. ``run_lstm`` runs a
cell over known inputs: one GEMM for the input products of every step, then
the step loop for the hidden products.

``LSTMDecoder`` is the VAE's legacy decoder: latent and class enter through
the initial state ``latent2hid(z) + class_emb(c)``, split into [h0, c0] and
repeated over the layers; there is no prepended conditioning position, so
the logits align with the labels directly. It presents the transformer
decoder's ``forward`` / ``prefill`` / ``step_token`` surface; its cache is
the list of per-layer (c, h) carries, updated in place by ``step_token``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .config import DecoderConfig, LSTMConfig
from .transformer import Dense, dropout

Carry = Tuple[torch.Tensor, torch.Tensor]  # (c, h)
GATES = "ifgo"


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell(hidden)`` over inputs of ``in_features``."""

    def __init__(self, in_features: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.hidden = hidden
        self.compute_dtype = dtype
        for g in GATES:
            self.add_module(f"i{g}", nn.Linear(in_features, hidden, bias=False))
        for g in GATES:
            self.add_module(f"h{g}", nn.Linear(hidden, hidden))

    def weights(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(input kernel [4H, in], hidden kernel [4H, H], hidden bias [4H]),
        the gates concatenated in the order i, f, g, o, in the compute dtype."""
        dt = self.compute_dtype
        mods = [getattr(self, f"i{g}") for g in GATES], [getattr(self, f"h{g}") for g in GATES]
        w_i = torch.cat([m.weight for m in mods[0]]).to(dt)
        w_h = torch.cat([m.weight for m in mods[1]]).to(dt)
        b_h = torch.cat([m.bias for m in mods[1]]).to(dt)
        return w_i, w_h, b_h

    def input_products(self, x: torch.Tensor, w_i: torch.Tensor) -> torch.Tensor:
        """x W_i^T [..., 4H] in the compute dtype (no bias)."""
        return F.linear(x.to(self.compute_dtype), w_i)

    def step(self, carry: Carry, x_proj: torch.Tensor, w_h: torch.Tensor,
             b_h: torch.Tensor) -> Carry:
        """One step from the input products ``x_proj`` [B, 4H]: the new (c, h)."""
        c, h = carry
        gates = (F.linear(h.to(self.compute_dtype), w_h) + b_h) + x_proj
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        new_c = f * c + i * torch.tanh(gg)
        return new_c, o * torch.tanh(new_c)

    def forward(self, carry: Carry, x: torch.Tensor) -> Carry:
        """One step on the input ``x`` [B, in] (flax ``cell(carry, x)``; the
        output is the new h)."""
        w_i, w_h, b_h = self.weights()
        return self.step(carry, self.input_products(x, w_i), w_h, b_h)


def run_lstm(cell: LSTMCell, x: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
    """flax ``nn.RNN(cell)`` over x [B, T, in] from ``carry``: (outputs
    [B, T, H], the last carry)."""
    w_i, w_h, b_h = cell.weights()
    x_proj = cell.input_products(x, w_i)  # one GEMM for every step
    outs = []
    for t in range(x.shape[1]):
        carry = cell.step(carry, x_proj[:, t], w_h, b_h)
        outs.append(carry[1])
    return torch.stack(outs, dim=1), carry


def zero_carry(batch: int, hidden: int, device) -> Carry:
    """``nn.RNN``'s initial carry: float32 zeros (the cell's param dtype)."""
    z = torch.zeros(batch, hidden, device=device)
    return z, z


class _RNN(nn.Module):
    """Holds a cell under the name ``cell`` (flax ``nn.RNN``'s layout)."""

    def __init__(self, cell: LSTMCell):
        super().__init__()
        self.cell = cell


class LSTMDecoder(nn.Module):
    """The legacy LSTM decoder of ``StyleVAE`` (``decoder_type="lstm"``)."""

    def __init__(self, config: DecoderConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        lc = c.lstm_config or LSTMConfig()
        H = lc.hidden_dim
        self.config = config
        self.lstm_config = lc
        self.compute_dtype = dtype
        self.latent2hid = Dense(c.latent_dim, 2 * H, dtype)
        self.class_emb = nn.Embedding(c.num_classes, 2 * H)
        self.token_emb = nn.Embedding(c.output_dim, H)
        for i in range(lc.n_layers):
            self.add_module(f"rnn{i}", _RNN(LSTMCell(H, H, dtype)))
        self.output_layer = Dense(H, c.output_dim, torch.float32)

    @property
    def cells(self) -> List[LSTMCell]:
        return [getattr(self, f"rnn{i}").cell for i in range(self.lstm_config.n_layers)]

    def initial_carries(self, z: torch.Tensor, classes: torch.Tensor) -> List[Carry]:
        """Per-layer (c0, h0): ``latent2hid(z) + class_emb(c)`` split into
        [h0, c0], the same pair for every layer."""
        transform = self.latent2hid(z) + self.class_emb(classes).to(self.compute_dtype)
        h0, c0 = transform.chunk(2, dim=-1)
        return [(c0, h0) for _ in range(self.lstm_config.n_layers)]

    def forward(self, tokens: torch.Tensor, seq_lens: torch.Tensor,
                z: torch.Tensor, classes: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced: SOS-prefixed tokens [B, L+1] -> logits [B, L+1, V].
        ``seq_lens`` is unused: padded positions run and the loss masks them.
        Dropout between layers (training mode) draws from ``generator``."""
        del seq_lens
        x = self.token_emb(tokens).to(self.compute_dtype)
        carries = self.initial_carries(z, classes)
        cells = self.cells
        for i, cell in enumerate(cells):
            x, _ = run_lstm(cell, x, carries[i])
            if i + 1 < len(cells):
                x = dropout(x, self.lstm_config.dropout, self.training, generator)
        return self.output_layer(x.float())

    def prefill(self, z: torch.Tensor, classes: torch.Tensor, max_len: int) -> List[Carry]:
        """The decode cache: the initial carries (an LSTM needs no positions)."""
        del max_len
        return self.initial_carries(z, classes)

    def step_token(self, token_t: torch.Tensor, cache: List[Carry], t,
                   classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, V] from token ids [B]; replaces ``cache``'s carries with
        the new ones. ``t`` and ``classes`` are unused (the recurrent state
        carries both)."""
        del t, classes
        x = self.token_emb(token_t).to(self.compute_dtype)
        for i, cell in enumerate(self.cells):
            cache[i] = cell(cache[i], x)
            x = cache[i][1]
        return self.output_layer(x.float())

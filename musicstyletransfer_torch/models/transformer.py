"""Transformer encoder/decoder stacks (counterpart of ``musicstyletransfer_tpu/models/transformer.py``).

Numerics follow flax at the model's compute dtype (``ModelConfig.dtype``),
with parameters kept in float32 and cast at use:

- ``Dense``: the product in the compute dtype (float32 accumulation),
  rounded, then the bias added in the compute dtype (flax ``nn.Dense``);
- ``LayerNorm``: float32 statistics, eps 1e-6 (flax), output cast back;
- attention scores in the compute dtype, softmax over keys, masked
  positions at -1e9 (``transformer.py:39, 310-323``).

The batched attention has the JAX package's dispatch on one device
(``transformer.py:191-241, 243-323``): with ``use_flash_attention`` and
``attention_core_min_seq_len`` <= T < min(``flash_min_seq_len``, 1024), and
without ``ring_attention``, it runs the attention core
(``ops/attention_core.py``: K2 forward, K3 backward) on the interleaved QKV
projection; at or above ``flash_min_seq_len`` with ``use_flash_attention``
the flash route (``ops/flash_attention.py``: K4 forward, K5 backward);
otherwise dense attention (the canonical T=65 lands there).

Under a mesh (``parallel/mesh.py``, read through ``current_mesh``):

- tensor parallelism: a layer whose weights ``parallel.mesh.shard_model``
  sliced holds H/tp heads and FF/tp hidden columns; ``copy_to_model`` sits in
  front of w_q|w_k|w_v and ff1, and w_o and ff2 all-reduce their partial
  products before their bias (``Dense``), one all-reduce per block each way.
  K2/K3 and K4/K5 run on the local heads (the JAX ``attention_core_tp``);
  the core also needs the heads to divide by tp (``_core_eligible``);
- ring attention (``ring_attention`` on a model axis > 1): each rank runs
  the stack on its chunk of the time axis (padded to the ring), with the
  positions of the whole sequence, attention through
  ``ops/ring_attention.py`` (K4/K5 on each visiting chunk), and the chunks
  gathered at the stack's end, before the latent head's readout and the
  output logits (where the JAX package's GSPMD would gather).

Dropout sits where flax has it (after the FFN's ReLU, and on both residual
branches) and applies only in training mode, drawing its masks from the
``torch.Generator`` passed down from ``StyleVAE.forward``. ``remat`` in
training mode recomputes each layer in the backward
(``torch.utils.checkpoint``) with the dropout masks its forward drew, so
the masks, the loss, the gradients and the generator's final state are
those of a run without it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention_core import MAX_CORE_SEQ_LEN, attention_core, interleave_qkv_weights
from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import ring_attention
from ..parallel.collectives import copy_to_model, gather_seq, reduce_from_model, scatter_seq
from ..parallel.mesh import SeqShard, current_mesh
from .config import TransformerConfig

NEG_INF = -1e9

# Per-layer KV cache: (k, v), each [batch, max_len, num_heads, head_dim].
LayerCache = Tuple[torch.Tensor, torch.Tensor]
Cache = List[LayerCache]


def positional_encodings(model_size: int, max_len: int) -> np.ndarray:
    """Sinusoidal table with the reference's exponent layout: column i uses
    10000^(2i/d), sine on even columns and cosine on odd ones (not the usual
    i//2 pairing) — ``transformer.py:42-50``."""
    pos = np.arange(max_len).reshape(-1, 1) / np.power(
        10000, (2.0 / model_size) * np.arange(model_size).reshape(1, -1)
    )
    pos[:, 0::2] = np.sin(pos[:, 0::2])
    pos[:, 1::2] = np.cos(pos[:, 1::2])
    return pos.astype(np.float32)


def sqrt_in(value: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(value) computed in ``dtype``, as ``jnp.sqrt(jnp.asarray(value, dtype))``."""
    return torch.sqrt(torch.tensor(float(value), dtype=dtype))


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense(dtype=...)`` numerics. A weight
    whose input dim was sharded (row-parallel: w_o, ff2 under tensor
    parallelism) gives partial products, all-reduced over the mesh's model
    group before the bias is added once."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        if self.weight.shape[1] != self.in_features:
            y = reduce_from_model(y, current_mesh())
        return y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """float32 LayerNorm with flax's eps, output in the compute dtype."""

    def __init__(self, size: int, dtype: torch.dtype = torch.float32):
        super().__init__(size, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class DrawnMasks:
    """Dropout keep masks drawn ahead, handed to the ``dropout`` calls of a
    layer in the order the layer makes them (``_remat_layer``)."""

    def __init__(self, masks: List[torch.Tensor]):
        self.masks = masks
        self.used = 0

    def next(self) -> torch.Tensor:
        self.used += 1
        return self.masks[self.used - 1]


def keep_mask(shape, rate: float, generator, device, seq: Optional[SeqShard] = None,
              cols: bool = False) -> torch.Tensor:
    """A dropout keep mask of ``shape`` from ``generator``. Under a mesh it
    is this rank's block of the mask drawn at the global shape (its rows,
    its time chunk under ``seq``, its columns with ``cols``), so a sharded
    run keeps the masks of one process on the whole batch."""
    mesh = current_mesh()
    if mesh is None:
        return torch.rand(shape, generator=generator, device=device) >= rate
    return mesh.draw(torch.rand, shape, generator, device, seq, cols) >= rate


def dropout(x: torch.Tensor, rate: float, training: bool, generator,
            seq: Optional[SeqShard] = None, cols: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate), in x's dtype; the identity outside training or at rate
    0. The mask comes from ``generator`` (a ``torch.Generator`` on x's
    device, or ``DrawnMasks``), through ``keep_mask``."""
    if not training or rate <= 0.0:
        return x
    if isinstance(generator, DrawnMasks):
        keep = generator.next()
    else:
        keep = keep_mask(x.shape, rate, generator, x.device, seq, cols)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class FeedForward(nn.Module):
    """4x-expansion ReLU FFN, dropout after the ReLU."""

    def __init__(self, model_size: int, hidden_size: int, dtype: torch.dtype,
                 rate: float = 0.0):
        super().__init__()
        self.ff1 = Dense(model_size, hidden_size, dtype)
        self.ff2 = Dense(hidden_size, model_size, dtype)
        self.rate = rate

    @property
    def sharded(self) -> bool:
        """Whether this rank holds a slice of the hidden columns (TP)."""
        return self.ff1.weight.shape[0] != self.ff1.out_features

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                seq: Optional[SeqShard] = None) -> torch.Tensor:
        if self.sharded:
            x = copy_to_model(x, current_mesh())
        h = dropout(F.relu(self.ff1(x)), self.rate, self.training, generator, seq,
                    cols=self.sharded)
        return self.ff2(h)


class MultiHeadSelfAttention(nn.Module):
    """Scaled-dot self-attention: the batched path (attention core, flash
    or dense) and a cached step."""

    def __init__(self, model_size: int, num_heads: int, causal: bool,
                 dtype: torch.dtype, config: Optional[TransformerConfig] = None):
        super().__init__()
        if model_size % num_heads:
            raise ValueError(f"model_size {model_size} is not a multiple of "
                             f"num_heads {num_heads}")
        c = config or TransformerConfig()
        self.num_heads = num_heads
        self.head_dim = model_size // num_heads
        self.causal = causal
        self.compute_dtype = dtype
        self.use_flash = c.use_flash_attention
        self.flash_min_seq_len = c.flash_min_seq_len
        self.core_min_seq_len = c.attention_core_min_seq_len
        self.core_xla_backward = c.attention_core_xla_backward
        self.use_ring = c.ring_attention
        self.w_q = Dense(model_size, model_size, dtype)
        self.w_k = Dense(model_size, model_size, dtype)
        self.w_v = Dense(model_size, model_size, dtype)
        self.w_o = Dense(model_size, model_size, dtype)
        self.register_buffer("scale", sqrt_in(self.head_dim, dtype),
                             persistent=False)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], -1, self.head_dim)

    @property
    def local_heads(self) -> int:
        """The heads this rank holds: all of them, or H/tp under TP."""
        return self.w_q.weight.shape[0] // self.head_dim

    def _core_eligible(self, T: int, mesh=None) -> bool:
        """The JAX package's ``_core_eligible``: the window
        [core_min_seq_len, min(flash_min_seq_len, 1024)), never under
        ``ring_attention``, and on a model axis tp > 1 only where tp divides
        the heads (each rank's kernel takes whole heads). Its batch clause
        holds by construction: each rank holds its own rows."""
        lo = self.core_min_seq_len
        mesh = mesh if mesh is not None else current_mesh()
        return (self.use_flash and not self.use_ring and 0 < lo <= T
                and T < self.flash_min_seq_len and T <= MAX_CORE_SEQ_LEN
                and (mesh is None or mesh.tp <= 1 or self.num_heads % mesh.tp == 0))

    def _ring_eligible(self, mesh) -> bool:
        """``ring_attention`` on a model axis > 1 (``_ring_eligible``); the
        stack then hands this layer its time chunk."""
        return self.use_ring and mesh is not None and mesh.tp > 1

    def _qkv_interleaved(self, x: torch.Tensor) -> torch.Tensor:
        """The QKV projection in the core's layout (column group h is
        [q_h | k_h | v_h]), permuted on the weight side: one
        [B, T, D] x [D, 3D] product, flax Dense rounding."""
        dt = self.compute_dtype
        w, b = interleave_qkv_weights(
            self.w_q.weight.t(), self.w_q.bias, self.w_k.weight.t(), self.w_k.bias,
            self.w_v.weight.t(), self.w_v.bias, self.local_heads, self.head_dim)
        return F.linear(x.to(dt), w.t().to(dt)) + b.to(dt)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """x: [B, T, D]; key_mask: [B, T] True at valid (non-PAD) keys, a
        prefix of each row. Under ring attention x is this rank's time chunk
        [B, T/n, D] and key_mask the whole (padded) sequence's."""
        B, T, D = x.shape
        dt = self.compute_dtype
        mesh = current_mesh()
        if self.local_heads != self.num_heads:
            x = copy_to_model(x, mesh)
        if self._core_eligible(T, mesh):
            key_lens = key_mask.sum(-1, dtype=torch.int32)
            ctx = attention_core(self._qkv_interleaved(x), key_lens, self.local_heads,
                                 self.causal, xla_backward=self.core_xla_backward)
            return self.w_o(ctx)
        q, k, v = (self._heads(w(x)) for w in (self.w_q, self.w_k, self.w_v))
        if self._ring_eligible(mesh):
            key_lens = key_mask.sum(-1, dtype=torch.int32)
            out = ring_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 key_lens, self.causal, mesh=mesh).transpose(1, 2)
        elif self.use_flash and T >= self.flash_min_seq_len:
            # [B, H, T, hd] views, no copies. The flash kernels scale q by
            # sm_scale = 1/sqrt(hd) rounded to the compute dtype; the dense
            # route below divides by sqrt(hd) in it, which rounds otherwise
            # at hd=32.
            key_lens = key_mask.sum(-1, dtype=torch.int32)
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  key_lens, self.causal).transpose(1, 2)
        else:
            bias = torch.where(key_mask[:, None, None, :].bool(), 0.0, NEG_INF)
            if self.causal:
                tri = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
                bias = bias + torch.where(tri, 0.0, NEG_INF)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / self.scale
            probs = torch.softmax(logits + bias.to(dt), dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.w_o(out.reshape(B, T, -1))

    def step(self, x_t: torch.Tensor, cache_k: torch.Tensor,
             cache_v: torch.Tensor, t: int) -> torch.Tensor:
        """One cached decode position. x_t: [B, D]; cache_{k,v}:
        [B, T_max, H, hd] (H the ``local_heads``: H/tp under tensor
        parallelism), written at ``t`` in place (the JAX package returns new
        arrays; updating in place saves a cache copy a step)."""
        B = x_t.shape[0]
        if self.local_heads != self.num_heads:
            x_t = copy_to_model(x_t, current_mesh())
        q = self._heads(self.w_q(x_t))  # [B, H, hd]
        cache_k[:, t] = self._heads(self.w_k(x_t)).to(cache_k.dtype)
        cache_v[:, t] = self._heads(self.w_v(x_t)).to(cache_v.dtype)
        logits = torch.einsum("bhd,bkhd->bhk", q, cache_k) / self.scale
        # Mask the cache slots not yet written (positions beyond t).
        logits[:, :, t + 1:] = NEG_INF
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhk,bkhd->bhd", probs, cache_v)
        return self.w_o(out.reshape(B, -1))

    def step_ragged(self, x_t: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``step`` with a position per row (``transformer.py:325-359`` of
        the JAX package): row s sits at ``t[s]`` ([S] int64 on the cache's
        device). (k, v) are scattered into ``[s, t[s]]`` in place and row s
        attends over keys <= t[s]. Nothing here reads a value back to the
        host, so a CUDA graph can capture it. Equal to ``step`` when every
        row shares t: the same products over the whole cache, the same
        masked positions."""
        S, T = x_t.shape[0], cache_k.shape[1]
        if self.local_heads != self.num_heads:
            x_t = copy_to_model(x_t, current_mesh())
        q = self._heads(self.w_q(x_t))  # [S, H, hd]
        at = t.view(S, 1, 1, 1).expand(S, 1, self.local_heads, self.head_dim)
        cache_k.scatter_(1, at, self._heads(self.w_k(x_t)).to(cache_k.dtype)[:, None])
        cache_v.scatter_(1, at, self._heads(self.w_v(x_t)).to(cache_v.dtype)[:, None])
        logits = torch.einsum("bhd,bkhd->bhk", q, cache_k) / self.scale
        valid = torch.arange(T, device=t.device)[None, :] <= t[:, None]  # [S, T]
        logits = logits.masked_fill(~valid[:, None, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhk,bkhd->bhd", probs, cache_v)
        return self.w_o(out.reshape(S, -1))


class TransformerLayer(nn.Module):
    """Post-LN (the reference's) or pre-LN residual block: attention + FFN."""

    def __init__(self, config: TransformerConfig, causal: bool, dtype: torch.dtype):
        super().__init__()
        c = config
        self.pre_ln = c.norm_scheme == "pre"
        self.rate = c.dropout
        self.attention = MultiHeadSelfAttention(c.model_size, c.num_heads,
                                                causal, dtype, c)
        self.ln1 = LayerNorm(c.model_size, dtype)
        self.ff = FeedForward(c.model_size, c.model_size * c.ffn_multiplier, dtype,
                              c.dropout)
        self.ln2 = LayerNorm(c.model_size, dtype)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                seq: Optional[SeqShard] = None) -> torch.Tensor:
        def drop(y):
            return dropout(y, self.rate, self.training, generator, seq)

        if self.pre_ln:
            x = x + drop(self.attention(self.ln1(x), key_mask))
            return x + drop(self.ff(self.ln2(x), generator, seq))
        x = self.ln1(x + drop(self.attention(x, key_mask)))
        return self.ln2(x + drop(self.ff(x, generator, seq)))

    def step(self, x_t: torch.Tensor, cache: LayerCache, t: int) -> torch.Tensor:
        if self.pre_ln:
            x_t = x_t + self.attention.step(self.ln1(x_t), cache[0], cache[1], t)
            return x_t + self.ff(self.ln2(x_t))
        x_t = self.ln1(x_t + self.attention.step(x_t, cache[0], cache[1], t))
        return self.ln2(x_t + self.ff(x_t))

    def step_ragged(self, x_t: torch.Tensor, cache: LayerCache,
                    t: torch.Tensor) -> torch.Tensor:
        if self.pre_ln:
            x_t = x_t + self.attention.step_ragged(self.ln1(x_t), cache[0], cache[1], t)
            return x_t + self.ff(self.ln2(x_t))
        x_t = self.ln1(x_t + self.attention.step_ragged(x_t, cache[0], cache[1], t))
        return self.ln2(x_t + self.ff(x_t))


class TransformerStack(nn.Module):
    """sqrt(d)*x + positional table, N layers, and a final LayerNorm under
    pre-LN (``transformer.py:476-552``)."""

    def __init__(self, config: TransformerConfig, causal: bool, dtype: torch.dtype):
        super().__init__()
        self.config = config
        self.compute_dtype = dtype
        self.layers = nn.ModuleList(
            TransformerLayer(config, causal, dtype) for _ in range(config.num_layers)
        )
        if config.norm_scheme == "pre":
            self.final_ln = LayerNorm(config.model_size, dtype)
        self.register_buffer(
            "pos_table",
            torch.from_numpy(positional_encodings(config.model_size,
                                                  config.max_positions)).to(dtype),
            persistent=False,
        )
        self.register_buffer("scale", sqrt_in(config.model_size, dtype),
                             persistent=False)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, D] (before scaling); key_mask: [B, T] True at valid keys;
        ``generator`` draws the dropout masks in training mode. Under ring
        attention on a model axis > 1 the layers run on this rank's time
        chunk and the output is gathered whole."""
        x = self.scale * x + self.pos_table[: x.shape[1]]
        mesh = current_mesh()
        seq = None
        if self.config.ring_attention and mesh is not None and mesh.tp > 1:
            seq = SeqShard(x.shape[1], mesh.tp, mesh.model_rank)
            x = scatter_seq(x, seq, mesh)
            key_mask = seq.pad(key_mask)
        remat = self.config.remat and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            x = (_remat_layer(layer, x, key_mask, generator, seq) if remat
                 else layer(x, key_mask, generator, seq))
        if self.config.norm_scheme == "pre":
            x = self.final_ln(x)
        if seq is not None:
            x = gather_seq(x, seq, mesh)
        return x

    def step(self, x_t: torch.Tensor, cache: Cache, t: int) -> torch.Tensor:
        """One incremental decode position. x_t: [B, D] (before scaling)."""
        x_t = self.scale * x_t + self.pos_table[t]
        for layer, layer_cache in zip(self.layers, cache):
            x_t = layer.step(x_t, layer_cache, t)
        if self.config.norm_scheme == "pre":
            x_t = self.final_ln(x_t)
        return x_t

    def step_ragged(self, x_t: torch.Tensor, cache: Cache, t: torch.Tensor) -> torch.Tensor:
        """``step`` at a position per row: x_t [S, D] (before scaling), t [S]."""
        x_t = self.scale * x_t + self.pos_table.index_select(0, t)
        for layer, layer_cache in zip(self.layers, cache):
            x_t = layer.step_ragged(x_t, layer_cache, t)
        if self.config.norm_scheme == "pre":
            x_t = self.final_ln(x_t)
        return x_t

    def init_cache(self, batch_size: int, max_len: int) -> Cache:
        """Zero (k, v) per layer, [batch, max_len, heads, head_dim], at the
        heads each layer holds (H/tp under tensor parallelism)."""
        dev = self.pos_table.device
        cache = []
        for layer in self.layers:
            att = layer.attention
            shape = (batch_size, max_len, att.local_heads, att.head_dim)
            cache.append((torch.zeros(shape, dtype=self.compute_dtype, device=dev),
                          torch.zeros(shape, dtype=self.compute_dtype, device=dev)))
        return cache


def _remat_layer(layer: TransformerLayer, x: torch.Tensor, key_mask: torch.Tensor,
                 generator: Optional[torch.Generator],
                 seq: Optional[SeqShard] = None) -> torch.Tensor:
    """``layer`` under ``torch.utils.checkpoint`` (non-reentrant). The
    layer's dropout masks are drawn from ``generator`` before it runs, in the
    order and shapes the layer draws them (the attention branch [B, T, D],
    the FFN's hidden [B, T, FF], the FFN branch [B, T, D]), so they and the
    generator's state equal a run without remat; the forward and the
    recompute read the same kept masks, and no generator state is saved or
    set, which a CUDA graph's capture does not allow."""
    masks = []
    if layer.training and layer.rate > 0.0:
        B, T, D = x.shape
        ff = layer.ff.ff1.weight.shape[0]
        masks = [keep_mask(shape, layer.rate, generator, x.device, seq, cols)
                 for shape, cols in (((B, T, D), False), ((B, T, ff), layer.ff.sharded),
                                     ((B, T, D), False))]

    def run(x_, mask_):
        return layer(x_, mask_, DrawnMasks(masks), seq)

    return checkpoint(run, x, key_mask, use_reentrant=False, preserve_rng_state=False)


def compute_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


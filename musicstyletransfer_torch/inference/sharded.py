"""Mesh-sharded batched inference: style transfer over a (data, model) mesh
(counterpart of ``musicstyletransfer_tpu/inference/sharded.py``).

The JAX package is one controller driving every chip; the port's mesh is
one process per card (``parallel/mesh.py``, rank = d * tp + m). Each function
here is called by every rank with the same global inputs and returns the
whole result on every rank:

- the batch is padded to a multiple of the data axis with copies of row 0
  and data rank d takes rows [d * B/dp, (d + 1) * B/dp) of it (rows are
  independent, so data-parallel decode needs no collective in the loop);
- each rank encodes its rows and decodes them: on a pure data-parallel
  mesh (tp = 1) on the card, as one launch of K1 (``ops/fused_decode.py``)
  over its rows; otherwise through ``decode_stepwise`` (K1's plain loop)
  under ``use_mesh``, on the model the tensor-parallel rules split
  (``prepare_params``), whose row-parallel products all-reduce over the
  model group;
- the rows come back by one all-gather of the sequences and one of the
  scores over the data group (NCCL's ``all_gather_into_tensor`` on the card,
  gloo's ``all_gather`` of CPU tensors), and the padding rows are dropped.

Sampling: the JAX package draws one seed per shard from its key
(``sharded.py:141-143``); here every rank draws dp 64-bit Philox keys from
the caller's ``torch.Generator`` the same way and shard d decodes with key
d, so the shards' noise streams differ and shard d's rows equal
``sample_sequences`` on those rows with key d.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.vae import StyleVAE
from ..ops.fused_decode import fused_decode, plan_for
from ..parallel.mesh import Mesh, shard_model, use_mesh
from .decode import _encode_deterministic, decode_stepwise

_logger = logging.getLogger(__name__)

_KEY_MASK = (1 << 64) - 1


def prepare_params(model: StyleVAE, mesh: Mesh) -> StyleVAE:
    """Place ``model`` (whole, the same on every rank) on ``mesh`` once:
    under tp > 1 ``shard_model`` slices it in place by the tensor-parallel
    rules; under pure data parallelism it stays whole. A second call is a
    no-op. Returns the model."""
    if mesh.tp > 1 and getattr(model, "sharded_on", None) is None:
        shard_model(model, mesh)
        model.sharded_on = (mesh.tp, mesh.model_rank)
    return model


def _pad_rows(x: torch.Tensor, target: int) -> torch.Tensor:
    """The leading axis padded to ``target`` rows with copies of row 0."""
    extra = target - x.shape[0]
    if extra == 0:
        return x
    return torch.cat([x, x[:1].expand(extra, *x.shape[1:])])


def _fused_shard_eligible(model: StyleVAE, mesh: Mesh, per_shard_batch: int, max_len: int,
                          top_k: int, top_p: float) -> bool:
    """Whether each shard decodes through K1 (``sharded.py:65-80`` of the JAX
    package): a pure data-parallel mesh (the kernel holds whole weights), on
    the card, a transformer decoder, and shapes that ``ops.fused_decode.plan``
    takes at the shard's rows (the filtered token choice is in the kernel,
    so ``top_k``/``top_p`` do not decide)."""
    del top_k, top_p
    if mesh.tp != 1 or model.device.type != "cuda" or not model.k1_decodes:
        return False
    if not 1 <= max_len <= model.decoder.config.transformer_config.max_positions:
        return False
    try:
        plan_for(model, per_shard_batch, max_len)
    except ValueError:
        return False
    return True


def draw_keys(generator: torch.Generator, n: int) -> List[int]:
    """``n`` 64-bit Philox keys from ``generator`` (the same on every rank
    that holds the same generator state)."""
    keys = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), dtype=torch.int64,
                         generator=generator, device=generator.device)
    return [k & _KEY_MASK for k in keys.tolist()]


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's ``x`` [rows, ...] concatenated in data-rank order,
    gathered as the rows' bytes (neither NCCL nor gloo takes 16-bit
    integers): ``all_gather_into_tensor`` on NCCL, ``all_gather`` on gloo.
    Issued at dp = 1 too."""
    raw = x.contiguous().reshape(x.shape[0], -1).view(torch.uint8)
    if dist.get_backend(mesh.data_group) == "nccl":
        out = torch.empty((mesh.dp * raw.shape[0], raw.shape[1]), dtype=torch.uint8,
                          device=raw.device)
        dist.all_gather_into_tensor(out, raw, group=mesh.data_group)
    else:
        parts = [torch.empty_like(raw) for _ in range(mesh.dp)]
        dist.all_gather(parts, raw, group=mesh.data_group)
        out = torch.cat(parts)
    return out.view(x.dtype).reshape(-1, *x.shape[1:])


@torch.inference_mode()
def sharded_sample_sequences(
    model: StyleVAE,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    classes: torch.Tensor,
    max_len: int,
    generator: torch.Generator,
    mesh: Mesh,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    greedy: bool = False,
    params_on_mesh: bool = False,
    use_fused: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode + decode with the batch sharded over the data axis: the
    contract of ``decode.sample_sequences``, called by every rank with the
    same global inputs, the whole result returned on every rank.

    ``use_fused``: None picks K1 per shard where ``_fused_shard_eligible``
    allows it and logs the other route; True forces K1 and raises
    ``ValueError`` where it cannot run (a model axis > 1, an LSTM decoder);
    False takes the step loop. ``params_on_mesh``: the model already went
    through ``prepare_params``."""
    B = tokens.shape[0]
    dp = mesh.dp
    rows = -(-B // dp)
    if not params_on_mesh:
        prepare_params(model, mesh)
    if use_fused is None:
        use_fused = _fused_shard_eligible(model, mesh, rows, max_len, top_k, top_p)
        if not use_fused:
            _logger.info("sharded decode: the step loop on %d rows a shard (mesh %s, %s)",
                         rows, mesh.shape, model.device)
    elif use_fused:
        if mesh.tp != 1:
            raise ValueError("use_fused=True requires a pure data-parallel mesh (tp=1); "
                             "the kernel holds full-width weights per card")
        if not model.k1_decodes:
            raise ValueError("use_fused=True: K1 does not take this decoder (the LSTM, or a "
                             "block off the reference's)")
    keys = draw_keys(generator, dp)
    lo = mesh.data_rank * rows
    tokens, seq_lens, classes = (_pad_rows(x, rows * dp)[lo:lo + rows]
                                 for x in (tokens, seq_lens, classes))
    mode = "greedy" if greedy else "sample"
    top_k, top_p = (0, 0.0) if greedy else (top_k, top_p)
    with use_mesh(mesh):
        z = _encode_deterministic(model, tokens, seq_lens, classes)
        if use_fused:
            x0 = model.decode_init(z, classes).contiguous()
            seqs, scores = fused_decode(model, x0, max_len, keys[mesh.data_rank], temperature,
                                        mode=mode, top_k=top_k, top_p=top_p, classes=classes)
        else:
            seqs, scores = decode_stepwise(model, z, classes, max_len, keys[mesh.data_rank],
                                           temperature, mode, top_k=top_k, top_p=top_p)
    return gather_rows(seqs, mesh)[:B], gather_rows(scores, mesh)[:B]


@torch.inference_mode()
def sharded_style_transfer_all_classes(
    model: StyleVAE,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    max_len: int,
    num_classes: int,
    generator: torch.Generator,
    mesh: Mesh,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    params_on_mesh: bool = False,
    greedy: bool = False,
    use_fused: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mesh-sharded ``decode.style_transfer_all_classes``: the batch
    into every target class, C*B rows sharded over the data axis. Returns
    (seqs [C, B, max_len], scores [C, B])."""
    B, C = tokens.shape[0], num_classes
    classes = torch.arange(C, dtype=torch.long, device=tokens.device).repeat_interleave(B)
    seqs, scores = sharded_sample_sequences(
        model, tokens.repeat(C, 1), seq_lens.repeat(C), classes, max_len, generator, mesh,
        temperature, top_k=top_k, top_p=top_p, greedy=greedy, params_on_mesh=params_on_mesh,
        use_fused=use_fused)
    return seqs.reshape(C, B, max_len), scores.reshape(C, B)

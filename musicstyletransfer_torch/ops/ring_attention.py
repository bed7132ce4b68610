"""Ring attention: exact sequence-parallel attention over a mesh's model
axis (counterpart of ``musicstyletransfer_tpu/ops/ring_attention.py``, which
has no Pallas call of its own: its kernels are the flash kernels', here K4
and K5 of ``ops/flash_attention.py``).

Each of the ring's n ranks holds a [B, H, T/n, hd] chunk of q, k and v
(chunk i on model rank i) and the GLOBAL prefix key lengths.

- Forward: step 0 is the diagonal chunk, with K4's own causal mask; steps
  1..n-1 rotate k/v one hop (to model rank m + 1, from m - 1) and attend to
  the visiting chunk through K4's key lengths (``_chunk_vis``: the global
  prefix clipped to the chunk, 0 for a causal chunk after the local one).
  The partials merge in float32 by logsumexp reweighting (``_merge``).
- Backward (a ``torch.autograd.Function``, the re-rotating backward of the
  JAX package, ``:136-205``): residuals are the local q/k/v, the merged out
  and the global lse only. The ring turns once more; each visiting chunk
  goes through K5 with the GLOBAL lse and out, which gives this rank's dq
  part and the chunk's dk/dv parts; the dk/dv accumulators (float32) ride
  with their chunk, and one last rotation brings them home.

A chunk whose keys are all hidden gives K4's empty-row result (zeros, lse
-1e30), which the merge weights by exp(-1e30 - lse) = 0; two such partials
merge to about -1e30 + log 2, which K5 still reads as a row with no key
(lse <= -1e29).

The per-rank step is written once (``_forward_steps``, ``_backward_steps``:
generators that yield the tensors to rotate and receive the rotated ones).
``ring_attention`` drives it with the mesh's NCCL/gloo rotation;
``ring_forward_lockstep`` and ``ring_backward_lockstep`` drive n ranks in one
process, each step of every rank before the next rotation, with the
rotation done by list indexing (the card check of ``chip_smoke.py`` and the
tests).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .flash_attention import flash_backward, flash_forward

Rotate = Callable[[Sequence[torch.Tensor]], Sequence[torch.Tensor]]


def _merge(out1, lse1, out2, lse2):
    """Exact combination of two normalised softmax partials, float32."""
    lse = torch.logaddexp(lse1, lse2)
    return (out1 * torch.exp(lse1 - lse)[..., None]
            + out2 * torch.exp(lse2 - lse)[..., None]), lse


def _chunk_vis(key_lens: torch.Tensor, src: int, idx: int, Tl: int, causal: bool):
    """Visible key count of chunk ``src`` for rank ``idx``'s queries, an
    off-diagonal chunk: the global prefix clipped to the chunk, 0 (causal)
    for a chunk after the local one."""
    if causal and src > idx:
        return torch.zeros_like(key_lens)
    return (key_lens - src * Tl).clamp(0, Tl).to(torch.int32)


def _forward_steps(q, k, v, key_lens, idx: int, n: int, causal: bool, sm_scale: float):
    """Rank ``idx``'s forward; yields (k_c, v_c) before each rotation and
    returns (out float32, global lse)."""
    Tl = q.shape[2]
    lens0 = (key_lens - idx * Tl).clamp(0, Tl).to(torch.int32)
    out, lse = flash_forward(q, k, v, lens0, causal, sm_scale)
    out = out.float()
    k_c, v_c = k, v
    for s in range(1, n):
        k_c, v_c = yield (k_c, v_c)
        src = (idx - s) % n
        o_s, l_s = flash_forward(q, k_c, v_c, _chunk_vis(key_lens, src, idx, Tl, causal),
                                 False, sm_scale)
        out, lse = _merge(out, lse, o_s.float(), l_s)
    return out, lse


def _backward_steps(q, k, v, key_lens, out, lse, g, idx: int, n: int, causal: bool,
                    sm_scale: float):
    """Rank ``idx``'s re-rotating backward; yields (k_c, v_c, dk_c, dv_c)
    before each rotation and (dk_c, dv_c) before the last one home, and
    returns (dq, dk, dv) in float32."""
    Tl = q.shape[2]
    out = out.to(q.dtype)  # K5 reads out in q's dtype
    g = g.to(q.dtype)
    lens0 = (key_lens - idx * Tl).clamp(0, Tl).to(torch.int32)
    dq, dk_c, dv_c = (x.float() for x in
                      flash_backward(q, k, v, lens0, lse, out, g, causal, sm_scale))
    if n == 1:
        return dq, dk_c, dv_c
    k_c, v_c = k, v
    for s in range(1, n):
        k_c, v_c, dk_c, dv_c = yield (k_c, v_c, dk_c, dv_c)
        src = (idx - s) % n
        dq_s, dk_s, dv_s = flash_backward(q, k_c, v_c,
                                          _chunk_vis(key_lens, src, idx, Tl, causal),
                                          lse, out, g, False, sm_scale)
        dq = dq + dq_s.float()
        dk_c = dk_c + dk_s.float()
        dv_c = dv_c + dv_s.float()
    # chunk j's accumulators sit on rank (j + n - 1) % n: one hop brings them home
    dk, dv = yield (dk_c, dv_c)
    return dq, dk, dv


def _drive(steps, rotate: Rotate):
    """Run one rank's steps, rotating through ``rotate``."""
    try:
        sent = next(steps)
        while True:
            sent = steps.send(tuple(rotate(sent)))
    except StopIteration as stop:
        return stop.value


def _drive_lockstep(steps: List) -> List:
    """Run n ranks' steps in one process: every rank's step, then the
    rotation (rank i receives rank i - 1's tensors), then the next."""
    n = len(steps)
    results: List = [None] * n
    live = [True] * n

    def advance(i, value):
        try:
            return steps[i].send(value)
        except StopIteration as stop:
            results[i] = stop.value
            live[i] = False
            return None

    sent = [advance(i, None) for i in range(n)]
    while any(live):
        if not all(live):
            raise RuntimeError("ring ranks finished at different steps")
        sent = [advance(i, sent[(i - 1) % n]) for i in range(n)]
    return results


class RingAttention(torch.autograd.Function):
    """This rank's ring attention over the ``rotate`` of an n-rank ring at
    position ``idx``; backward re-rotates."""

    @staticmethod
    def forward(ctx, q, k, v, key_lens, causal, sm_scale, idx, n, rotate):
        out, lse = _drive(_forward_steps(q, k, v, key_lens, idx, n, causal, sm_scale), rotate)
        ctx.save_for_backward(q, k, v, key_lens, out, lse)
        ctx.config = (causal, sm_scale, idx, n, rotate)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_lens, out, lse = ctx.saved_tensors
        causal, sm_scale, idx, n, rotate = ctx.config
        dq, dk, dv = _drive(_backward_steps(q, k, v, key_lens, out, lse, g, idx, n, causal,
                                            sm_scale), rotate)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_lens: torch.Tensor,
                   causal: bool, sm_scale: Optional[float] = None, mesh=None) -> torch.Tensor:
    """Ring attention on this rank's chunks q, k, v [B, H, T/n, hd] (chunk
    m of the global time axis on model rank m of ``mesh``, the current mesh
    by default) with GLOBAL prefix ``key_lens`` [B]: this rank's chunk of
    the exact global attention, differentiable in q, k and v."""
    if mesh is None:
        from ..parallel.mesh import current_mesh

        mesh = current_mesh()
    if mesh is None:
        raise ValueError("ring_attention needs a mesh")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return RingAttention.apply(q, k, v, key_lens.to(torch.int32).contiguous(), causal,
                               float(sm_scale), mesh.model_rank, mesh.tp, mesh.rotate_model)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_lens: torch.Tensor, *, causal: bool,
                         sm_scale: Optional[float] = None, mesh=None) -> torch.Tensor:
    """The ring's body on this rank's time chunks (the JAX package's
    ``ring_flash_attention``, which names the ring by its axis; here the
    mesh's model axis): ``ring_attention``."""
    return ring_attention(q, k, v, key_lens, causal, sm_scale, mesh)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_lens: torch.Tensor, causal: bool = False,
                           sm_scale: Optional[float] = None, mesh=None) -> torch.Tensor:
    """``ring_attention`` on q, k, v [B, H, T, hd] that every rank of the
    model group holds whole (the JAX package's ``ring_attention_sharded``):
    T padded to a multiple of the ring, this rank's chunk taken, the ring
    run, the chunks gathered back and the padding sliced off. The padded
    keys sit beyond every key length; the padded query rows are dropped."""
    from ..parallel.collectives import gather_seq, scatter_seq
    from ..parallel.mesh import SeqShard, current_mesh

    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("ring_attention_sharded needs a mesh")
    seq = SeqShard(q.shape[2], mesh.tp, mesh.model_rank)
    chunks = [scatter_seq(x, seq, mesh, dim=2) for x in (q, k, v)]
    out = ring_attention(*chunks, key_lens, causal, sm_scale, mesh)
    return gather_seq(out, seq, mesh, dim=2)


def ring_forward_lockstep(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor], key_lens: torch.Tensor, causal: bool,
                          sm_scale: float) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The ring's forward for n ranks in one process: [(out float32, lse)]
    of each rank, from the per-rank chunks."""
    key_lens = key_lens.to(torch.int32).contiguous()
    n = len(qs)
    return _drive_lockstep([_forward_steps(qs[i], ks[i], vs[i], key_lens, i, n, causal,
                                           sm_scale) for i in range(n)])


def ring_backward_lockstep(qs, ks, vs, key_lens: torch.Tensor, outs, lses, gs, causal: bool,
                           sm_scale: float) -> List[Tuple[torch.Tensor, ...]]:
    """The ring's re-rotating backward for n ranks in one process: [(dq,
    dk, dv) float32] of each rank."""
    key_lens = key_lens.to(torch.int32).contiguous()
    n = len(qs)
    return _drive_lockstep([_backward_steps(qs[i], ks[i], vs[i], key_lens, outs[i], lses[i],
                                            gs[i], i, n, causal, sm_scale) for i in range(n)])

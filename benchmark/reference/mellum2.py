"""The plain reference of the VAE with one period of Mellum2-12B-A2.5B as its
decoder, in float32.

Written from the published configuration (``configs/vae_mellum2.json``,
https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct) and the VAE's
description (``reference/model.py``, whose encoder, loss, Adam and
precision controls it reuses). The decoder, with x its input [B, T, D]:

- x = sqrt(D) x (the VAE's embeddings are normal with variance 1/D); no
  positional table, the layers rotate q and k instead;
- each layer: x += Attn(RMSNorm(x)), then x += MoE(RMSNorm(x)); a final
  RMSNorm before the vocabulary head. RMSNorm: x / sqrt(mean(x^2) + 1e-6)
  times a weight. No biases in the layers;
- Attn: q = x Wq [H=32 heads of 128], k = x Wk and v = x Wv [4 heads],
  query head h reads K/V head h // 8; q and k rotated (the halves layout,
  as Hugging Face's ``rotate_half``); softmax(q k / sqrt(128)) over the
  keys a query sees: causal, below the row's key length and, on a
  ``sliding_attention`` layer, i - 1024 < j; out = heads Wo;
- rotary frequencies: ``sliding_attention`` the default 1 / 500000^(2i/128);
  ``full_attention`` YaRN (factor 16, original 8192 positions, beta_fast
  32, beta_slow 1, Hugging Face's ``_compute_yarn_parameters`` with its
  truncated correction range), cos and sin times the attention factor
  1.2772588722239782;
- MoE: the router softmax(x Wr) over 64 experts in float32, the top 8 kept
  and renormalised to sum 1; y = sum of w_e Down_e(silu(Gate_e x) * Up_e x),
  Gate and Up [2304, 896] side by side in ``w_gate_up`` [E, 2304, 1792],
  Down ``w_down`` [E, 896, 2304]; every position goes to its 8 experts, a
  plain loop over the experts.

Departures from the published model: the MTP head is left out (the
configuration has no key for it); no qk-norm, no router auxiliary loss and
no decoder dropout, since the configuration gives none; the embedding and
the head are the VAE's over its 293 MIDI events, with the latent and class
conditioning (``per_step``) of the long recipe. Plain torch operations
only, nothing of the measured package, no cache, no batching tricks.

The whole batch's gradient is summed over blocks of ``ROWS`` rows (each
block's loss over the batch's size), so the reference fits on the card at
the cell's batch; dropout masks and eps are drawn for the whole batch first,
in a training step's order (the encoder's layers, then eps), and each block
takes its rows. fp8, the control, rounds with a scale a block's tensor.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from reference import model as base
from reference.model import PAD, Numerics, no_tf32, optimizer_params  # noqa: F401

NEG = base.NEG
ROWS = 2  # rows a block


def decoder_widths(cfg: dict) -> dict:
    """The decoder's widths, under the published configuration's keys at the
    configuration's top level."""
    d = cfg
    return {"D": d["hidden_size"], "H": d["num_attention_heads"], "Hkv": d["num_key_value_heads"],
            "hd": d["head_dim"], "E": d["num_experts"], "k": d["num_experts_per_tok"],
            "F": d["moe_intermediate_size"], "types": d["layer_types"],
            "window": d["sliding_window"]}


def shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's flax path and shape."""
    V, C, Z = cfg["vocab_size"], cfg["num_classes"], cfg["latent_dim"]
    w = decoder_widths(cfg)
    D, H, Hkv, hd, E, Fw = w["D"], w["H"], w["Hkv"], w["hd"], w["E"], w["F"]
    enc = {**cfg, "decoder": {"model_size": 8, "num_layers": 0, "ffn_multiplier": 1}}
    out = {k: s for k, s in base.shapes(enc).items() if k.startswith("encoder/")}
    out["decoder/latent2hid/kernel"], out["decoder/latent2hid/bias"] = (Z, D), (D,)
    out["decoder/class_emb/embedding"] = (C, D)
    out["decoder/token_emb/embedding"] = (V, D)
    for i in range(len(w["types"])):
        lp = f"decoder/decoder/layer{i}"
        out[f"{lp}/attention/w_q/kernel"] = (D, H * hd)
        out[f"{lp}/attention/w_k/kernel"] = (D, Hkv * hd)
        out[f"{lp}/attention/w_v/kernel"] = (D, Hkv * hd)
        out[f"{lp}/attention/w_o/kernel"] = (H * hd, D)
        out[f"{lp}/ln1/scale"], out[f"{lp}/ln2/scale"] = (D,), (D,)
        out[f"{lp}/ff/router/kernel"] = (D, E)
        out[f"{lp}/ff/w_gate_up"] = (E, D, 2 * Fw)
        out[f"{lp}/ff/w_down"] = (E, Fw, D)
    out["decoder/decoder/final_ln/scale"] = (D,)
    out["decoder/output_layer/kernel"], out["decoder/output_layer/bias"] = (D, V), (V,)
    return out


def init_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights made on ``device`` in one draw, as ``model.init_params``:
    kernels (and each expert's [in, out] matrices) normal with variance
    1/fan_in, embeddings with variance 1/features, biases 0, scales 1."""
    sh = shapes(cfg)
    names = sorted(sh)
    sizes = [math.prod(sh[n]) for n in names]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for name, piece in zip(names, flat.split(sizes)):
        s = sh[name]
        if name.endswith("/bias"):
            piece = torch.zeros(s, device=device)
        elif name.endswith("/scale"):
            piece = torch.ones(s, device=device)
        elif name.endswith("/kernel"):
            piece = piece.view(s) * s[0] ** -0.5
        elif len(s) == 3:  # an expert's stacked kernels [E, in, out]
            piece = piece.view(s) * s[1] ** -0.5
        else:  # an embedding
            piece = piece.view(s) * s[1] ** -0.5
        out[name] = piece.contiguous()
    del flat
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * w


def inv_freq(cfg: dict, layer_type: str):
    """(inverse frequencies [hd / 2], the factor on cos and sin) of a layer."""
    hd = cfg["head_dim"]
    rp = cfg["rope_parameters"][layer_type]
    theta = float(rp["rope_theta"])
    pos_freqs = theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    if rp["rope_type"] == "default":
        return (1.0 / pos_freqs).float(), 1.0
    factor, orig = float(rp["factor"]), float(rp["original_max_position_embeddings"])

    def correction_dim(rotations):
        return hd * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(rp["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rp["beta_slow"])), hd - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(hd // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    keep = 1 - ramp  # 1: the extrapolated (original) frequency, 0: the interpolated one
    freqs = (1.0 / (factor * pos_freqs)) * (1 - keep) + (1.0 / pos_freqs) * keep
    return freqs.float(), float(rp["attention_factor"])


def rope(x: torch.Tensor, freqs: torch.Tensor, factor: float) -> torch.Tensor:
    """x [B, T, heads, hd] rotated at positions 0..T-1."""
    T, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * freqs.to(x.device)
    ang = torch.cat([ang, ang], -1)
    cos, sin = (ang.cos() * factor)[:, None], (ang.sin() * factor)[:, None]
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def moe(x: torch.Tensor, p, lp: str, w: dict, num: Numerics) -> torch.Tensor:
    """The experts' sum over x [B, T, D], a loop over the experts."""
    act = num.act
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf @ p[f"{lp}/ff/router/kernel"], -1)
    weights, experts = probs.topk(w["k"], dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in range(w["E"]):
        rows, slot = (experts == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        gate, up = num.einsum("ni,io->no", xf[rows], p[f"{lp}/ff/w_gate_up"][e]).chunk(2, -1)
        h = act(act(F.silu(gate)) * up)
        y = num.einsum("nf,fd->nd", h, p[f"{lp}/ff/w_down"][e])
        out = out.index_add(0, rows, weights[rows, slot, None] * y)
    return act(out).view(x.shape)


def decode(p, cfg, tokens, key_len, z, classes, num: Numerics) -> torch.Tensor:
    """Teacher-forced logits [B, T, V] of tokens [B, T] (SOS first) after the
    conditioning position; ``key_len`` [B] counts the valid positions with
    the conditioning one."""
    act = num.act
    w = decoder_widths(cfg)
    D, H, Hkv, hd = w["D"], w["H"], w["Hkv"], w["hd"]
    emb = act(p["decoder/token_emb/embedding"][tokens])
    cls = act(p["decoder/class_emb/embedding"][classes])
    if cfg["class_conditioning"] == "per_step":
        emb = act(emb + cls[:, None])
    init = act(num.dense(z, p, "decoder/latent2hid") + cls)
    x = torch.cat([init[:, None], emb], 1)
    B, T, _ = x.shape
    x = act(x * act(torch.tensor(math.sqrt(D), device=x.device)))
    pos = torch.arange(T, device=x.device)
    key_mask = pos[None] < key_len[:, None]
    causal = pos[None, :] <= pos[:, None]
    for i, kind in enumerate(w["types"]):
        lp = f"decoder/decoder/layer{i}"
        h = act(rms_norm(x, p[f"{lp}/ln1/scale"]))
        q, k, v = (num.einsum("bti,io->bto", h, p[f"{lp}/attention/{m}/kernel"])
                   .view(B, T, -1, hd) for m in ("w_q", "w_k", "w_v"))
        freqs, factor = inv_freq(cfg, kind)
        q, k = act(rope(q, freqs, factor)), act(rope(k, freqs, factor))
        k, v = k.repeat_interleave(H // Hkv, 2), v.repeat_interleave(H // Hkv, 2)
        seen = causal
        if kind == "sliding_attention":
            seen = seen & (pos[None, :] > pos[:, None] - w["window"])
        allowed = key_mask[:, None, None, :] & seen
        s = act(num.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd))
        a = act(torch.softmax(s.masked_fill(~allowed, NEG), -1))
        ctx = num.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, H * hd)
        x = act(x + num.einsum("bti,io->bto", ctx, p[f"{lp}/attention/w_o/kernel"]))
        x = act(x + moe(act(rms_norm(x, p[f"{lp}/ln2/scale"])), p, lp, w, num))
    h = act(rms_norm(x, p["decoder/decoder/final_ln/scale"]))[:, 1:]
    return num.dense(h, p, "decoder/output_layer", compute=False)


class Drawn:
    """Dropout from masks drawn ahead: hands out the next mask's rows."""

    def __init__(self, masks: List[torch.Tensor], rows: slice):
        self.masks, self.rows, self.used = masks, rows, 0

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0 or not self.masks:
            return x
        keep = self.masks[self.used][self.rows]
        self.used += 1
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def draws(cfg, batch, generator: Optional[torch.Generator]):
    """(the encoder's keep masks in draw order, eps [B, latent]) at the whole
    batch's shapes, from ``generator`` in a training step's order."""
    B, T = batch["tokens"].shape
    e = cfg["encoder"]
    D, FF, rate = e["model_size"], e["model_size"] * e["ffn_multiplier"], e["dropout"]
    dev = batch["tokens"].device
    masks = []
    if generator is not None and rate > 0:
        for _ in range(e["num_layers"]):
            for shape in ((B, T, D), (B, T, FF), (B, T, D)):
                masks.append(torch.rand(shape, generator=generator, device=dev) >= rate)
    eps = torch.randn((B, cfg["latent_dim"]), generator=generator, device=dev)
    return masks, eps


def loss_grads(p, cfg, batch, step: int, num: Numerics, generator, names: List[str]):
    """(the batch's loss, its gradient by leaf of ``names``): summed over
    blocks of ``ROWS`` rows, each block's per-row loss over the batch's
    size; ``step`` steps taken before (the KL anneal)."""
    t = cfg["train"]
    masks, eps = draws(cfg, batch, generator)
    B = batch["tokens"].shape[0]
    weight = t["kl_loss"] * (min(step / t["kl_anneal_steps"], 1.0) if t["kl_anneal_steps"] > 0
                             else 1.0)
    total, grads = 0.0, None
    leaves = [p[k] for k in names]
    for b0 in range(0, B, ROWS):
        rows = slice(b0, min(B, b0 + ROWS))
        tok, cls = batch["tokens"][rows], batch["classes"][rows]
        mu, logvar = base.encode(p, cfg, tok, cls, num, Drawn(masks, rows))
        z = mu + eps[rows] * torch.exp(0.5 * logvar)
        logits = decode(p, cfg, tok, batch["seq_lens"][rows] + 1, z, cls, num)
        labels = batch["labels"][rows]
        mask = (labels != PAD).float()
        picked = torch.log_softmax(logits, -1).gather(-1, labels[..., None])[..., 0]
        ce = -(picked * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)
        per_dim = 0.5 * (torch.exp(logvar) + mu * mu - 1.0 - logvar)
        kl = (per_dim.clamp_min(t["free_bits"]) if t["free_bits"] > 0 else per_dim).sum(-1)
        part = (ce + weight * kl).sum() / B
        g = torch.autograd.grad(part, leaves, allow_unused=True)
        if grads is None:
            grads = [torch.zeros_like(x) for x in leaves]
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc.add_(gi)
        total += float(part.detach())
        del logits, picked, g
    return total, dict(zip(names, grads))


def train_steps(p0, cfg, batches: List[dict], generator: torch.Generator, num: Numerics,
                moment_after: int = 1, step0: int = 0, m0=None, v0=None) -> dict:
    """``model.train_steps`` with the gradient summed over blocks of rows and
    TF32 off (``no_tf32``):
    Adam steps from ``p0`` (moments ``m0``, ``v0`` after ``step0`` steps).
    {"loss": [per step], "grad", "grad2": {leaf: the bias-corrected moments
    after step ``moment_after``}, "params", "m", "v": {leaf: after the
    last step}}."""
    t = cfg["train"]
    assert t["optimizer"] == "adam"
    extra = optimizer_params(cfg)
    clip = extra.get("clip_gradient")
    b1, b2, eps_ = extra.get("beta1", 0.9), extra.get("beta2", 0.999), extra.get("epsilon", 1e-8)
    lr = t["learning_rate"]
    names = list(p0)
    p = {k: v.detach().clone().requires_grad_() for k, v in p0.items()}
    m = {k: (torch.zeros_like(v) if m0 is None else m0[k].clone()) for k, v in p.items()}
    v2 = {k: (torch.zeros_like(v) if v0 is None else v0[k].clone()) for k, v in p.items()}
    out = {"loss": [], "grad": None}
    for i, batch in enumerate(batches):
        n = step0 + i + 1
        with no_tf32():
            total, grads = loss_grads(p, cfg, batch, n - 1, num, generator, names)
        out["loss"].append(total)
        with torch.no_grad():
            for k, w in p.items():
                u = grads[k].clamp(-clip, clip) if clip is not None else grads[k]
                m[k].mul_(b1).add_((1 - b1) * u)
                v2[k].mul_(b2).add_((1 - b2) * u * u)
                w.add_(-lr * (m[k] / (1 - b1 ** n)) / (torch.sqrt(v2[k] / (1 - b2 ** n)) + eps_))
            del grads
            if i + 1 == moment_after:
                out["grad"] = {k: (m[k] / (1 - b1 ** n)).clone() for k in p}
                out["grad2"] = {k: (v2[k] / (1 - b2 ** n)).clone() for k in p}
    out["params"] = {k: w.detach() for k, w in p.items()}
    out["m"], out["v"] = m, v2
    return out

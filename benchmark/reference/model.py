"""The plain reference of the class-conditional sequence VAE, in float32.

Written from the model's description (``benchmark/configs/*.json`` name the
widths): token and class embeddings, a post-LN transformer encoder whose
position-0 state gives (mu, logvar), the reparameterised z, a causal
post-LN transformer decoder conditioned on latent2hid(z) + the class row
(and, under ``per_step``, the class row added to every token), the masked
cross-entropy and the free-bits KL, elementwise gradient clipping and Adam.
Plain torch operations only; nothing of the measured package is imported.
Parameters are a dict keyed by flax paths (``encoder/encoder/layer0/
attention/w_q/kernel``), kernels laid out [in, out].

Precision: ``Numerics("float32")`` is the reference (TF32 must be off on a
card: ``no_tf32``); ``Numerics("fp8")`` is the control and
``Numerics("bfloat16")`` a witness at the program's own precision: each
rounds what the program holds in its compute dtype (``Numerics``).

Random numbers: dropout keep masks (``rand >= rate``) and eps (``randn``)
come from a ``torch.Generator`` seeded as the trainer's, drawn in the order
a training step draws them: per layer the attention branch [B, T, D], the
FFN's hidden [B, T, FF], the FFN branch [B, T, D]; the encoder's layers,
then eps [B, latent], then the decoder's layers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

PAD, SOS, EOS = 0, 1, 2
NEG = -1e9  # masked attention scores


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 on the card while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to bf16, to TF32's 10-bit mantissa, or to a float8
    format (``e4m3``, ``e5m2``) under one scale for the tensor, back in
    float32."""
    if kind == "bfloat16":
        return x.to(torch.bfloat16).float()
    if kind == "tf32":  # round to nearest on the 13 low mantissa bits
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    dtype, top = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}[kind]
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Rounded(torch.autograd.Function):
    """Forward: the value rounded as ``fwd`` says; backward: its gradient
    rounded as ``bwd`` says (the program's backward holds its gradients in
    the compute dtype too)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


class Numerics:
    """How the model rounds. "float32": the reference, nothing rounded.
    "bfloat16" (the program's own precision, a witness) and "fp8" (the
    control of a bf16 configuration): every value the measured program holds
    in its compute dtype is rounded (embeddings, the stack's input, every
    compute-dtype product's operands and output, biases, attention scores
    and probabilities, residual sums, LayerNorm and FFN outputs), and so is
    the gradient of each; bf16 both ways, fp8 as e4m3 forward and e5m2
    backward with a scale a tensor. The latent head and the vocabulary head
    stay float32, as the program's do. "tf32" (the control of a float32
    configuration): every product's operands, and their gradients, rounded
    to TF32's 10-bit mantissa, as TF32 products take them."""

    FORMATS = {"bfloat16": ("bfloat16", "bfloat16"), "fp8": ("e4m3", "e5m2"),
               "tf32": ("tf32", "tf32")}
    CONTROL = {"bfloat16": "fp8", "float32": "tf32"}  # the nearest lower precision

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bfloat16", "fp8", "tf32"):
            raise ValueError(kind)
        self.kind = kind

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind in ("float32", "tf32"):
            return x
        return _Rounded.apply(x, *self.FORMATS[self.kind])

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        return _Rounded.apply(x, *self.FORMATS[self.kind])

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.act(torch.einsum(eq, self.operand(a), self.operand(b)))

    def dense(self, x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
              compute: bool = True) -> torch.Tensor:
        """x @ kernel + bias; ``compute=False``: a float32 layer."""
        w, b = p[name + "/kernel"], p[name + "/bias"]
        if not compute:
            return torch.einsum("...i,io->...o", x, w) + b
        return self.act(self.einsum("...i,io->...o", x, w) + self.act(b))


# --------------------------------------------------------------------------
# Parameters


def shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's flax path and shape, for a configuration file."""
    V, C, Z = cfg["vocab_size"], cfg["num_classes"], cfg["latent_dim"]
    out: Dict[str, tuple] = {}

    def stack(prefix: str, w: dict) -> None:
        D, FF = w["model_size"], w["model_size"] * w["ffn_multiplier"]
        for i in range(w["num_layers"]):
            lp = f"{prefix}/layer{i}"
            for m in ("w_q", "w_k", "w_v", "w_o"):
                out[f"{lp}/attention/{m}/kernel"] = (D, D)
                out[f"{lp}/attention/{m}/bias"] = (D,)
            out[f"{lp}/ff/ff1/kernel"], out[f"{lp}/ff/ff1/bias"] = (D, FF), (FF,)
            out[f"{lp}/ff/ff2/kernel"], out[f"{lp}/ff/ff2/bias"] = (FF, D), (D,)
            for n in ("ln1", "ln2"):
                out[f"{lp}/{n}/scale"], out[f"{lp}/{n}/bias"] = (D,), (D,)

    De, Dd = cfg["encoder"]["model_size"], cfg["decoder"]["model_size"]
    out["encoder/token_emb/embedding"] = (V, De)
    out["encoder/class_emb/embedding"] = (C, De)
    stack("encoder/encoder", cfg["encoder"])
    out["encoder/latent_proj/kernel"], out["encoder/latent_proj/bias"] = (De, 2 * Z), (2 * Z,)
    out["decoder/latent2hid/kernel"], out["decoder/latent2hid/bias"] = (Z, Dd), (Dd,)
    out["decoder/class_emb/embedding"] = (C, Dd)
    out["decoder/token_emb/embedding"] = (V, Dd)
    stack("decoder/decoder", cfg["decoder"])
    out["decoder/output_layer/kernel"], out["decoder/output_layer/bias"] = (Dd, V), (V,)
    return out


def init_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights, made on ``device`` in one draw: a kernel normal with
    variance 1/fan_in, an embedding normal with variance 1/features, biases
    0, LayerNorm scales 1. The same seed and device give the same weights."""
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
        else:  # an embedding
            piece = piece.view(s) * s[1] ** -0.5
        out[name] = piece.contiguous()
    return out


def load_params(path: str, cfg: dict, device) -> Dict[str, torch.Tensor]:
    """An export's ``params.npz`` (flax paths, kernels [in, out])."""
    sh = shapes(cfg)
    with np.load(path) as z:
        out = {k: torch.tensor(np.asarray(z[k], np.float32), device=device) for k in sh}
    for k, s in sh.items():
        if tuple(out[k].shape) != s:
            raise ValueError(f"{k}: {tuple(out[k].shape)} in the file, {s} in the configuration")
    return out


# --------------------------------------------------------------------------
# The model


def positions(D: int, T: int, device) -> torch.Tensor:
    """The sinusoid table: column i at 10000^(2i/D), sine on even columns,
    cosine on odd ones."""
    pos = np.arange(T).reshape(-1, 1) / np.power(10000, (2.0 / D) * np.arange(D).reshape(1, -1))
    pos[:, 0::2] = np.sin(pos[:, 0::2])
    pos[:, 1::2] = np.cos(pos[:, 1::2])
    return torch.tensor(pos, dtype=torch.float32, device=device)


class Dropout:
    """Keep masks from ``generator`` in draw order; None: no dropout."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.g = generator

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.g is None or rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.g, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + "/scale"], p[name + "/bias"], 1e-6)


def stack(x: torch.Tensor, p, prefix: str, w: dict, key_mask: torch.Tensor, causal: bool,
          num: Numerics, drop: Dropout) -> torch.Tensor:
    """x [B, T, D] before scaling -> the post-LN stack's output."""
    B, T, D = x.shape
    H = w["num_heads"]
    hd = D // H
    rate = w["dropout"]
    act = num.act
    x = act(act(x * math.sqrt(D)) + act(positions(D, T, x.device)))
    allowed = key_mask[:, None, None, :]
    if causal:
        allowed = allowed & torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for i in range(w["num_layers"]):
        lp = f"{prefix}/layer{i}"
        q, k, v = (num.dense(x, p, f"{lp}/attention/{m}").view(B, T, H, hd)
                   for m in ("w_q", "w_k", "w_v"))
        s = act(num.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd))
        a = act(torch.softmax(s.masked_fill(~allowed, NEG), -1))
        ctx = num.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, D)
        y = act(drop(num.dense(ctx, p, f"{lp}/attention/w_o"), rate))
        x = act(layer_norm(act(x + y), p, f"{lp}/ln1"))
        h = act(drop(act(torch.relu(num.dense(x, p, f"{lp}/ff/ff1"))), rate))
        y = act(drop(num.dense(h, p, f"{lp}/ff/ff2"), rate))
        x = act(layer_norm(act(x + y), p, f"{lp}/ln2"))
    return x


def encode(p, cfg, tokens, classes, num: Numerics, drop: Dropout):
    """(mu, logvar) of SOS-prefixed tokens [B, L+1] for ``classes`` [B]."""
    act = num.act
    x = act(act(p["encoder/token_emb/embedding"][tokens])
            + act(p["encoder/class_emb/embedding"][classes])[:, None])
    h = stack(x, p, "encoder/encoder", cfg["encoder"], tokens != PAD, False, num, drop)
    mu, logvar = num.dense(h[:, 0], p, "encoder/latent_proj", compute=False).chunk(2, -1)
    return mu, logvar.clamp(-8.0, 8.0)


def decode(p, cfg, tokens, key_len, z, classes, num: Numerics, drop: Dropout):
    """Teacher-forced logits [B, T, V] of tokens [B, T] (SOS first) after the
    conditioning position; ``key_len`` [B] counts the valid positions with
    the conditioning one."""
    act = num.act
    emb = act(p["decoder/token_emb/embedding"][tokens])
    cls = act(p["decoder/class_emb/embedding"][classes])
    if cfg["class_conditioning"] == "per_step":
        emb = act(emb + cls[:, None])
    init = act(num.dense(z, p, "decoder/latent2hid") + cls)
    x = torch.cat([init[:, None], emb], 1)
    T = x.shape[1]
    key_mask = torch.arange(T, device=x.device)[None] < key_len[:, None]
    h = stack(x, p, "decoder/decoder", cfg["decoder"], key_mask, True, num, drop)[:, 1:]
    return num.dense(h, p, "decoder/output_layer", compute=False)


def loss(p, cfg, batch, step: int, num: Numerics, generator: Optional[torch.Generator]):
    """One training step's loss on batch {tokens, seq_lens, classes, labels}
    (device tensors) after ``step`` steps; the KL weight anneals with it."""
    t = cfg["train"]
    drop = Dropout(generator)
    mu, logvar = encode(p, cfg, batch["tokens"], batch["classes"], num, drop)
    eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    z = mu + eps * torch.exp(0.5 * logvar)
    logits = decode(p, cfg, batch["tokens"], batch["seq_lens"] + 1, z, batch["classes"], num, drop)
    labels = batch["labels"]
    mask = (labels != PAD).float()
    picked = torch.log_softmax(logits, -1).gather(-1, labels[..., None])[..., 0]
    ce = -(picked * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)
    per_dim = 0.5 * (torch.exp(logvar) + mu * mu - 1.0 - logvar)
    kl = (per_dim.clamp_min(t["free_bits"]) if t["free_bits"] > 0 else per_dim).sum(-1)
    weight = t["kl_loss"] * (min(step / t["kl_anneal_steps"], 1.0) if t["kl_anneal_steps"] > 0
                             else 1.0)
    return ce.mean() + weight * kl.mean()


def optimizer_params(cfg: dict) -> Dict[str, float]:
    out = {}
    for kv in cfg["train"]["optimizer_params"].split(","):
        if kv.count(":") == 1:
            k, v = kv.split(":")
            out[k] = float(v)
    return out


def train_steps(p0, cfg, batches: List[dict], generator: torch.Generator, num: Numerics,
                moment_after: int = 1, step0: int = 0, m0=None, v0=None) -> dict:
    """Adam steps from parameters ``p0`` (and moments ``m0``, ``v0`` after
    ``step0`` steps; zeros after none) on ``batches``, dropout and eps drawn
    from ``generator``: {"loss": [per step], "grad": {leaf: the
    bias-corrected first moment after step ``moment_after`` of these, which
    from zeros after step 1 is the first clipped gradient}, "grad2": {leaf:
    the bias-corrected second moment then}, "params", "m", "v": {leaf:
    after the last step}}."""
    t = cfg["train"]
    assert t["optimizer"] == "adam"
    extra = optimizer_params(cfg)
    clip = extra.get("clip_gradient")
    b1, b2, eps_ = extra.get("beta1", 0.9), extra.get("beta2", 0.999), extra.get("epsilon", 1e-8)
    lr = t["learning_rate"]
    p = {k: v.detach().clone().requires_grad_() for k, v in p0.items()}
    m = {k: (torch.zeros_like(v) if m0 is None else m0[k].clone()) for k, v in p.items()}
    v2 = {k: (torch.zeros_like(v) if v0 is None else v0[k].clone()) for k, v in p.items()}
    out = {"loss": [], "grad": None}
    for i, batch in enumerate(batches):
        n = step0 + i + 1  # Adam's count after this step
        total = loss(p, cfg, batch, n - 1, num, generator)
        grads = torch.autograd.grad(total, list(p.values()))
        out["loss"].append(float(total.detach()))
        with torch.no_grad():
            for (k, w), gr in zip(p.items(), grads):
                u = gr.clamp(-clip, clip) if clip is not None else gr
                m[k].mul_(b1).add_((1 - b1) * u)
                v2[k].mul_(b2).add_((1 - b2) * u * u)
                mh = m[k] / (1 - b1 ** n)
                vh = v2[k] / (1 - b2 ** n)
                w.add_(-lr * mh / (torch.sqrt(vh) + eps_))
            if i + 1 == moment_after:
                out["grad"] = {k: (m[k] / (1 - b1 ** n)).clone() for k in p}
                out["grad2"] = {k: (v2[k] / (1 - b2 ** n)).clone() for k in p}
    out["params"] = {k: w.detach() for k, w in p.items()}
    out["m"], out["v"] = m, v2
    return out


@torch.no_grad()
def transfer_logits(p, cfg, source: torch.Tensor, rows: torch.Tensor, classes: torch.Tensor,
                    num: Numerics) -> torch.Tensor:
    """The decoder's logits [R, T-1, V] along served rows [R, T] (SOS
    first) for style transfer of SOS-prefixed sources [R, L+1] into
    ``classes``: z = mu of the source encoded for the target class; the
    logits at index t-1 are those the row's token t was chosen from."""
    mu, _ = encode(p, cfg, source, classes, num, Dropout(None))
    T = rows.shape[1]
    key_len = torch.full((rows.shape[0],), T, device=rows.device)
    return decode(p, cfg, rows[:, :-1], key_len, mu, classes, num, Dropout(None))

"""The VAE with one Mellum2 period as its decoder (grouped-query attention,
a sliding window beside full attention, RoPE with YaRN, RMSNorm, a top-k
mixture of SwiGLU experts) against the plain float32 reference of the
benchmark (``benchmark/reference/mellum2.py``), on the CPU at a small size
of the benchmark's own configuration (``benchmark/configs/vae_mellum2.json``
cut to hidden 64, 4 query heads over 2 K/V heads, a window of 8, 8 experts
top 2, L = 40), seeded random weights, float32 both sides.

Tolerances: products summed in other orders (the experts' grouped rows, the
flash route's blocks): 1e-4 of each result's largest magnitude (logits,
loss, every parameter's gradient), 1e-5 for the attention's plain versions
against dense attention, the routing exact.
"""

import copy
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmark"))

import harness  # noqa: E402
from reference import mellum2 as mref  # noqa: E402
from reference.model import Numerics  # noqa: E402

from musicstyletransfer_torch.convert import flax_names  # noqa: E402
from musicstyletransfer_torch.models import config as tconfig  # noqa: E402
from musicstyletransfer_torch.models.moe import MoE  # noqa: E402
from musicstyletransfer_torch.models.transformer import yarn_inv_freq  # noqa: E402
from musicstyletransfer_torch.models.vae import StyleVAE  # noqa: E402
from musicstyletransfer_torch.ops import flash_attention as fa  # noqa: E402
from musicstyletransfer_torch.training.loss import vae_loss  # noqa: E402

DRIVER = harness.load_module(ROOT / "benchmark" / "drivers" / "train_window_mellum2.py",
                             "driver_train_window_mellum2_test")


def tiny_cfg() -> dict:
    cfg = copy.deepcopy(json.loads((ROOT / "benchmark/configs/vae_mellum2.json").read_text()))
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               sliding_window=8, num_experts=8, num_experts_per_tok=2,
               moe_intermediate_size=24, latent_dim=16, dtype="float32")
    cfg["encoder"].update(model_size=32, num_heads=4, num_layers=1, dropout=0.0)
    cfg["train"].update(batch_size=3, max_seq_len=40)
    return cfg


def port_model(cfg: dict, flash: bool) -> StyleVAE:
    """The model of the benchmark's ``model_config``, on the flash route from T = 16 or
    dense, with the reference's seeded weights."""
    mc = DRIVER.model_config(cfg)
    if flash:
        def fl(tc):
            return dataclasses.replace(tc, flash_min_seq_len=16)
        mc = tconfig.ModelConfig(
            encoder_config=dataclasses.replace(
                mc.encoder_config, transformer_config=fl(mc.encoder_config.transformer_config)),
            decoder_config=dataclasses.replace(
                mc.decoder_config, transformer_config=fl(mc.decoder_config.transformer_config)),
            dtype=mc.dtype)
    model = StyleVAE(mc)
    params = mref.init_params(cfg, 7, "cpu")
    with torch.no_grad():
        for name, p in zip(flax_names(model), model.parameters()):
            w = params[name]
            p.copy_(w.t() if name.endswith("/kernel") else w)
    return model, params


def batch(B=3, L=40, lens=(40, 9, 1), seed=3):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.zeros(B, L + 1, dtype=torch.long)
    labels = torch.zeros(B, L + 1, dtype=torch.long)
    for b, n in enumerate(lens):
        seq = torch.randint(3, 293, (n,), generator=g)
        tokens[b, 0] = 1
        tokens[b, 1:n + 1] = seq
        labels[b, :n] = seq
        labels[b, n] = 2
    return {"tokens": tokens, "seq_lens": torch.tensor([n + 1 for n in lens]),
            "classes": torch.tensor([0, 1, 0][:B]), "labels": labels}


def close(a, b, tol=1e-4):
    a, b = torch.as_tensor(a).detach().double(), torch.as_tensor(b).detach().double()
    return float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("flash", [False, True])
def test_logits_loss_and_every_gradient_match_the_reference(flash):
    """Training mode (eps from the trainer's generator, the encoder's
    dropout 0): the decoder's logits, the loss with the KL anneal half way
    and every parameter's gradient against the reference's blocked
    gradient (blocks of 2 rows over a batch of 3), all but the encoder's
    key biases, whose gradient is round-off."""
    cfg = tiny_cfg()
    model, params = port_model(cfg, flash)
    model.train()
    b = batch()
    names = flax_names(model)
    logits, mu, logvar = model(b["tokens"], b["seq_lens"], b["classes"],
                               generator=torch.Generator().manual_seed(11))
    total, _ = vae_loss(logits, b["labels"], mu, logvar, kl_weight=0.25, free_bits=0.1)
    total.backward()
    ref = {k: v.clone().requires_grad_() for k, v in params.items()}
    rloss, rgrads = mref.loss_grads(ref, cfg, b, 1000, Numerics(), torch.Generator()
                                    .manual_seed(11), names)
    assert abs(float(total.detach()) - rloss) <= 1e-5 * abs(rloss)
    with torch.no_grad():
        eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(11))
        z = mu + eps * torch.exp(0.5 * logvar)
        rlogits = mref.decode(params, cfg, b["tokens"], b["seq_lens"] + 1, z, b["classes"],
                              Numerics())
    valid = b["labels"] != 0
    assert close(logits[valid], rlogits[valid])
    # the key biases' gradients are round-off (softmax ignores a shift shared
    # by a row's keys): leaves under a thousandth of the median leaf's norm
    median = float(np.median([float(g.norm()) for g in rgrads.values()]))
    checked = 0
    for name, p in zip(names, model.parameters()):
        g = p.grad.t() if name.endswith("/kernel") else p.grad
        if float(rgrads[name].norm()) >= 1e-3 * median:
            assert close(g, rgrads[name]), name
            checked += 1
    assert checked >= len(names) - 2


@pytest.mark.parametrize("H,Hkv,window", [(4, 2, 8), (4, 4, 8), (6, 2, 0), (4, 1, 3)])
def test_plain_flash_versions_against_masked_dense_attention(H, Hkv, window):
    """K4/K5's plain versions with grouped K/V heads and a window, causal,
    rows of length T, 9, 1 and 0, against dense attention over the repeated
    heads with the mask written out (a row that sees no key gives zeros)."""
    torch.manual_seed(0)
    B, T, D = 4, 40, 16
    q = torch.randn(B, H, T, D, dtype=torch.float64, requires_grad=True)
    k = torch.randn(B, Hkv, T, D, dtype=torch.float64, requires_grad=True)
    v = torch.randn(B, Hkv, T, D, dtype=torch.float64, requires_grad=True)
    lens = torch.tensor([T, 9, 1, 0], dtype=torch.int32)
    out = fa.flash_attention(q, k, v, lens, True, window=window)
    i = torch.arange(T)
    seen = (i[None, :] <= i[:, None]) & (i[None, :] < lens.long()[:, None, None])
    if window:
        seen = seen & (i[None, :] > i[:, None] - window)
    ke, ve = (x.repeat_interleave(H // Hkv, 1) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, ke) / math.sqrt(D)
    p = torch.softmax(s.masked_fill(~seen[:, None], -1e30), -1) * seen[:, None].any(-1, True)
    dense = torch.einsum("bhqk,bhkd->bhqd", p, ve)
    g = torch.randn_like(out)
    grads = torch.autograd.grad((out * g).sum(), (q, k, v))
    dgrads = torch.autograd.grad((dense * g).sum(), (q, k, v))
    assert close(out, dense, 1e-5)
    assert bool((out[3] == 0).all())
    for a, d in zip(grads, dgrads):
        assert a.shape == d.shape and close(a, d, 1e-5)


@pytest.mark.parametrize("hd,T,window", [(128, 300, 64), (64, 300, 37), (128, 700, 1024),
                                         (64, 700, 100), (128, 300, 0), (16, 260, 0)])
def test_walked_tiles_are_the_tiles_that_hold_a_visible_pair(hd, T, window):
    """``walked_tiles`` (what the kernels' tile counters are held to on the
    card) against a count written out: for each 128-row block, the key
    tiles (K4's and the dQ kernel's widths) holding a key that one of its
    rows sees, and for each 128-key block the 64-row query tiles holding a
    row that sees one of its keys below key_lens, causal, in the window. So
    the walks load no tile outside the window of a key they read, and miss
    none."""
    lens, H = [T, 257, 129, 1, 0], 3
    r = torch.arange(T)

    def key_tiles(valid, bn):
        n = 0
        for q0 in range(0, T, 128):
            rows = r[q0:q0 + 128, None]
            seen = (r[None] <= rows) & (r[None] < valid)
            if window:
                seen &= r[None] > rows - window
            cols = seen.any(0)
            n += sum(bool(cols[t:t + bn].any()) for t in range(0, T, bn))
        return n

    def query_tiles(valid):
        n = 0
        for k0 in range(0, min(valid, T), 128):
            keys = r[None, k0:min(k0 + 128, valid)]
            seen = keys <= r[:, None]
            if window:
                seen &= r[:, None] < keys + window
            rows = seen.any(1)
            n += sum(bool(rows[t:t + 64].any()) for t in range(0, T, 64))
        return n

    fwd_bn = 64 if hd == 128 else 128
    want = (H * sum(key_tiles(n, fwd_bn) + key_tiles(n, 64) for n in lens),
            H * sum(query_tiles(n) for n in lens))
    assert fa.walked_tiles(lens, T, H, window, hd) == want


def test_every_tokens_experts_and_output():
    """The router's top 2 of 8 and their renormalised weights, token by
    token, and each token's output as the weighted sum of its experts."""
    torch.manual_seed(1)
    moe = MoE(64, 24, 8, 2, torch.float32)
    with torch.no_grad():
        for w in moe.parameters():
            w.normal_(0, 0.2)
    x = torch.randn(3, 11, 64)
    out = moe(x)
    weights, experts = moe.route(x.reshape(-1, 64))
    for n, xt in enumerate(x.reshape(-1, 64)):
        probs = torch.softmax(xt @ moe.router.weight.t(), -1)
        top = torch.argsort(probs, descending=True)[:2]
        assert experts[n].tolist() == top.tolist()
        w = probs[top] / probs[top].sum()
        assert torch.allclose(weights[n], w, atol=1e-6)
        y = sum(wi * (torch.nn.functional.silu(xt @ moe.w_gate_up[e, :, :24])
                      * (xt @ moe.w_gate_up[e, :, 24:])) @ moe.w_down[e]
                for wi, e in zip(w, top.tolist()))
        assert torch.allclose(out.reshape(-1, 64)[n], y, atol=1e-5)


@pytest.mark.parametrize("N,k,E", [(37, 1, 8), (37, 8, 16), (1, 8, 64), (1, 1, 4)])
@pytest.mark.parametrize("gather", ["dispatch", "combine"])
def test_gather_rows_is_index_select_with_a_gathered_backward(gather, N, k, E):
    """``GatherRows`` on the expert layer's two maps, every position routed
    to k distinct experts and expert 3 to none: its forward equals
    ``index_select`` bit for bit; its backward equals ``index_select``'s
    (``index_add_``) to 1e-12 in float64, and in bf16 each sum of k terms is
    within one bf16 rounding (2^-8 relative) of the float64 sum of the same
    terms, plus the float32 partial sums' (k - 1) 2^-24 of its terms'
    magnitudes."""
    from musicstyletransfer_torch.models.moe import GatherRows

    g = torch.Generator().manual_seed(1000 * N + 10 * k + E)
    experts = torch.stack([torch.randperm(E - 1, generator=g)[:k] for _ in range(N)])
    experts += (experts >= 3).long()
    order = torch.sort(experts.reshape(-1), stable=True).indices
    back = torch.argsort(order)
    index, inverse, takes = ((order // k, back, k) if gather == "dispatch"
                             else (back, order, 1))
    x64 = torch.randn(N * k // takes, 24, dtype=torch.float64, generator=g)
    dy64 = torch.randn(N * k, 24, dtype=torch.float64, generator=g)
    for dt in (torch.float64, torch.bfloat16):
        x, dy = x64.to(dt).requires_grad_(), dy64.to(dt)
        out = GatherRows.apply(x, index, inverse, takes)
        assert out.dtype == dt and torch.equal(out, x.detach().index_select(0, index))
        (got,) = torch.autograd.grad(out, x, dy)
        assert got.dtype == dt
        old = x.detach().double().requires_grad_()
        (exact,) = torch.autograd.grad(old.index_select(0, index), old, dy.double())
        if dt == torch.float64:
            assert float((got - exact).abs().max()) <= 1e-12
        else:
            magnitudes = torch.zeros_like(exact).index_add_(0, index, dy.double().abs())
            bound = 2.0 ** -8 * exact.abs() + (takes - 1) * 2.0 ** -24 * magnitudes
            assert bool(((got.double() - exact).abs() <= bound).all())


def test_yarn_frequencies_against_the_formula():
    """Mellum2's YaRN at head dimension 128 (theta 500000, factor 16, 8192
    original positions, beta 32 / 1): the interpolated frequency below the
    correction range, the original above it, the linear ramp between, with
    the range's ends from d log(L / (2 pi beta)) / (2 log theta)."""
    hd, theta, factor, orig = 128, 500000.0, 16.0, 8192
    got = yarn_inv_freq(hd, theta, factor, orig, 32.0, 1.0).double()
    low = math.floor(hd * math.log(orig / (32 * 2 * math.pi)) / (2 * math.log(theta)))
    high = math.ceil(hd * math.log(orig / (1 * 2 * math.pi)) / (2 * math.log(theta)))
    for i in range(hd // 2):
        base = theta ** (-2 * i / hd)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want = base / factor * ramp + base * (1 - ramp)
        assert abs(float(got[i]) - want) <= 1e-6 * want
    ref, factor_ref = mref.inv_freq(json.loads((ROOT / "benchmark/configs/vae_mellum2.json")
                                               .read_text()), "full_attention")
    assert torch.allclose(got, ref.double(), rtol=1e-6) and factor_ref == 1.2772588722239782


def test_checkpoint_round_trip_of_the_new_fields(tmp_path):
    from musicstyletransfer_torch.training.checkpoint import export_inference

    model, _ = port_model(tiny_cfg(), False)
    export_inference(str(tmp_path), 3, model)
    cfg, index = tconfig.load_config(str(tmp_path / "torch" / "config.json"))
    assert index == 3 and cfg == model.config
    dc = cfg.decoder_config.transformer_config
    assert (dc.num_kv_heads, dc.head_dim, dc.sliding_window, dc.ffn, dc.norm, dc.positions,
            dc.layer_types[-1], dc.yarn_factor) == (2, 16, 8, "moe", "rmsnorm", "rope",
                                                    "full_attention", 16.0)
    model.config.save(str(tmp_path / "c.json"))
    assert tconfig.Config.load(str(tmp_path / "c.json")) == model.config
    from musicstyletransfer_torch.inference.sampler import load_inference_model

    loaded = load_inference_model(str(tmp_path), -1, torch.device("cpu"))  # params.npz
    for a, b in zip(loaded.parameters(), model.parameters()):
        assert torch.equal(a, b)


def test_prefill_and_stepwise_decode_give_the_references_logits(monkeypatch):
    """Transfer's route for this decoder: ``decode_sampled`` takes the step
    loop (K1 does not take it: a K1 call would raise here), and prefill plus
    stepwise decode through the cache of 2 K/V heads a layer, windowed,
    forced along a row of 40 tokens, gives the reference's teacher-forced
    logits at every step."""
    from musicstyletransfer_torch.inference import decode as dec

    cfg = tiny_cfg()
    model, params = port_model(cfg, False)
    model.eval()
    assert not model.k1_decodes
    monkeypatch.setattr(dec, "fused_decode", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("K1 called")))
    z = torch.randn(3, 16, generator=torch.Generator().manual_seed(2))
    classes = torch.tensor([0, 1, 1])
    seqs, _ = dec.decode_sampled(model, z, classes, 12, seed=5)
    assert seqs.shape == (3, 12)
    rows = torch.randint(3, 293, (3, 40), generator=torch.Generator().manual_seed(4))
    rows[:, 0] = 1
    _, _, logits = dec.decode_stepwise(model, z, classes, 40, 0, mode="forced",
                                       forced_tokens=rows)
    with torch.no_grad():
        want = mref.decode(params, cfg, rows[:, :-1], torch.full((3,), 40), z, classes,
                           Numerics())
    assert close(logits[:, 1:], want)


def test_cli_main_trains_two_steps_and_cli_sample_loads_it(tmp_path):
    """``cli.main`` from flags: the long recipe's encoder flags and this
    decoder's block at a small width, two steps on the corpus, then
    ``cli.sample`` on the folder it wrote."""
    from musicstyletransfer_torch.cli import main as cli_main
    from musicstyletransfer_torch.cli import sample as cli_sample

    out = tmp_path / "m"
    argv = ["--cpu", "--data", str(ROOT / "work/data/guitar_bass"), "--model-output", str(out),
            "--logdir", str(tmp_path / "log"), "--batch-size", "64", "--max-seq-len", "24",
            "--epochs", "2", "--e-rnn-hidden-dim", "32", "--e-num-heads", "4",
            "--e-n-layers", "1", "--latent-dim", "8", "--d-rnn-hidden-dim", "64",
            "--d-n-layers", "2", "--class-conditioning", "per_step", "--d-num-heads", "4",
            "--d-num-kv-heads", "2", "--d-head-dim", "16",
            "--d-layer-types", "sliding_attention,full_attention", "--d-sliding-window", "8",
            "--d-no-bias", "--d-norm", "rmsnorm", "--d-norm-scheme", "pre", "--d-ffn", "moe",
            "--d-num-experts", "8", "--d-experts-per-token", "2", "--d-expert-width", "24",
            "--d-positions", "rope", "--d-rope-theta", "500000", "--d-yarn-factor", "16",
            "--d-yarn-original-max-positions", "8192", "--d-yarn-attention-factor",
            "1.2772588722239782", "--checkpoint-frequency", "2", "--sampling-frequency",
            "1000", "--gen-health-rows", "0", "--validation-split", "0.97",
            "--num-checkpoints-not-improved", "-1"]
    cli_main.main(argv)
    cfg, _ = tconfig.load_config(str(out / "torch" / "config.json"))
    dc = cfg.decoder_config.transformer_config
    assert (dc.ffn, dc.kv_heads, dc.layer_types) == ("moe", 2, ("sliding_attention",
                                                                "full_attention"))
    lines = [json.loads(x) for x in (tmp_path / "log" / "scalars.jsonl").read_text().splitlines()]
    assert max(x.get("step", 0) for x in lines) >= 2
    assert np.isfinite([x["value"] for x in lines if "value" in x]).all()
    cli_sample.main(["--cpu", "--model-output", str(out), "--data",
                     str(ROOT / "work/data/guitar_bass"), "--out-samples",
                     str(tmp_path / "s"), "--max-seq-len", "24", "--batch-size", "8"])
    assert any((tmp_path / "s").rglob("*.mid"))

"""K1-K5's CUDA kernels against their plain PyTorch versions, and CUDA
graphs of training steps against eager steps, on a CUDA card.

Skipped where ``torch.cuda.is_available()`` is False. This file imports no
JAX, so it also runs on a machine with the card and no JAX (whose
``tests/conftest.py`` cannot be imported there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances, float32 on both sides, summed in different orders: K1 1e-3 on
logits over up to 32 dependent positions, greedy and same-seed sampled
tokens identical (bf16: 0.15 on logits, the bound of chip_smoke.py); K2 1e-5
on the context and lse (values O(1)); K3 1e-4 relative to dqkv's largest
magnitude, and finite at 1e19 cotangents; K4 and K5 as K2 and K3, on
strided [B, T, H, hd] views and with an lse cotangent. bfloat16 at head
dimension 32 or 64 takes the tensor-core kernels (K2 and K3 through the
core's entry points of the same source; K4 and K5 at 16 and 128 too), which
round P and dS to bf16
before their second products: out 3e-2, lse 1e-3, gradients 2e-2 relative
to their largest magnitude (``chip_smoke.py``'s tolerances). float32 at
head dimension 32 or 64 takes the flash tensor-core kernels too, every
operand as three bf16 pieces, and keeps the float32 tolerances; the split
that makes the pieces equals its plain version bit for bit. K1 at padded
widths and wide vocabularies takes K1's tolerances. A graph of training
steps and the same eager steps run the same kernels on the same inputs in
the same order: bit for bit; so do the LSTM-decoder VAE's graphed steps and
the GAN's graphed groups of D and G steps.
"""

import numpy as np
import pytest
import torch

from musicstyletransfer_torch.models import (
    DecoderConfig,
    EncoderConfig,
    ModelConfig,
    StyleVAE,
    TransformerConfig,
)
from musicstyletransfer_torch.ops import attention_core as ac
from musicstyletransfer_torch.ops import flash_attention as fa
from musicstyletransfer_torch.ops import fused_decode as fd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def seeded_model(norm_scheme, conditioning, device):
    tc = TransformerConfig(model_size=128, num_layers=2, num_heads=8,
                           norm_scheme=norm_scheme)
    cfg = ModelConfig(
        encoder_config=EncoderConfig(transformer_config=tc, latent_dim=32),
        decoder_config=DecoderConfig(transformer_config=tc, latent_dim=32,
                                     class_conditioning=conditioning),
        dtype="float32")
    torch.manual_seed(0)
    return StyleVAE(cfg).to(device).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("norm_scheme,conditioning", [
    ("post", "initial"), ("pre", "per_step")])
def test_kernel_matches_plain_version(cuda, norm_scheme, conditioning):
    model = seeded_model(norm_scheme, conditioning, cuda)
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.normal(size=(8, 32)), dtype=torch.float32, device=cuda)
    classes = torch.as_tensor(rng.integers(0, 2, 8), device=cuda)
    with torch.inference_mode():
        x0 = model.decode_init(z, classes).contiguous()
    forced = torch.as_tensor(rng.integers(3, 293, (8, 20)), dtype=torch.int32, device=cuda)
    launches = fd.fused_decode.launches
    _, ks, kl = fd.fused_decode(model, x0, 20, 0, mode="forced", forced_tokens=forced,
                                classes=classes)
    _, ps, pl = fd.fused_decode_reference(model, x0, 20, 0, mode="forced",
                                          forced_tokens=forced, classes=classes)
    kseq, _ = fd.fused_decode(model, x0, 20, 0, mode="greedy", classes=classes)
    pseq, _ = fd.fused_decode_reference(model, x0, 20, 0, mode="greedy", classes=classes)
    sseq, _ = fd.fused_decode(model, x0, 20, 9, classes=classes)
    rseq, _ = fd.fused_decode_reference(model, x0, 20, 9, classes=classes)
    torch.cuda.synchronize()
    assert fd.fused_decode.launches == launches + 3
    assert float((kl - pl).abs().max()) < 1e-3
    assert torch.allclose(ks, ps, rtol=1e-4)
    assert torch.equal(kseq, pseq)
    assert torch.equal(sseq, rseq)  # same Philox draws


def decoder_model(dec, latent, conditioning, dtype, device):
    """A seeded model with decoder ``dec`` (a TransformerConfig)."""
    cfg = ModelConfig(
        encoder_config=EncoderConfig(transformer_config=TransformerConfig(model_size=64),
                                     latent_dim=latent),
        decoder_config=DecoderConfig(transformer_config=dec, latent_dim=latent,
                                     class_conditioning=conditioning),
        dtype=dtype)
    torch.manual_seed(0)
    return StyleVAE(cfg).to(device).eval()


def decode_init(model, rows, latent, device, seed):
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.normal(size=(rows, latent)), dtype=torch.float32, device=device)
    classes = torch.as_tensor(rng.integers(0, 2, rows), device=device)
    with torch.inference_mode():
        return model.decode_init(z, classes).contiguous(), classes, rng


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [None, 16])
@pytest.mark.parametrize("B", [1, 3, 17])
def test_grouped_kernel_with_partly_empty_groups(cuda, B, rows, monkeypatch):
    """Row counts that leave the last group, and so its cluster's blocks,
    partly empty (the planned groups, and groups of 16 rows): float32 greedy
    and same-seed sampled tokens identical to the plain version's, forced
    logits within 1e-3, one launch a call."""
    model = seeded_model("pre", "per_step", cuda)
    x0, classes, rng = decode_init(model, B, 32, cuda, seed=B)
    forced = torch.as_tensor(rng.integers(3, 293, (B, 24)), dtype=torch.int32, device=cuda)
    if rows is not None:
        planned = fd.plan
        monkeypatch.setattr(fd, "plan", lambda *a, **k: {**planned(*a, **k), "rows": rows,
                                                         "resident": False})
    launches = fd.fused_decode.launches
    _, ks, kl = fd.fused_decode(model, x0, 24, 0, mode="forced", forced_tokens=forced,
                                classes=classes)
    kseq, _ = fd.fused_decode(model, x0, 24, 0, mode="greedy", classes=classes)
    sseq, ssc = fd.fused_decode(model, x0, 24, 4, temperature=0.8, top_k=30, top_p=0.9,
                                classes=classes)
    torch.cuda.synchronize()
    assert fd.fused_decode.launches == launches + 3
    _, ps, pl = fd.fused_decode_reference(model, x0, 24, 0, mode="forced", forced_tokens=forced,
                                          classes=classes)
    pseq, _ = fd.fused_decode_reference(model, x0, 24, 0, mode="greedy", classes=classes)
    rseq, rsc = fd.fused_decode_reference(model, x0, 24, 4, temperature=0.8, top_k=30, top_p=0.9,
                                          classes=classes)
    assert float((kl - pl).abs().max()) < 1e-3
    assert torch.allclose(ks, ps, rtol=1e-4)
    assert torch.equal(kseq, pseq)
    assert torch.equal(sseq, rseq)
    assert torch.allclose(ssc, rsc, rtol=1e-4)


@pytest.mark.gpu
def test_rows_end_at_different_positions(cuda):
    """With the EOS logit raised, sampled rows end at different positions:
    the tokens (PAD after each EOS) and scores equal the plain version's."""
    model = seeded_model("post", "initial", cuda)
    with torch.no_grad():
        model.decoder.output_layer.bias[2] += 4.0  # EOS
    x0, classes, _ = decode_init(model, 20, 32, cuda, seed=7)
    kseq, ksc = fd.fused_decode(model, x0, 40, 11, classes=classes)
    pseq, psc = fd.fused_decode_reference(model, x0, 40, 11, classes=classes)
    torch.cuda.synchronize()
    assert torch.equal(kseq, pseq)
    assert torch.allclose(ksc, psc, rtol=1e-4)
    ends = [row.index(2) for row in kseq.tolist() if 2 in row]
    assert len(set(ends)) >= 3
    for row in kseq.tolist():
        if 2 in row:
            assert set(row[row.index(2) + 1:]) <= {0}


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["wide", "long"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recipe_decoders_at_short_length(cuda, label, dtype):
    """The wide (D=512 x 2, 16 heads, pre-LN) and long (D=256 x 2, 8 heads,
    post-LN, per_step) decoders over 32 positions on 16 rows: forced logits
    within 1e-3 (float32) or 0.15 (bf16) of the plain version's; float32
    greedy tokens identical."""
    dec, latent, cond = {
        "wide": (TransformerConfig(model_size=512, num_layers=2, num_heads=16,
                                   norm_scheme="pre"), 1024, "initial"),
        "long": (TransformerConfig(model_size=256, num_layers=2, num_heads=8), 512, "per_step"),
    }[label]
    model = decoder_model(dec, latent, cond, dtype, cuda)
    x0, classes, rng = decode_init(model, 16, latent, cuda, seed=5)
    forced = torch.as_tensor(rng.integers(3, 293, (16, 32)), dtype=torch.int32, device=cuda)
    _, _, kl = fd.fused_decode(model, x0, 32, 0, mode="forced", forced_tokens=forced,
                               classes=classes)
    kseq, _ = fd.fused_decode(model, x0, 32, 0, mode="greedy", classes=classes)
    _, _, pl = fd.fused_decode_reference(model, x0, 32, 0, mode="forced", forced_tokens=forced,
                                         classes=classes)
    pseq, _ = fd.fused_decode_reference(model, x0, 32, 0, mode="greedy", classes=classes)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(kl).all())
    assert float((kl - pl).abs().max()) <= (1e-3 if dtype == "float32" else 0.15)
    if dtype == "float32":
        assert torch.equal(kseq, pseq)


def check_against_plain(model, x0, classes, rng, T, dtype):
    """Forced logits within 1e-3 (float32) or 0.15 (bf16) of the plain
    version's; float32 greedy and same-seed sampled tokens identical."""
    B = x0.shape[0]
    forced = torch.as_tensor(rng.integers(3, 293, (B, T)), dtype=torch.int32, device=x0.device)
    _, _, kl = fd.fused_decode(model, x0, T, 0, mode="forced", forced_tokens=forced,
                               classes=classes)
    kseq, _ = fd.fused_decode(model, x0, T, 0, mode="greedy", classes=classes)
    sseq, _ = fd.fused_decode(model, x0, T, 3, top_k=40, classes=classes)
    _, _, pl = fd.fused_decode_reference(model, x0, T, 0, mode="forced", forced_tokens=forced,
                                         classes=classes)
    pseq, _ = fd.fused_decode_reference(model, x0, T, 0, mode="greedy", classes=classes)
    rseq, _ = fd.fused_decode_reference(model, x0, T, 3, top_k=40, classes=classes)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(kl).all())
    assert float((kl - pl).abs().max()) <= (1e-3 if dtype == "float32" else 0.15)
    if dtype == "float32":
        assert torch.equal(kseq, pseq)
        assert torch.equal(sseq, rseq)


@pytest.mark.gpu
@pytest.mark.parametrize("D,H", [(512, 4), (96, 4), (96, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_any_head_dimension(cuda, D, H, dtype):
    """Head dimensions 128, 24 and 12 take the kernel's run-time head
    dimension (scalar cache loads, P.V in pieces of 32 dimensions); 17 rows
    over 40 positions reach attention split over key ranges too."""
    dec = TransformerConfig(model_size=D, num_layers=2, num_heads=H, norm_scheme="pre")
    model = decoder_model(dec, 32, "per_step", dtype, cuda)
    x0, classes, rng = decode_init(model, 17, 32, cuda, seed=D + H)
    check_against_plain(model, x0, classes, rng, 40, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_and_streamed_weights(cuda, dtype, resident, monkeypatch):
    """The canonical decoder (D=128 x 1, 8 heads) with every block's weight
    slices resident in shared memory, and streamed from L2, both against
    the plain version; 17 rows in groups of 4."""
    dec = TransformerConfig(model_size=128, num_layers=1, num_heads=8)
    model = decoder_model(dec, 32, "initial", dtype, cuda)
    x0, classes, rng = decode_init(model, 17, 32, cuda, seed=11)
    planned = fd.plan

    def plan(*a, **k):
        p = {**planned(*a, **k), "rows": 4, "groups": 5, "blocks": 40, "resident": resident}
        assert fd.smem_bytes(4, 8, 128, 8, 512, 293, a[7], 1, resident) <= fd._SMEM_LIMIT
        return p

    monkeypatch.setattr(fd, "plan", plan)
    check_against_plain(model, x0, classes, rng, 30, dtype)


@pytest.mark.gpu
def test_wrapper_rejects_bad_inputs(cuda):
    model = seeded_model("post", "initial", cuda)
    x0 = torch.zeros(4, 128, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fd.fused_decode(model, x0.t().contiguous().t(), 8, 0)
    with pytest.raises(ValueError, match="x0"):
        fd.fused_decode(model, x0.half(), 8, 0)
    with pytest.raises(ValueError, match="forced_tokens"):
        fd.fused_decode(model, x0, 8, 0, mode="forced",
                        forced_tokens=torch.zeros(4, 8, dtype=torch.int64, device=cuda))


def core_inputs(device, T, hd, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.as_tensor(rng.normal(size=(3, T, 2 * 3 * hd)), dtype=torch.float32, device=device)
    lens = torch.tensor([T, T // 2, 0], dtype=torch.int32, device=device)
    g = torch.as_tensor(rng.normal(size=(3, T, 2 * hd)), dtype=torch.float32, device=device)
    return qkv, lens, g


@pytest.mark.gpu
@pytest.mark.parametrize("hd,causal", [(32, True), (64, False), (16, True)])
def test_attention_core_kernels_match_plain_versions(cuda, hd, causal):
    T = 70
    qkv, lens, g = core_inputs(cuda, T, hd)
    scale = hd ** -0.5
    before = (ac.core_forward.launches, ac.core_backward.launches)
    ctx, lse = ac.core_forward(qkv, lens, 2, causal, scale)
    pctx, plse = ac.core_forward_reference(qkv, lens, 2, causal, scale)
    dq = ac.core_backward(qkv, lens, plse, pctx, g, 2, causal, scale)
    pdq = ac.core_backward_reference(qkv, lens, plse, pctx, g, 2, causal, scale)
    huge = ac.core_backward(qkv, lens, plse, pctx, torch.full_like(g, 1e19), 2, causal, scale)
    torch.cuda.synchronize()
    assert (ac.core_forward.launches, ac.core_backward.launches) == (before[0] + 1,
                                                                     before[1] + 2)
    assert float((ctx - pctx).abs().max()) < 1e-5
    valid = plse > -1e29
    assert torch.equal(lse > -1e29, valid)
    assert float((lse - plse)[valid].abs().max()) < 1e-5
    assert float((dq - pdq).abs().max()) <= 1e-4 * float(pdq.abs().max())
    assert bool(torch.isfinite(huge).all())


@pytest.mark.gpu
def test_attention_core_autograd_launches_the_kernels(cuda):
    qkv, lens, g = core_inputs(cuda, 40, 32, seed=1)
    x = qkv.bfloat16().requires_grad_()
    before = (ac.core_forward.launches, ac.core_backward.launches,
              ac.core_forward_reference.cuda_runs, ac.core_backward_reference.cuda_runs)
    (ac.attention_core(x, lens, 2, True).float() * g).sum().backward()
    torch.cuda.synchronize()
    assert (ac.core_forward.launches, ac.core_backward.launches,
            ac.core_forward_reference.cuda_runs, ac.core_backward_reference.cuda_runs) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    assert x.grad.dtype == torch.bfloat16 and bool(torch.isfinite(x.grad.float()).all())
    with pytest.raises(ValueError, match="int32"):
        ac.core_forward(qkv, lens.long(), 2, True, 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("T,hd,causal,H,lens", [
    (513, 64, False, 16, [78, 183, 331, 513, 30, 513, 513, 513]),  # the wide encoder
    (514, 32, True, 16, [79, 184, 332, 514, 31, 514, 514, 514]),  # the wide decoder
    (333, 32, False, 2, [333, 166, 1, 0]),
    (200, 64, True, 2, [200, 100, 1, 0]),
])
def test_tensor_core_attention_core_matches_plain_versions(cuda, T, hd, causal, H, lens):
    """bfloat16 K2/K3 on the tensor-core route, through autograd, against
    the plain versions on the kernel's own residuals; finite at a 1e19
    cotangent; the same bits twice; only the tensor-core counters and
    ``launches`` move."""
    rng = np.random.default_rng(T + hd)
    B = len(lens)
    qkv = torch.as_tensor(rng.normal(size=(B, T, H * 3 * hd)), dtype=torch.float32,
                          device=cuda).bfloat16()
    g = torch.as_tensor(rng.normal(size=(B, T, H * hd)), dtype=torch.float32,
                        device=cuda).bfloat16()
    key_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    scale = ac.default_scale(qkv, H)
    assert ac.core_route(qkv.dtype, hd) == "tensor-core"
    counters = lambda: (ac.core_forward.launches, ac.core_forward.tc_launches,  # noqa: E731
                        ac.core_backward.launches, ac.core_backward.tc_launches,
                        ac.core_forward_reference.cuda_runs, ac.core_backward_reference.cuda_runs)
    before = counters()
    x = qkv.clone().requires_grad_()
    out = ac.attention_core(x, key_lens, H, causal)
    out.backward(g)
    ctx, lse = ac.core_forward(qkv, key_lens, H, causal, scale)
    again = ac.core_backward(qkv, key_lens, lse, ctx, g, H, causal, scale)
    huge = ac.core_backward(qkv, key_lens, lse, ctx, torch.full_like(g, 1e19), H, causal, scale)
    torch.cuda.synchronize()
    assert counters() == (before[0] + 2, before[1] + 2, before[2] + 3, before[3] + 3,
                          before[4], before[5])
    pctx, plse = ac.core_forward_reference(qkv, key_lens, H, causal, scale)
    pd = ac.core_backward_reference(qkv, key_lens, lse, ctx, g, H, causal, scale)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), ctx) and torch.equal(x.grad, again)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert float((ctx.float() - pctx.float()).abs().max()) <= 3e-2
    valid = plse > -1e29
    assert torch.equal(lse > -1e29, valid)
    assert float((lse - plse)[valid].abs().max()) <= 1e-3
    assert bool((ctx[key_lens == 0] == 0).all())
    assert float((x.grad.float() - pd.float()).abs().max()) <= 2e-2 * float(pd.float().abs().max())
    assert bool(torch.isfinite(huge.float()).all())


@pytest.mark.gpu
def test_attention_core_routes_by_dtype_and_head_dim(cuda):
    """float32, and bfloat16 at head dimension 16, stay on the CUDA-core
    kernels; a bfloat16 qkv whose base is 8 bytes off raises."""
    for dtype, hd, tc in ((torch.float32, 64, 0), (torch.bfloat16, 16, 0), (torch.bfloat16, 32, 1)):
        qkv, lens, g = core_inputs(cuda, 40, hd, seed=3)
        qkv, g = qkv.to(dtype), g.to(dtype)
        before = (ac.core_forward.launches, ac.core_forward.tc_launches,
                  ac.core_backward.launches, ac.core_backward.tc_launches)
        ctx, lse = ac.core_forward(qkv, lens, 2, False, hd ** -0.5)
        ac.core_backward(qkv, lens, lse, ctx, g, 2, False, hd ** -0.5)
        torch.cuda.synchronize()
        assert (ac.core_forward.launches, ac.core_forward.tc_launches,
                ac.core_backward.launches, ac.core_backward.tc_launches) == (
            before[0] + 1, before[1] + tc, before[2] + 1, before[3] + tc)
    off = torch.zeros(3 * 40 * 2 * 3 * 32 + 4, dtype=torch.bfloat16, device=cuda)[4:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        ac.core_forward(off.view(3, 40, 2 * 3 * 32), lens, 2, False, 0.125)


def flash_inputs(device, T, hd, seed=0):
    """q, k, v, dO as [B, H, T, hd] views of [B, T, H, hd] tensors (the
    model's layout), key_lens [T, T//2, 1, 0] and an lse cotangent."""
    rng = np.random.default_rng(seed)

    def bthd():
        x = torch.as_tensor(rng.normal(size=(4, T, 2, hd)), dtype=torch.float32, device=device)
        return x.transpose(1, 2)

    lens = torch.tensor([T, T // 2, 1, 0], dtype=torch.int32, device=device)
    g_lse = torch.as_tensor(rng.normal(size=(4, 2, T)), dtype=torch.float32, device=device)
    return bthd(), bthd(), bthd(), bthd(), lens, g_lse


@pytest.mark.gpu
@pytest.mark.parametrize("hd,causal", [(32, True), (64, False), (16, True)])
def test_flash_kernels_match_plain_versions(cuda, hd, causal):
    q, k, v, g, lens, g_lse = flash_inputs(cuda, 70, hd)
    scale = hd ** -0.5
    before = (fa.flash_forward.launches, fa.flash_backward.launches)
    out, lse = fa.flash_forward(q, k, v, lens, causal, scale)
    pout, plse = fa.flash_forward_reference(q, k, v, lens, causal, scale)
    grads = fa.flash_backward(q, k, v, lens, plse, pout, g, causal, scale, g_lse)
    pgrads = fa.flash_backward_reference(q, k, v, lens, plse, pout, g, causal, scale, g_lse)
    huge = fa.flash_backward(q, k, v, lens, plse, pout, torch.full_like(g, 1e19), causal, scale)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_backward.launches) == (before[0] + 1,
                                                                       before[1] + 2)
    assert float((out - pout).abs().max()) < 1e-5
    valid = plse > -1e29
    assert torch.equal(lse > -1e29, valid)
    assert float((lse - plse)[valid].abs().max()) < 1e-5
    for d, pd in zip(grads, pgrads):
        assert float((d - pd).abs().max()) <= 1e-4 * float(pd.abs().max())
    assert all(bool(torch.isfinite(d).all()) for d in huge)


@pytest.mark.gpu
def test_flash_autograd_launches_the_kernels(cuda):
    q, k, v, g, lens, _ = flash_inputs(cuda, 40, 32, seed=1)
    x = [t.bfloat16().requires_grad_() for t in (q, k, v)]
    before = (fa.flash_forward.launches, fa.flash_backward.launches,
              fa.flash_forward_reference.cuda_runs, fa.flash_backward_reference.cuda_runs)
    (fa.flash_attention(*x, lens, True).float() * g).sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_backward.launches,
            fa.flash_forward_reference.cuda_runs, fa.flash_backward_reference.cuda_runs) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    for t in x:
        assert t.grad.dtype == torch.bfloat16 and bool(torch.isfinite(t.grad.float()).all())
    with pytest.raises(ValueError, match="int32"):
        fa.flash_forward(q, k, v, lens.long(), True, 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,T", [(torch.bfloat16, 70), (torch.bfloat16, 300),
                                     (torch.float32, 300)])
@pytest.mark.parametrize("hd,causal", [(32, True), (32, False), (64, True), (64, False)])
def test_tensor_core_flash_kernels_match_plain_versions(cuda, hd, causal, T, dtype):
    """bfloat16, and float32 as three bf16 pieces, at a T that no tile
    divides: the tensor-core kernels against the plain versions, with an lse
    cotangent, at 1e19 cotangents, and twice for the same bits; only the
    tensor-core counters and ``launches`` move (and, in float32, the split's:
    q, k, v for K4, and dO for K5)."""
    check_tensor_core_flash(cuda, hd, causal, T, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [70, 300])
@pytest.mark.parametrize("hd,causal", [(16, True), (16, False), (128, True), (128, False)])
def test_bf16_tensor_core_flash_kernels_at_head_dims_16_and_128(cuda, hd, causal, T):
    """The same for bfloat16 at head dimension 16 (32-byte tile rows) and
    128 (two 128-byte column blocks a row, 64-key forward tiles)."""
    check_tensor_core_flash(cuda, hd, causal, T, torch.bfloat16)


def check_tensor_core_flash(cuda, hd, causal, T, dtype):
    q, k, v, g, lens, g_lse = (x.to(dtype) if x.dtype == torch.float32 and x.dim() == 4 else x
                               for x in flash_inputs(cuda, T, hd, seed=T + hd))
    scale = hd ** -0.5
    tol_out, tol_lse, tol_rel = {torch.bfloat16: (3e-2, 1e-3, 2e-2),
                                 torch.float32: (1e-5, 1e-5, 1e-4)}[dtype]
    assert fa.kernel_route(q.dtype, hd) == "tensor-core"
    splits = fa.split_bf16x3.launches
    before = (fa.flash_forward.launches, fa.flash_forward.tc_launches,
              fa.flash_backward.launches, fa.flash_backward.tc_launches)
    out, lse = fa.flash_forward(q, k, v, lens, causal, scale)
    grads = None
    for _ in range(2):
        again = grads
        # the plain forward's residuals below, so only the backward differs
        pout, plse = fa.flash_forward_reference(q, k, v, lens, causal, scale)
        grads = fa.flash_backward(q, k, v, lens, plse, pout, g, causal, scale, g_lse)
    huge = fa.flash_backward(q, k, v, lens, plse, pout, torch.full_like(g, 1e19), causal, scale)
    plain_runs = fa.flash_backward_reference.cuda_runs
    pgrads = fa.flash_backward_reference(q, k, v, lens, plse, pout, g, causal, scale, g_lse)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_forward.tc_launches,
            fa.flash_backward.launches, fa.flash_backward.tc_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 3, before[3] + 3)
    assert fa.split_bf16x3.launches == splits + (3 + 3 * 4 if dtype == torch.float32 else 0)
    assert fa.flash_backward_reference.cuda_runs == plain_runs + 1  # the one call above
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert float((out.float() - pout.float()).abs().max()) <= tol_out
    valid = plse > -1e29
    assert torch.equal(lse > -1e29, valid)
    assert float((lse - plse)[valid].abs().max()) <= tol_lse
    assert bool((out[lens == 0] == 0).all())
    for d, pd, d2 in zip(grads, pgrads, again):
        assert d.dtype == dtype and torch.equal(d, d2)
        assert (float((d.float() - pd.float()).abs().max())
                <= tol_rel * float(pd.float().abs().max()))
    assert all(bool(torch.isfinite(d.float()).all()) for d in huge)


@pytest.mark.gpu
def test_split_kernel_equals_plain_version(cuda):
    """The split of float32 inputs on the card equals its plain version bit
    for bit (normal, tiny and 1e19 values, scaled and not, a strided view);
    one launch a call; rows that are not 16-byte aligned raise."""
    rng = np.random.default_rng(3)
    for magnitude in (1.0, 1e-30, 1e19):
        x = torch.as_tensor(rng.normal(size=(4, 333, 2, 64)) * magnitude, dtype=torch.float32,
                            device=cuda).transpose(1, 2)
        for scale in (1.0, 0.125):
            launches = fa.split_bf16x3.launches
            got = fa.split_bf16x3(x, scale)
            want = fa.split_bf16x3_reference(x, scale)
            torch.cuda.synchronize()
            assert fa.split_bf16x3.launches == launches + 1
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    odd = torch.zeros(4, 40, 2, 66, device=cuda)[..., :64].transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 4"):
        fa.split_bf16x3(odd)


@pytest.mark.gpu
def test_flash_routes_by_dtype_and_head_dim(cuda):
    """float32 at head dimension 16 and 128, and both dtypes at 8, stay on
    the CUDA-core kernels; float32 at head dimension 64 and bfloat16 at 16,
    64 and 128 launch the tensor-core kernels; a bfloat16 tensor whose rows
    do not start on 16 bytes raises."""
    for dtype, hd, tc in ((torch.float32, 64, 1), (torch.float32, 16, 0), (torch.bfloat16, 16, 1),
                          (torch.bfloat16, 64, 1), (torch.bfloat16, 128, 1),
                          (torch.float32, 128, 0), (torch.bfloat16, 8, 0), (torch.float32, 8, 0)):
        q, k, v, g, lens, _ = flash_inputs(cuda, 40, hd, seed=2)
        q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
        before = (fa.flash_forward.launches, fa.flash_forward.tc_launches,
                  fa.flash_backward.launches, fa.flash_backward.tc_launches,
                  fa.flash_forward_reference.cuda_runs, fa.flash_backward_reference.cuda_runs)
        out, lse = fa.flash_forward(q, k, v, lens, False, hd ** -0.5)
        fa.flash_backward(q, k, v, lens, lse, out, g, False, hd ** -0.5)
        torch.cuda.synchronize()
        assert (fa.flash_forward.launches, fa.flash_forward.tc_launches,
                fa.flash_backward.launches, fa.flash_backward.tc_launches,
                fa.flash_forward_reference.cuda_runs, fa.flash_backward_reference.cuda_runs) == (
            before[0] + 1, before[1] + tc, before[2] + 1, before[3] + tc, before[4], before[5])
    wide = torch.zeros(4, 40, 2, 68, dtype=torch.bfloat16, device=cuda)
    shifted = wide[..., 4:].transpose(1, 2)  # rows start 8 bytes into a 16-byte piece
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_forward(shifted, shifted, shifted, lens, False, 0.125)


@pytest.mark.gpu
def test_remat_replays_the_cuda_generator(cuda):
    """remat with dropout on the card, every layer on the flash kernels:
    the loss, every gradient and the CUDA generator's final state equal a
    run without remat (the kernels use no atomics, so exactly)."""
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(3, 293, (2, 25)), device=cuda)
    tokens[1, 18:] = 0  # PAD
    seq_lens = (tokens != 0).sum(-1)
    classes = torch.tensor([0, 1], device=cuda)
    results = []
    for remat in (False, True):
        tc = TransformerConfig(model_size=64, num_layers=2, num_heads=2, dropout=0.1,
                               use_flash_attention=True, flash_min_seq_len=16, remat=remat)
        cfg = ModelConfig(encoder_config=EncoderConfig(transformer_config=tc, latent_dim=8),
                          decoder_config=DecoderConfig(transformer_config=tc, latent_dim=8),
                          dtype="float32")
        torch.manual_seed(0)
        model = StyleVAE(cfg).to(cuda).train()
        gen = torch.Generator(device=cuda).manual_seed(3)
        launches = fa.flash_backward.launches
        logits, mu, logvar = model(tokens, seq_lens, classes, generator=gen)
        loss = logits.square().mean() + mu.square().mean() + logvar.square().mean()
        loss.backward()
        torch.cuda.synchronize()
        assert fa.flash_backward.launches == launches + 4
        results.append((loss.detach(), [p.grad for p in model.parameters()], gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("D,H,FF,V,norm_scheme", [(100, 4, 400, 293, "post"),
                                                  (128, 8, 512, 400, "pre"),
                                                  (60, 3, 240, 700, "post")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_widths_and_wide_vocabulary(cuda, D, H, FF, V, norm_scheme, dtype):
    """K1 on decoders it pads (model size 100 with heads of 25, 60 with 3
    heads, FF 400) or whose vocabulary outgrows the token choice's
    registers (400, 700): forced logits, greedy and same-seed sampled tokens
    against the plain version, and top-k/top-p samples in the support."""
    tc = TransformerConfig(model_size=D, num_heads=H, ffn_multiplier=FF // D, vocab_size=V,
                           norm_scheme=norm_scheme)
    cfg = ModelConfig(
        encoder_config=EncoderConfig(transformer_config=TransformerConfig(model_size=32),
                                     latent_dim=16, input_dim=V),
        decoder_config=DecoderConfig(transformer_config=tc, latent_dim=16, output_dim=V,
                                     class_conditioning="per_step"),
        dtype=dtype)
    torch.manual_seed(0)
    model = StyleVAE(cfg).to(cuda).eval()
    rng = np.random.default_rng(4)
    classes = torch.as_tensor(rng.integers(0, 2, 12), device=cuda)
    with torch.inference_mode():
        x0 = model.decode_init(torch.as_tensor(rng.normal(size=(12, 16)), dtype=torch.float32,
                                               device=cuda), classes).contiguous()
    check_against_plain(model, x0, classes, rng, 24, dtype)
    seqs, _ = fd.fused_decode(model, x0, 24, 5, 0.9, top_k=30, top_p=0.8, classes=classes)
    _, _, logits = fd.fused_decode(model, x0, 24, 0, mode="forced", forced_tokens=seqs,
                                   classes=classes)
    scaled = fd.filter_support(logits.reshape(-1, V) / 0.9, 30, 0.8).reshape(logits.shape)
    chosen = scaled.gather(2, seqs.long()[:, :, None])[:, 1:, 0]
    live = torch.cumsum((seqs == 2).int(), 1)[:, :-1] == 0  # up to each row's EOS
    assert bool((chosen[live] > -1e29).all())


def tiny_recipe(remat, device, core, lr=1e-3, accumulate=2):
    tc = TransformerConfig(model_size=64, num_layers=2, num_heads=2, dropout=0.1,
                           use_flash_attention=core, attention_core_min_seq_len=1, remat=remat)
    cfg = ModelConfig(encoder_config=EncoderConfig(transformer_config=tc, latent_dim=8),
                      decoder_config=DecoderConfig(transformer_config=tc, latent_dim=8),
                      dtype="float32")
    from musicstyletransfer_torch.models.vae import init_params
    from musicstyletransfer_torch.training.optimizer import Optimizer, OptimizerConfig

    model = init_params(StyleVAE(cfg), 0).to(device)
    opt = Optimizer(list(model.parameters()),
                    OptimizerConfig("adam", "clip_gradient:1.0,skip_nonfinite:3", lr),
                    accumulate_steps=accumulate)
    return model, opt


def step_batches(device, n, seed=5):
    """``n`` (tokens, seq_lens, classes, labels) batches of 4 rows, L=20."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = torch.as_tensor(rng.integers(3, 293, (4, 21)), device=device)
        tokens[:, 0] = 1
        tokens[2, 15:] = 0
        labels = torch.roll(tokens, -1, 1)
        labels[:, -1] = 0
        out.append((tokens, (tokens != 0).sum(-1), torch.as_tensor(rng.integers(0, 2, 4),
                                                                   device=device), labels))
    return out


def run_groups(model, opt, groups, graphed, device):
    """Train ``model`` on ``groups`` of batches from a seeded generator:
    each group one replay of a ``GraphedSteps`` graph of its length, or
    eager ``step_body`` calls. Returns the state tensors, the generator's
    state and the launch counts."""
    from musicstyletransfer_torch.ops import counters
    from musicstyletransfer_torch.training.graph import GraphedSteps
    from musicstyletransfer_torch.training.train_step import (LossConfig, TrainState,
                                                              metric_names, step_body)

    loss = LossConfig(kl_weight=0.5, kl_anneal_steps=4, free_bits=0.1)
    state = TrainState(metric_names(model, True), device)
    gen = torch.Generator(device=device).manual_seed(1)
    counters.reset()
    graphs = GraphedSteps(model, opt, loss, state, gen, max(map(len, groups)))
    for group in groups:
        if graphed:
            graphs.run(group)
        else:
            for t in group:
                step_body(model, opt, loss, state, *t, generator=gen)
    torch.cuda.synchronize()
    return ([opt.flat, *opt.state.values(), state.step, state.sums, state.counts],
            gen.get_state(), counters.read())


@pytest.mark.gpu
@pytest.mark.parametrize("remat,core", [(False, True), (True, True), (False, False)])
def test_graph_of_steps_equals_eager_steps(cuda, remat, core):
    """Two replays of a CUDA graph of 3 training steps against 6 eager
    ``step_body`` calls from one seeded state (dropout, the attention
    core's kernels where ``core``, remat, gradient accumulation over 2
    steps, the KL anneal): parameters, optimizer state, step count, metric
    sums and the dropout generator bit for bit; the launch counters count
    each replay's launches as the eager steps' own."""
    group = step_batches(cuda, 3)
    out = [run_groups(*tiny_recipe(remat, cuda, core), [group, group], graphed, cuda)
           for graphed in (False, True)]
    (a, ga, ca), (b, gb, cb) = out
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ga, gb) and ca == cb
    assert ca["K3"] == (6 * 4 if core else 0)


@pytest.mark.gpu
def test_graphs_of_two_lengths_interleaved(cuda):
    """The trainer's graph of a group and the graph of an epoch's shorter
    remainder share one memory pool and replay out of capture order
    (3, 2, 3): equal to the same 8 eager ``step_body`` calls bit for bit."""
    batches = step_batches(cuda, 8, seed=7)
    groups = [batches[:3], batches[3:5], batches[5:]]
    out = [run_groups(*tiny_recipe(False, cuda, True, accumulate=1), groups, graphed, cuda)
           for graphed in (False, True)]
    (a, ga, ca), (b, gb, cb) = out
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ga, gb) and ca == cb and ca["K3"] == 8 * 4


@pytest.mark.gpu
def test_lstm_vae_graph_equals_eager_steps(cuda):
    """The LSTM-decoder VAE (a 2 x 32 LSTM with dropout 0.2 between its
    layers): two replays of a graph of 3 steps against 6 eager steps, bit
    for bit (parameters, optimizer state, step, metric sums, generator)."""
    from musicstyletransfer_torch.models.config import LSTMConfig
    from musicstyletransfer_torch.models.vae import init_params
    from musicstyletransfer_torch.training.optimizer import Optimizer, OptimizerConfig

    tc = TransformerConfig(model_size=64, num_layers=2, num_heads=2, dropout=0.1)
    cfg = ModelConfig(encoder_config=EncoderConfig(transformer_config=tc, latent_dim=8),
                      decoder_config=DecoderConfig(
                          transformer_config=tc, latent_dim=8, decoder_type="lstm",
                          lstm_config=LSTMConfig(n_layers=2, hidden_dim=32, dropout=0.2)),
                      dtype="float32")
    group = step_batches(cuda, 3)
    out = []
    for graphed in (False, True):
        lstm = init_params(StyleVAE(cfg), 0).to(cuda)
        opt = Optimizer(list(lstm.parameters()), OptimizerConfig("adam", "clip_gradient:1.0", 1e-3))
        out.append(run_groups(lstm, opt, [group, group], graphed, cuda))
    (a, ga, ca), (b, gb, cb) = out
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ga, gb) and ca == cb and ca["K1"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("r1_gamma", [0.1, 0.0])
def test_gan_graphed_groups_equal_eager_steps(cuda, r1_gamma):
    """GAN groups as CUDA-graph replays (``GraphedGANGroups``: a group of 5
    from batch 0, then groups cut at batches 7 and 10, replayed out of
    capture order) against the same eager D/G steps from one seeded state:
    both models' parameters, Adam state, the metric sums and the noise
    generator bit for bit."""
    from musicstyletransfer_torch.models.config import (DiscriminatorConfig, GANConfig,
                                                        GeneratorConfig)
    from musicstyletransfer_torch.models.gan import init_gan_params
    from musicstyletransfer_torch.training.gan_trainer import (GANSteps, GANTrainConfig,
                                                               GraphedGANGroups, group_pattern)

    cfg = GANConfig(GeneratorConfig(hidden_dim=32, emb_dim=16, noise_dim=8, max_seq_len=12),
                    DiscriminatorConfig(n_layers=2, hidden_dim=32, emb_dim=16), "bfloat16")
    rng = np.random.default_rng(2)
    batches = [(torch.as_tensor(rng.integers(3, 293, (4, 12)), device=cuda),
                torch.as_tensor(rng.integers(0, 2, 4), device=cuda)) for _ in range(15)]
    bounds = [(0, 5), (5, 7), (7, 10), (10, 15)]
    out = []
    for graphed in (False, True):
        gen, disc = init_gan_params(cfg, 0)
        steps = GANSteps(cfg, GANTrainConfig(r1_gamma=r1_gamma), gen.to(cuda), disc.to(cuda),
                         torch.Generator(device=cuda).manual_seed(1))
        graphs = GraphedGANGroups(steps, 5)
        for a, b in bounds:
            pattern = group_pattern(a, b - a, 5)
            if graphed:
                graphs.run(batches[a:b], pattern)
            else:
                steps.run_group(batches[a:b], pattern)
        torch.cuda.synchronize()
        out.append([t.clone() for t in steps.tensors()] + [steps.generator.get_state()])
        assert int(steps.g_opt.state["count"]) == 3 and int(steps.d_opt.state["count"]) == 15
    assert all(torch.equal(x, y) for x, y in zip(*out))
    assert len(graphs.graphs) == 3  # (5 from 0), (2 from 5), (3 from 7); (5 from 10) replays


@pytest.mark.gpu
@pytest.mark.parametrize("graphed", [False, True])
def test_k1_follows_the_trained_weights(cuda, graphed):
    """K1 packs the decoder's weights once and reuses the pack while the
    parameters' version counters stand still. A training step (eager, or a
    graph replay, which runs no Python) writes the parameters in place:
    K1's forced logits after it agree with the plain version's on the
    trained model (1e-3) and moved away from those before it."""
    model, opt = tiny_recipe(False, cuda, True, lr=1e-2, accumulate=1)
    rng = np.random.default_rng(6)
    classes = torch.as_tensor(rng.integers(0, 2, 8), device=cuda)
    z = torch.as_tensor(rng.normal(size=(8, 8)), dtype=torch.float32, device=cuda)
    forced = torch.as_tensor(rng.integers(3, 293, (8, 16)), dtype=torch.int32, device=cuda)

    def logits(decode):
        model.eval()
        with torch.inference_mode():
            x0 = model.decode_init(z, classes).contiguous()
            out = decode(model, x0, 16, 0, mode="forced", forced_tokens=forced,
                         classes=classes)[2].clone()
        model.train()
        return out

    before = logits(fd.fused_decode)
    run_groups(model, opt, [step_batches(cuda, 1)], graphed, cuda)
    kernel, plain = logits(fd.fused_decode), logits(fd.fused_decode_reference)
    torch.cuda.synchronize()
    assert float((kernel - plain).abs().max()) <= 1e-3
    assert float((plain - before).abs().max()) > 1e-2


def serving_folder(tmp_path, dtype):
    """A model folder holding the export of a seeded decoder D=128, 8
    heads, 2 layers (K1's canonical decoder shape) for the serving entry
    points, in ``dtype``."""
    from musicstyletransfer_torch.models.vae import init_params
    from musicstyletransfer_torch.training.checkpoint import export_inference

    tc = TransformerConfig(model_size=128, num_layers=2, num_heads=8)
    cfg = ModelConfig(encoder_config=EncoderConfig(transformer_config=tc, latent_dim=32),
                      decoder_config=DecoderConfig(transformer_config=tc, latent_dim=32),
                      dtype=dtype)
    export_inference(str(tmp_path), 0, init_params(StyleVAE(cfg), 3))
    return str(tmp_path)


def serving_requests(n, seed=0):
    """n MIDI requests of 3-15 random notes."""
    from musicstyletransfer_torch.midi import smf
    from musicstyletransfer_torch.midi.codec import Melody, MelodyWriter
    from musicstyletransfer_torch.midi.vocab import note_on_id, timeshift_id

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = []
        for p in rng.integers(40, 80, rng.integers(3, 16)):
            toks += [note_on_id(int(p)), timeshift_id(120)]
        melody = Melody(tokens=np.asarray(toks, np.int32))
        out.append(smf.dump_midifile(MelodyWriter().to_midifile(melody)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_graphed_cycles_equal_eager_cycles(cuda, tmp_path, dtype, greedy):
    """The streaming engine's cycles as CUDA-graph replays (the admit and
    no-admit variants) against the same cycles run eagerly, from one seed,
    over 6 cycles with admissions on cycles 1, 3 and 5: every state tensor
    and the readout bit for bit after every cycle (sampling draws from the
    generator registered with both graphs)."""
    from musicstyletransfer_torch.inference.streaming import StreamingTransferEngine

    folder = serving_folder(tmp_path, dtype)
    reqs = serving_requests(4)
    snaps = []
    for graphed in (True, False):
        eng = StreamingTransferEngine(folder, -1, slots=8, max_seq_len=16, segment_steps=4,
                                      greedy=greedy, seed=5)
        eng.use_graphs = graphed
        eng._ensure_state()
        out, k = [], 0
        for n in (1, 0, 2, 0, 1, 0):
            eng._cycle_idx += 1
            arrivals = [(eng._tokens_from_midi(m), lambda r: None, 0.0) for m in reqs[k:k + n]]
            k += n
            eng._dispatch(eng._register(arrivals) if arrivals else None)
            torch.cuda.synchronize()
            out.append([x.cpu() for x in eng._state.tensors() + [eng._readout]])
        assert eng.graph_replays == (6 if graphed else 0)
        snaps.append(out)
    for i, (a, b) in enumerate(zip(*snaps)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"cycle {i + 1}"


@pytest.mark.gpu
def test_readout_ring_with_the_dispatcher_ahead(cuda, tmp_path):
    """The card held back before every cycle, so the dispatcher runs ahead
    of the readout copies: the ring fills (the dispatcher waits for the
    oldest copy and drops it), harvests find copies not yet landed, and
    slots are reused across harvests (4 slots, 6 requests of 2 classes).
    Every request's greedy tokens still equal those of the same engine
    serving it alone: no torn or stale row reached a result."""
    from musicstyletransfer_torch.inference.streaming import StreamingTransferEngine

    folder = serving_folder(tmp_path, "float32")
    reqs = serving_requests(6, seed=1)
    alone = StreamingTransferEngine(folder, -1, slots=4, max_seq_len=16, segment_steps=2,
                                    greedy=True)
    expected = [alone.submit_midi(m).tokens_by_class for m in reqs]
    eng = StreamingTransferEngine(folder, -1, slots=4, max_seq_len=16, segment_steps=2,
                                  greedy=True)
    got = {}
    for i, m in enumerate(reqs):
        eng.enqueue(m, lambda r, i=i: got.__setitem__(i, r))
    eng._ensure_state()
    not_landed = 0
    for _ in range(2000):
        if len(got) == len(reqs):
            break
        with torch.cuda.stream(eng._stream):
            torch.cuda._sleep(2_000_000)  # ~1 ms of the card's time
        not_landed += sum(not r.landed() for r in eng._pending)
        eng._cycle(block=False)
    torch.cuda.synchronize()
    assert len(got) == len(reqs)
    assert eng.ring_waits > 0 and not_landed > 0
    for i, r in got.items():
        assert not isinstance(r, Exception), r
        for c in (0, 1):
            np.testing.assert_array_equal(r.tokens_by_class[c], expected[i][c])


@pytest.mark.gpu
def test_service_decodes_through_k1(cuda, tmp_path):
    """A micro-batch of the service is one K1 launch over the real rows
    (requests x classes) and no plain decode loop; its sampled tokens equal
    the plain version's from the same conditioning states and seed (float32,
    shared Philox noise)."""
    from musicstyletransfer_torch.inference.decode import _encode_deterministic
    from musicstyletransfer_torch.inference.service import StyleTransferService

    svc = StyleTransferService(serving_folder(tmp_path, "float32"), -1, batch_size=8,
                               max_seq_len=16, buckets=[8, 16])
    toks = [svc._tokens_from_midi(m) for m in serving_requests(3, seed=2)]
    launches, runs = fd.fused_decode.launches, fd.fused_decode_reference.cuda_runs
    seqs = svc._dispatch(toks)
    torch.cuda.synchronize()
    assert fd.fused_decode.launches == launches + 1
    assert fd.fused_decode_reference.cuda_runs == runs
    bucket = svc._pick_bucket(toks)
    assert seqs.shape == (2, 3, 2 * (bucket + 1))
    tokens, lens = svc._make_batch(toks, bucket)
    with torch.inference_mode():
        classes = torch.arange(2, device=cuda).repeat_interleave(3)
        z = _encode_deterministic(svc.model, torch.as_tensor(tokens, device=cuda).repeat(2, 1),
                                  torch.as_tensor(lens, device=cuda).repeat(2), classes)
        x0 = svc.model.decode_init(z, classes).contiguous()
    ref, _ = fd.fused_decode_reference(svc.model, x0, 2 * (bucket + 1), (0 << 32) | 1)
    assert torch.equal(seqs.reshape(6, -1), ref)
    results = svc._finish(seqs, 3)
    assert all(set(r.midi_by_class) == {0, 1} for r in results)


@pytest.fixture
def nccl_world(cuda):
    """A world of one rank on NCCL in this process, and its (1, 1) mesh."""
    import socket

    import torch.distributed as dist

    from musicstyletransfer_torch.parallel import initialize_distributed, make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    device = torch.device("cuda", 0)
    initialize_distributed(f"127.0.0.1:{port}", 1, 0, device)
    try:
        yield make_mesh(1, device)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_graph_with_the_all_reduce_captured_equals_eager_steps(cuda, nccl_world):
    """On a world-1 NCCL mesh every step all-reduces its gradient (and the
    model and optimizer go through shard_model and FlatSync): two replays
    of a graph of 3 steps, the collective captured, against 6 eager steps,
    bit for bit; and both equal to the same steps without a mesh."""
    from musicstyletransfer_torch.parallel import shard_model, use_mesh
    from musicstyletransfer_torch.parallel.mesh import FlatSync

    group = step_batches(cuda, 3)
    out = []
    for graphed, mesh in ((False, nccl_world), (True, nccl_world), (True, None)):
        model, opt = tiny_recipe(False, cuda, True)
        if mesh is not None:
            opt.sync = FlatSync(mesh, shard_model(model, mesh), cuda)
        with use_mesh(mesh):
            out.append(run_groups(model, opt, [group, group], graphed, cuda))
    (a, ga, ca), (b, gb, cb), (c, gc, cc) = out
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))
    assert torch.equal(ga, gb) and torch.equal(ga, gc) and ca == cb == cc


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_lockstep_matches_whole_sequence_kernels(cuda, dtype, causal):
    """Ring attention with 2 ranks in lock step on the card (K4/K5 per
    visiting chunk, T=255 padded to the ring, one row's keys inside the
    first chunk) against K4/K5 on the whole T: out and lse (K4's
    tolerances), dq/dk/dv (K5's, relative to the largest magnitude)."""
    from musicstyletransfer_torch.ops import counters
    from musicstyletransfer_torch.ops import ring_attention as ra
    from musicstyletransfer_torch.parallel.mesh import SeqShard

    B, H, T, hd, n = 2, 2, 255, 32, 2
    g = np.random.default_rng(9)
    q, k, v, dout = (torch.as_tensor(g.normal(size=(B, T, H, hd)), dtype=torch.float32)
                     .to(dtype).to(cuda).transpose(1, 2) for _ in range(4))
    key_lens = torch.tensor([T, 100], dtype=torch.int32, device=cuda)
    scale = hd ** -0.5
    whole_out, whole_lse = fa.flash_forward(q, k, v, key_lens, causal, scale)
    grads = fa.flash_backward(q, k, v, key_lens, whole_lse, whole_out, dout, causal, scale)
    chunks = [[SeqShard(T, n, r).local(x, 2).contiguous() for r in range(n)]
              for x in (q, k, v, dout)]
    counters.reset()
    fwd = ra.ring_forward_lockstep(*chunks[:3], key_lens, causal, scale)
    bwd = ra.ring_backward_lockstep(*chunks[:3], key_lens, [o for o, _ in fwd],
                                    [l for _, l in fwd], chunks[3], causal, scale)
    torch.cuda.synchronize()
    c = counters.read()
    assert c["K4"] == c["K5"] == n * n and c["K4 plain"] == c["K5 plain"] == 0
    tol_out, tol_lse, tol_rel = {torch.float32: (1e-5, 1e-4, 1e-4),
                                 torch.bfloat16: (3e-2, 1e-3, 2e-2)}[dtype]
    out = torch.cat([o for o, _ in fwd], 2)[:, :, :T]
    lse = torch.cat([l for _, l in fwd], 2)[:, :, :T]
    live = whole_lse > -1e29
    assert float((out - whole_out.float()).abs().max()) <= tol_out
    assert float((lse - whole_lse)[live].abs().max()) <= tol_lse
    for j in range(3):
        d = torch.cat([b[j] for b in bwd], 2)[:, :, :T]
        assert torch.isfinite(d).all()
        rel = (d - grads[j].float()).abs().max() / grads[j].float().abs().max()
        assert float(rel) <= tol_rel, j


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_on_each_shards_rows_equals_the_whole_batch(cuda, nccl_world, dtype):
    """The split of rows into data shards on the card: K1 greedy on each
    half of 64 rows (as two data ranks would launch it) equals the launch
    on all 64 token for token, and the sharded call on a world-1 mesh
    launches K1 once and equals the unsharded decode."""
    import dataclasses

    from musicstyletransfer_torch.inference import decode, sharded_sample_sequences

    model = seeded_model("post", "initial", cuda)
    if dtype == "bfloat16":
        model = StyleVAE(dataclasses.replace(model.config, dtype=dtype)).to(cuda).eval()
    rng = np.random.default_rng(4)
    z = torch.as_tensor(rng.normal(size=(64, 32)), dtype=torch.float32, device=cuda)
    classes = torch.as_tensor(rng.integers(0, 2, 64), device=cuda)
    with torch.inference_mode():
        x0 = model.decode_init(z, classes).contiguous()
    whole, _ = fd.fused_decode(model, x0, 40, 0, mode="greedy", classes=classes)
    halves = [fd.fused_decode(model, x0[h:h + 32].contiguous(), 40, 0, mode="greedy",
                              classes=classes[h:h + 32])[0] for h in (0, 32)]
    assert torch.equal(torch.cat(halves), whole)

    tokens = torch.as_tensor(np.concatenate([np.ones((64, 1)), rng.integers(3, 293, (64, 16))],
                                            1), dtype=torch.long, device=cuda)
    seq_lens = torch.full((64,), 17, device=cuda)
    want, _ = decode.sample_sequences(model, tokens, seq_lens, classes, 40, 0, greedy=True)
    launches = fd.fused_decode.launches
    got, _ = sharded_sample_sequences(model, tokens, seq_lens, classes, 40, torch.Generator(),
                                      nccl_world, greedy=True)
    assert fd.fused_decode.launches == launches + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_k1_span_holds_the_launch_of_its_kernel(cuda):
    """``decode.k1``'s interval (``tracing``, on ``time.time_ns``) holds the
    host-side launch that the profiler correlates with ``fused_decode_kernel``:
    the program's spans and the profiler's events share one clock."""
    from torch.profiler import ProfilerActivity, profile

    from musicstyletransfer_torch import tracing
    from musicstyletransfer_torch.inference.decode import decode_sampled

    model = seeded_model("post", "initial", cuda)
    rng = np.random.default_rng(5)
    z = torch.as_tensor(rng.normal(size=(8, 32)), dtype=torch.float32, device=cuda)
    classes = torch.as_tensor(rng.integers(0, 2, 8), device=cuda)
    decode_sampled(model, z, classes, 20, 0)  # K1 built and loaded outside the trace
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_sampled(model, z, classes, 20, 1)
        torch.cuda.synchronize()
    (k1,) = [s for s in tracing.spans() if s.name == "decode.k1"]
    tracing.clear()
    events = list(prof.profiler.kineto_results.events())
    on_card = [str(e.device_type()).endswith("CUDA") for e in events]
    (kernel,) = [e for e, dev in zip(events, on_card) if dev and "fused_decode_kernel" in e.name()]
    launches = [e for e, dev in zip(events, on_card)
                if not dev and e.correlation_id() == kernel.correlation_id()]
    assert launches, "no host event correlated with the kernel"
    for e in launches:
        where = (e.name(), e.start_ns() - k1.start_ns, k1.end_ns - e.start_ns() - e.duration_ns())
        assert k1.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= k1.end_ns, where

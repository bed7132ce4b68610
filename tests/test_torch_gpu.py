"""K1, K2 and K3's CUDA kernels against their plain PyTorch versions, on a
CUDA card.

Skipped where ``torch.cuda.is_available()`` is False. This file imports no
JAX, so it also runs on a machine with the card and no JAX (whose
``tests/conftest.py`` cannot be imported there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances, float32 on both sides, summed in different orders: K1 1e-3 on
logits over up to 20 dependent positions, greedy tokens identical; K2 1e-5
on the context and lse (values O(1)); K3 1e-4 relative to dqkv's largest
magnitude, and finite at 1e19 cotangents.
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

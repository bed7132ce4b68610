"""K1's CUDA kernel against its plain PyTorch version, on a CUDA card.

Skipped where ``torch.cuda.is_available()`` is False. This file imports no
JAX, so it also runs on a machine with the card and no JAX (whose
``tests/conftest.py`` cannot be imported there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerance: float32 on both sides, summed in different orders over up to 20
dependent positions — 1e-3 on logits; greedy tokens must be identical.
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

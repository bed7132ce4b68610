"""PyTorch port, K4 / K5: flash attention's plain versions against the JAX
package's Pallas kernels (interpret mode), the resident and the streaming
ones, through ``flash_attention`` and ``flash_attention_with_lse``; the
flash route of the model against the JAX model; remat against no remat; and
``cli.main`` with ``scripts/train-vae-long.sh``'s flags (CPU).

Tolerances, float32 on both sides with the same rounding points and sums
in other orders: out and lse 1e-5 absolute (values O(1)), gradients 1e-4
relative to their largest magnitude. bfloat16: both round q*scale, p and
the outputs to bf16, but the Pallas kernel rounds p against its running
maximum and the plain version against the row's final one, so out may
differ by 2 bf16 ulps (2^-6 absolute on values below 2), the gradients by
2e-2 relative; lse stays float32 (1e-5). Model loss and gradients: 1e-4
relative. Remat against no remat: identical.

The tensor-core kernels (bfloat16 at head dimension 16, 32, 64 or 128;
float32 at 32 or 64) run only on a card; their arithmetic is emulated here
in plain PyTorch (bf16 operands, float32 sums, their rounding points and
their tiles: 128 keys a forward tile, 64 at head dimension 128) and held to
the plain versions within the tolerances ``chip_smoke.py`` uses on the card
(TOL_CTX, TOL_LSE, TOL_DQKV_REL).
"""

import dataclasses
import functools
import importlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from musicstyletransfer_tpu.models import (
    DecoderConfig,
    EncoderConfig,
    ModelConfig,
    TransformerConfig,
    init_params,
    make_model,
)
from musicstyletransfer_tpu.training import loss as jloss
from musicstyletransfer_torch.cli import main as cli_main
from musicstyletransfer_torch.cli import sample as cli_sample
from musicstyletransfer_torch.convert import params_from_jax
from musicstyletransfer_torch.data import layout_chunks
from musicstyletransfer_torch.models import StyleVAE
from musicstyletransfer_torch.models import config as tconfig
from musicstyletransfer_torch.ops import attention_core as ac
from musicstyletransfer_torch.ops import flash_attention as fa
from musicstyletransfer_torch.training import loss as tloss

# The JAX ops package exports the function under the module's name.
jfa = importlib.import_module("musicstyletransfer_tpu.ops.flash_attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# (head_dim, causal, T); B=4 with key lengths [T, T//2, 1, 0], H=2.
CASES = [(32, True, 40), (32, False, 37), (64, True, 29), (64, False, 48),
         (16, True, 35), (16, False, 26), (128, True, 31), (128, False, 42)]


def inputs(hd, T, seed, B=4, H=2):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, T, hd)).astype(np.float32) for _ in range(4))
    g_lse = rng.normal(size=(B, H, T)).astype(np.float32)
    lens = np.array([T, T // 2, 1, 0][:B], np.int32)
    return q, k, v, g, g_lse, lens


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_vjp(q, k, v, lens, causal, g, g_lse, dtype=jnp.float32):
    """(out, lse, dq, dk, dv) of the JAX package's flash_attention_with_lse
    in interpret mode, with cotangents (g, g_lse); g_lse None takes
    flash_attention."""
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    if g_lse is None:
        f = lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jnp.asarray(lens), causal,  # noqa: E731
                                                   None, True)
        out, vjp = jax.vjp(f, *args)
        lse = None
        grads = vjp(jnp.asarray(g, dtype))
    else:
        f = lambda q_, k_, v_: jfa.flash_attention_with_lse(  # noqa: E731
            q_, k_, v_, jnp.asarray(lens), causal, None, True)
        (out, lse), vjp = jax.vjp(f, *args)
        grads = vjp((jnp.asarray(g, dtype), jnp.asarray(g_lse)))
    return out, lse, *grads


def torch_grads(q, k, v, lens, causal, g, g_lse, dtype=torch.float32):
    """(out, lse, dq, dk, dv) through the port's autograd Function."""
    x = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    lens_t = torch.from_numpy(lens)
    if g_lse is None:
        out = fa.flash_attention(*x, lens_t, causal)
        lse = None
        (out.float() * torch.from_numpy(g)).sum().backward()
    else:
        out, lse = fa.flash_attention_with_lse(*x, lens_t, causal)
        ((out.float() * torch.from_numpy(g)).sum()
         + (lse * torch.from_numpy(g_lse)).sum()).backward()
    return out, lse, *(t.grad for t in x)


def as_np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("hd,causal,T", CASES)
def test_forward_matches_pallas_kernel(hd, causal, T):
    q, k, v, _, _, lens = inputs(hd, T, seed=0)
    scale = hd ** -0.5
    jout, jlse = jfa.flash_attention_with_lse(*map(jnp.asarray, (q, k, v, lens)), causal, None,
                                              True)
    out, lse = fa.flash_forward_reference(*map(torch.from_numpy, (q, k, v, lens)), causal, scale)
    assert out.shape == q.shape and lse.shape == q.shape[:3] and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6, atol=1e-5)
    assert (out[3] == 0).all() and (lse[3] <= -1e29).all()  # key_lens 0: zeros, sentinel
    # key_lens 1: every row, those past it too, attends key 0 alone
    torch.testing.assert_close(out[2], torch.from_numpy(v)[2, :, :1].expand(-1, T, -1),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("hd,causal,T", CASES)
def test_gradients_match_pallas_kernel(hd, causal, T, with_lse):
    q, k, v, g, g_lse, lens = inputs(hd, T, seed=1)
    want = jax_vjp(q, k, v, lens, causal, g, g_lse if with_lse else None)
    got = torch_grads(q, k, v, lens, causal, g, g_lse if with_lse else None)
    np.testing.assert_allclose(as_np(got[0]), as_np(want[0]), rtol=0, atol=1e-5)
    if with_lse:
        np.testing.assert_allclose(as_np(got[1]), as_np(want[1]), rtol=1e-6, atol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        assert rel_err(as_np(a), as_np(b)) <= 1e-4, name


@pytest.mark.parametrize("causal", [False, True])
def test_streaming_kernels_match(monkeypatch, causal):
    """K4b/K5b/K5c (the JAX dispatch's streaming regime, made to engage at
    T=130 with 64-wide blocks) compute the same function as the plain
    versions: out, lse and every gradient with an lse cotangent."""
    monkeypatch.setattr(jfa, "_STREAM_THRESHOLD", 128)
    monkeypatch.setattr(jfa, "_STREAM_BLOCK", 64)
    q, k, v, g, g_lse, lens = inputs(32, 130, seed=2, B=3)
    lens = np.array([130, 77, 0], np.int32)
    want = jax_vjp(q, k, v, lens, causal, g, g_lse)
    got = torch_grads(q, k, v, lens, causal, g, g_lse)
    np.testing.assert_allclose(as_np(got[0]), as_np(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(as_np(got[1]), as_np(want[1]), rtol=1e-6, atol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        assert rel_err(as_np(a), as_np(b)) <= 1e-4, name


@pytest.mark.parametrize("hd,causal", [(32, True), (64, False)])
def test_bfloat16_rounding_points(hd, causal):
    """In bf16 the plain version rounds where the Pallas kernel does: q by
    the scale rounded to bf16 (at hd=32 not the dense route's division by
    bf16(sqrt(32))), p before P.V, the outputs."""
    q, k, v, g, g_lse, lens = inputs(hd, 33, seed=3)
    want = jax_vjp(q, k, v, lens, causal, g, g_lse, jnp.bfloat16)
    got = torch_grads(q, k, v, lens, causal, g, g_lse, torch.bfloat16)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert all(x.dtype == torch.bfloat16 for x in got[2:])
    np.testing.assert_allclose(as_np(got[0]), as_np(want[0]), rtol=0, atol=2 ** -6)
    np.testing.assert_allclose(as_np(got[1]), as_np(want[1]), rtol=1e-6, atol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        assert rel_err(as_np(a), as_np(b)) <= 2e-2, name
    if hd == 32:  # the two bf16 scalings differ here
        qb = torch.from_numpy(q).bfloat16()
        flash = qb * torch.tensor(hd ** -0.5, dtype=torch.bfloat16)
        dense = qb / torch.sqrt(torch.tensor(float(hd), dtype=torch.bfloat16))
        assert not torch.equal(flash, dense)


def test_backward_finite_at_extreme_cotangents():
    q, k, v, _, _, lens = inputs(32, 24, seed=4)
    scale = 32 ** -0.5
    t = [torch.from_numpy(x) for x in (q, k, v, lens)]
    out, lse = fa.flash_forward_reference(*t, True, scale)
    grads = fa.flash_backward_reference(*t, lse, out, torch.full_like(out, 1e19), True, scale)
    assert all(bool(torch.isfinite(x).all()) for x in grads)


def test_cpu_tensors_take_the_plain_versions():
    before = (fa.flash_forward.launches, fa.flash_backward.launches,
              fa.flash_forward_reference.cuda_runs, fa.flash_backward_reference.cuda_runs)
    q, k, v, g, g_lse, lens = inputs(32, 16, seed=5)
    torch_grads(q, k, v, lens, True, g, g_lse)
    assert before == (fa.flash_forward.launches, fa.flash_backward.launches,
                      fa.flash_forward_reference.cuda_runs, fa.flash_backward_reference.cuda_runs)


@pytest.mark.parametrize("bad,match", [
    (lambda q, l: (q.double(), l), "float32 or bfloat16"),
    (lambda q, l: (q[..., :12], l), "head_dim 12"),
    (lambda q, l: (q, l.long()), "int32"),
    (lambda q, l: (q.transpose(2, 3)[..., :16, :], l), "contiguous last"),
])
def test_kernel_input_checks(bad, match):
    q, _, _, _, _, lens = inputs(32, 16, seed=6)
    q, lens = bad(torch.from_numpy(q), torch.from_numpy(lens))
    with pytest.raises(ValueError, match=match):
        fa._check(q, q, q, lens)


# ----------------------------------------------------------------------------
# The tensor-core kernels' arithmetic, emulated, and the wrapper's dispatch

BF16_TOL_CTX = chip_smoke.TOL_CTX[torch.bfloat16]
BF16_TOL_LSE = chip_smoke.TOL_LSE[torch.bfloat16]
BF16_TOL_DQKV = chip_smoke.TOL_DQKV_REL[torch.bfloat16]


def rb(x):
    """Round to bf16, back in float32: an operand of a tensor-core product."""
    return x.bfloat16().float()


def tc_forward_emulation(q, k, v, lens, causal, scale, tile):
    """The tensor-core forward: q * scale rounded to bf16 (the scale rounded
    first), key tiles of ``tile`` with an online softmax in float32, a
    masked p selected to zero, p rounded to bf16 before P.V against the
    running maximum, out = acc / max(l, 1e-30), lse = m + log l."""
    B, H, T, D = q.shape
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    mask = ac._mask(lens, T, causal).expand(B, H, T, T)
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros(B, H, T)
    acc = torch.zeros(B, H, T, D)
    for k0 in range(0, T, tile):
        ok = mask[..., k0:k0 + tile]
        s = torch.where(ok, torch.einsum("bhqd,bhkd->bhqk", qs, k[:, :, k0:k0 + tile].float()),
                        -1e30)
        mt = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mt)
        p = torch.where(ok, torch.exp(s - mt[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", rb(p),
                                                    v[:, :, k0:k0 + tile].float())
        m = mt
    lm = l.clamp_min(1e-30)
    return (acc / lm[..., None]).to(q.dtype), m + torch.log(lm)


def tc_backward_emulation(q, k, v, lens, lse, out, g, causal, scale, g_lse=None):
    """The tensor-core backward: S from the raw bf16 q with a float32 sum,
    scaled afterwards in float32; P and dS in float32, masked terms selected
    away; P (for dv) and dS (for dq, dk) rounded to bf16 before the second
    products; dq and dk scaled at the end."""
    T = q.shape[2]
    qf, kf, vf, do = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = ac._mask(lens, T, causal) & (lse[..., None] > -1e29)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = (do * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = rb(torch.where(mask, p * (dp - delta[..., None]), 0.0))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", rb(p), do)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def bf16_inputs(hd, T, seed):
    """bf16 q, k, v, dO, a float32 lse cotangent and ragged key lengths
    [T, T // 2, 1, 0]."""
    q, k, v, g, g_lse, lens = inputs(hd, T, seed)
    return (*(torch.from_numpy(x).bfloat16() for x in (q, k, v, g)), torch.from_numpy(g_lse),
            torch.from_numpy(lens))


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("hd,causal", [(32, True), (32, False), (64, True), (64, False),
                                       (16, True), (16, False), (128, True), (128, False)])
def test_tensor_core_forward_arithmetic(hd, causal, tile):
    """Tiles of 64 and 128 keys over T=150 (a ragged last tile, a causal row
    of key length 1, a row with no key): within TOL_CTX and TOL_LSE. The
    kernels take 128-key tiles, and 64-key ones at head dimension 128."""
    q, k, v, _, _, lens = bf16_inputs(hd, 150, seed=7)
    scale = hd ** -0.5
    out, lse = tc_forward_emulation(q, k, v, lens, causal, scale, tile)
    pout, plse = fa.flash_forward_reference(q, k, v, lens, causal, scale)
    assert torch.equal(lse <= -1e29, plse <= -1e29)
    assert (out[3] == 0).all()
    live = plse > -1e29
    assert float((out.float() - pout.float()).abs().max()) <= BF16_TOL_CTX
    assert float((lse - plse)[live].abs().max()) <= BF16_TOL_LSE


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("hd,causal", [(32, True), (32, False), (64, True), (64, False),
                                       (16, True), (16, False), (128, True), (128, False)])
def test_tensor_core_backward_arithmetic(hd, causal, with_lse):
    """bf16 P and dS before the second products, S scaled after the product,
    dK scaled at the end: within TOL_DQKV_REL of the plain version."""
    q, k, v, g, g_lse, lens = bf16_inputs(hd, 150, seed=8)
    scale = hd ** -0.5
    out, lse = fa.flash_forward_reference(q, k, v, lens, causal, scale)
    gl = g_lse if with_lse else None
    got = tc_backward_emulation(q, k, v, lens, lse, out, g, causal, scale, gl)
    want = fa.flash_backward_reference(q, k, v, lens, lse, out, g, causal, scale, gl)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        assert rel_err(as_np(a), as_np(b)) <= BF16_TOL_DQKV, name
    assert all((x[3] == 0).all() for x in got)  # key_lens 0: no gradient


@pytest.mark.parametrize("hd,causal", [(32, True), (64, False), (16, True), (128, False)])
def test_tensor_core_backward_finite_at_extreme_cotangents(hd, causal):
    q, k, v, g, _, lens = bf16_inputs(hd, 150, seed=9)
    scale = hd ** -0.5
    out, lse = fa.flash_forward_reference(q, k, v, lens, causal, scale)
    big = torch.full_like(g, 1e19)
    got = tc_backward_emulation(q, k, v, lens, lse, out, big, causal, scale)
    want = fa.flash_backward_reference(q, k, v, lens, lse, out, big, causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a.float()).all()), name
        assert rel_err(as_np(a), as_np(b)) <= BF16_TOL_DQKV, name


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 32, "tensor-core"), (torch.bfloat16, 64, "tensor-core"),
    (torch.bfloat16, 8, "cuda-core"), (torch.bfloat16, 16, "tensor-core"),
    (torch.bfloat16, 128, "tensor-core"),
    (torch.float32, 32, "tensor-core"), (torch.float32, 64, "tensor-core"),
    (torch.float32, 16, "cuda-core"), (torch.float32, 128, "cuda-core"),
    (torch.float32, 8, "cuda-core"),
])
def test_kernel_route(dtype, hd, route):
    """The wrapper chooses the kernels by dtype and head dimension alone:
    the tensor cores take bfloat16 at head dimension 16, 32, 64 or 128 and
    float32 at 32 or 64; head dimension 8, and float32 at 16 and 128, stay
    on the CUDA cores."""
    assert fa.kernel_route(dtype, hd) == route
    q = torch.zeros(2, 2, 16, hd, dtype=dtype)
    assert fa._check(q, q, q, torch.zeros(2, dtype=torch.int32))[4] == route
    source, prefix = fa._SOURCES[route]
    assert os.path.exists(os.path.join(REPO, "musicstyletransfer_torch", "ops", "csrc",
                                       source + ".cu"))
    assert prefix == {"tensor-core": "mst_flash_tc", "cuda-core": "mst_flash"}[route]


def test_kernel_route_rejects_other_types():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.kernel_route(torch.float16, 64)
    with pytest.raises(ValueError, match="head_dim 48"):
        fa.kernel_route(torch.bfloat16, 48)


def test_tensor_core_layout_checks():
    """The model's layouts pass ([B, H, T, hd] views of separate [B, T, D]
    projections, of a fused [B, T, 3D] one, and of an interleaved
    [B, T, H, 3, hd] one); rows that do not start on 16 bytes raise, through
    ``_check`` too. float32 tensors take the same rule in bytes: a row stride
    of 36 elements (144 bytes) passes, one of 34 raises."""
    B, T, H, hd = 2, 16, 2, 32
    lens = torch.zeros(B, dtype=torch.int32)
    sep = torch.zeros(B, T, H, hd, dtype=torch.bfloat16).transpose(1, 2)
    fused = torch.zeros(B, T, 3 * H * hd, dtype=torch.bfloat16)
    k_fused = fused[..., H * hd:2 * H * hd].reshape(B, T, H, hd).transpose(1, 2)
    inter = torch.zeros(B, T, H, 3, hd, dtype=torch.bfloat16)[:, :, :, 1].transpose(1, 2)
    fa.check_tc_layout(q=sep, k=k_fused, v=inter)
    assert fa._check(sep, k_fused, inter, lens)[4] == "tensor-core"
    shifted = torch.zeros(B, T, H, hd + 4, dtype=torch.bfloat16)[..., 4:].transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.check_tc_layout(q=shifted)  # base address 8 bytes in, row stride 36 elements
    odd = torch.zeros(B, T, H, hd + 4, dtype=torch.bfloat16)[..., :hd].transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.check_tc_layout(k=odd)  # aligned base, row stride 36 elements
    with pytest.raises(ValueError, match="k: the tensor-core"):
        fa._check(sep, odd, sep, lens)
    assert fa._check(odd.float(), odd.float(), odd.float(), lens)[4] == "tensor-core"
    f32 = torch.zeros(B, T, H, hd + 4)[..., :hd].transpose(1, 2)
    fa.check_tc_layout(q=f32)
    assert fa._check(f32, f32, f32, lens)[4] == "tensor-core"
    f32_odd = torch.zeros(B, T, H, hd + 2)[..., :hd].transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 4"):
        fa._check(f32_odd, f32_odd, f32_odd, lens)


def test_counters_of_the_tensor_core_route():
    """``tc_launches`` exist beside ``launches`` and stay put on the CPU."""
    before = fa.flash_forward.tc_launches, fa.flash_backward.tc_launches
    q, k, v, g, g_lse, lens = bf16_inputs(32, 16, seed=10)
    out, lse = fa.flash_forward(q, k, v, lens, True, 32 ** -0.5)
    fa.flash_backward(q, k, v, lens, lse, out, g, True, 32 ** -0.5, g_lse)
    assert before == (fa.flash_forward.tc_launches, fa.flash_backward.tc_launches)
    assert all(isinstance(x, int) for x in before)


# ----------------------------------------------------------------------------
# The model's flash route against the JAX model


def flash_config(dropout=0.0, remat=False, sizes=(64, 32), heads=2):
    """Post-LN, per_step, the long recipe's ring flags; flash from T=16;
    encoder and decoder widths ``sizes``, ``heads`` heads each."""
    def tc(size, layers):
        return TransformerConfig(model_size=size, num_layers=layers, num_heads=heads,
                                 dropout=dropout, vocab_size=293, use_flash_attention=True,
                                 flash_min_seq_len=16, ring_attention=True,
                                 sequence_sharding=True, remat=remat)

    return ModelConfig(
        encoder_config=EncoderConfig(transformer_config=tc(sizes[0], 2), latent_dim=16),
        decoder_config=DecoderConfig(transformer_config=tc(sizes[1], 1), latent_dim=16,
                                     class_conditioning="per_step"),
        dtype="float32")


def batch(seed, B=3, L=24):
    rng = np.random.default_rng(seed)
    chunks = np.zeros((B, L), np.int32)
    for b, n in enumerate(rng.integers(3, L + 1, B)):
        chunks[b, :n] = rng.integers(3, 293, n)
    tokens, seq_lens, labels = layout_chunks(chunks)
    classes = rng.integers(0, 2, B).astype(np.int32)
    eps = rng.normal(size=(B, 16)).astype(np.float32)
    return tokens, seq_lens, classes, labels, eps


def torch_model(cfg, jparams=None):
    model = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(cfg)))
    if jparams is not None:
        model.load_state_dict(params_from_jax(jparams))
    return model


def test_flash_route_model_matches_jax(monkeypatch):
    """vae_loss and every parameter gradient of a StyleVAE whose every
    attention takes the flash route (T=25 and 26 >= 16), against the JAX
    model running its Pallas flash kernels in interpret mode."""
    check_flash_route_model(monkeypatch, flash_config())


@pytest.mark.parametrize("hd,sizes,heads", [(16, (64, 64), 4), (128, (256, 256), 2)])
def test_flash_route_model_matches_jax_at_head_dim(monkeypatch, hd, sizes, heads):
    """The same at the head dimensions that the tensor-core kernels take
    since the bf16 tiles of 32- and 256-byte rows: every attention of the
    model at head dimension 16 (model size 64, 4 heads) or 128 (model size
    256, 2 heads)."""
    shapes = check_flash_route_model(monkeypatch, flash_config(sizes=sizes, heads=heads))
    assert {s[3] for s in shapes} == {hd}


def check_flash_route_model(monkeypatch, cfg):
    """vae_loss and the parameter gradients of the port's model of ``cfg``
    against the JAX model's (1e-4 relative); returns the shapes of q that
    the flash forward took."""
    jmodel = make_model(cfg)
    jparams = init_params(jmodel, jax.random.key(0), max_seq_len=24)
    tokens, seq_lens, classes, labels, eps = batch(1)

    def loss(params):
        mu, logvar = jmodel.apply({"params": params}, tokens, classes, False,
                                  method=lambda m, t, c, tr: m.encoder(t, c, tr))
        z = mu + eps * jnp.exp(0.5 * logvar)
        logits = jmodel.apply({"params": params}, tokens, seq_lens, z, classes, False,
                              method=lambda m, *a: m.decoder(*a))
        return jloss.vae_loss(logits, labels, mu, logvar, 0.5, free_bits=0.1)[0]

    jtotal, jgrads = jax.value_and_grad(loss)(jparams)
    model = torch_model(cfg, jparams).train()
    runs = fa.flash_forward_reference.cuda_runs, fa.flash_backward_reference.cuda_runs
    calls = []
    real = fa.flash_forward

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(fa, "flash_forward", counting)
    logits, mu, logvar = model(*(torch.as_tensor(x).long() for x in (tokens, seq_lens, classes)),
                               eps=torch.from_numpy(eps))
    total, _ = tloss.vae_loss(logits, torch.as_tensor(labels).long(), mu, logvar, 0.5,
                              free_bits=0.1)
    total.backward()
    assert [s[2] for s in calls] == [25, 25, 26]  # 2 encoder layers, 1 decoder layer
    assert runs == (fa.flash_forward_reference.cuda_runs, fa.flash_backward_reference.cuda_runs)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-4)
    want = params_from_jax(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(got)
    for name, g in want.items():
        scale = max(float(g.abs().max()), 1.0)
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    return calls


def test_remat_equals_no_remat_with_dropout():
    """remat with dropout 0.1: the same loss, every gradient and the
    generator's final state as without it, exactly."""
    tokens, seq_lens, classes, labels, _ = batch(2)
    results = []
    for remat in (False, True):
        model = torch_model(flash_config(dropout=0.1, remat=remat))
        torch.manual_seed(0)
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.2)
        model.train()
        gen = torch.Generator().manual_seed(5)
        t = [torch.as_tensor(x).long() for x in (tokens, seq_lens, classes)]
        logits, mu, logvar = model(*t, generator=gen)
        total, _ = tloss.vae_loss(logits, torch.as_tensor(labels).long(), mu, logvar, 0.5)
        total.backward()
        results.append((total.detach(), {n: p.grad for n, p in model.named_parameters()},
                        gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


# ----------------------------------------------------------------------------
# cli.main with the long recipe's flags, at tiny widths


def test_cli_runs_the_long_recipe(tmp_path, monkeypatch):
    """train-vae-long.sh's flags (--ring-attention --tp 1, per_step, free
    bits, the anneal, clip_gradient and skip_nonfinite:10) at tiny widths
    and L=30, with flash engaged from T=16: one epoch (16 steps) trains,
    validates, checkpoints and exports a config that cli.sample loads."""
    corpus = tmp_path / "corpus"  # two files: 18 batches of 4 at L=30
    for cls, name in [("bass", "Unforgiven_3_Bass.mid"), ("guitar", "Creeping_Death_3_Guitar-5.mid")]:
        os.makedirs(corpus / cls)
        shutil.copy(os.path.join(CORPUS, cls, name), corpus / cls / name)
    model = str(tmp_path / "long")
    argv = chip_smoke.recipe_argv("train-vae-long.sh", str(corpus), model, str(tmp_path / "out"))
    for flag in ("--ring-attention", "--use-flash-attention", "--free-bits"):
        assert flag in argv
    assert argv[argv.index("--class-conditioning") + 1] == "per_step"
    assert argv[argv.index("--tp") + 1] == "1"
    monkeypatch.setattr(cli_main, "TransformerConfig",
                        functools.partial(tconfig.TransformerConfig, flash_min_seq_len=16))
    calls = {"flash": 0, "core": 0}
    for name, fn, mod in (("flash", "flash_forward", fa), ("core", "core_forward", ac)):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _r=real, _n=name: calls.__setitem__(
            _n, calls[_n] + 1) or _r(*a))
    # Validation reads the same two files (a 0.1 split of one melody a class
    # is empty).
    cli_main.main(["--cpu", *argv, "--max-seq-len", "30", "--batch-size", "4",
                   "--e-rnn-hidden-dim", "32", "--e-num-heads", "2", "--latent-dim", "8",
                   "--d-rnn-hidden-dim", "16", "--epochs", "1", "--checkpoint-frequency", "8",
                   "--validation-data", str(corpus), "--logdir", model + "-log",
                   "--log-every", "1", "--gen-health-rows", "2", "--dtype", "float32"])
    assert calls["flash"] > 0 and calls["core"] == 0
    with open(os.path.join(model, "torch", "config.json")) as f:
        tc = json.load(f)["model_config"]["encoder_config"]["transformer_config"]
    assert tc["ring_attention"] and tc["sequence_sharding"] and tc["flash_min_seq_len"] == 16
    with open(os.path.join(model + "-log", "scalars.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    train = [x for x in lines if "grad_norm" in x]
    assert train and all(np.isfinite(x["total_loss"]) for x in train)
    assert [x["nonfinite_updates_skipped"] for x in lines
            if "nonfinite_updates_skipped" in x][-1] == 0
    cli_sample.main(["--cpu", "--model-output", model, "--checkpoint", "-1", "--data",
                     str(corpus), "--out-samples", str(tmp_path / "samples"),
                     "--batch-size", "32", "--max-seq-len", "30"])
    assert os.listdir(tmp_path / "samples")

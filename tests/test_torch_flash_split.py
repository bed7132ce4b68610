"""PyTorch port, K4 / K5 on the tensor cores in float32: the split of float32
operands into three bf16 pieces, and the arithmetic of the six-product
kernels, emulated in plain PyTorch and held against the JAX package's
float32 flash attention (its Pallas kernels in interpret mode).

The tensor-core kernels take a float32 operand x as hi = bf16(x), mid =
bf16(x - hi), lo = bf16(x - hi - mid), and a float32 product A B as the six
bf16 products lo hi, hi lo, mid mid, mid hi, hi mid, hi hi summed in float32
(``csrc/flash_attention_tc.cu``). Tolerances, as the float32 plain versions
are held to the Pallas kernels (``test_torch_flash_attention.py``): out and
lse 1e-5 absolute (values O(1)), gradients 1e-4 relative to their largest
magnitude. One bf16 pass (every operand rounded to bf16 once, as the bf16
kernels do) misses the 1e-5 on out by orders of magnitude: the split is
what meets it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicstyletransfer_torch.ops import attention_core as ac
from musicstyletransfer_torch.ops import flash_attention as fa

jfa = importlib.import_module("musicstyletransfer_tpu.ops.flash_attention")

# (piece of A, piece of B) of each product, smallest first (0 hi, 1 mid, 2 lo)
PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
TILE = 128  # keys a tile of the float32 forward


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------------
# The split


@pytest.mark.parametrize("magnitude", [1.0, 1e-20, 1e19])
@pytest.mark.parametrize("scale", [1.0, 0.125, 32 ** -0.5])
def test_split_reconstructs_float32_exactly(magnitude, scale):
    """hi + mid + lo == x * scale (the product rounded to float32) bit for
    bit, over normal, tiny and 1e19 values, on a strided [B, H, T, D] view;
    hi is the bf16 rounding of the product and mid, lo the rest."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2, 300, 2, 64)) * magnitude,
                        dtype=torch.float32).transpose(1, 2)
    p = fa.split_bf16x3_reference(x, scale)
    y = x * torch.tensor(scale, dtype=torch.float32)
    assert p.shape == (3, *x.shape) and p.dtype == torch.bfloat16 and p.is_contiguous()
    assert torch.equal((p[0].float() + p[1].float()) + p[2].float(), y)
    assert torch.equal(p[0], y.to(torch.bfloat16))
    assert bool((p[1].float().abs() <= p[0].float().abs() * 2 ** -8).all())
    assert bool((p[2].float().abs() <= p[1].float().abs() * 2 ** -8).all())


def test_split_below_the_normal_range_of_the_lo_piece():
    """Below |x| ~ 2^-110 the lo piece is a bf16 subnormal (spacing 2^-133),
    so hi + mid + lo is off x by at most half that spacing, an absolute
    2^-134; above it the split is exact (the test above)."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(2, 2, 300, 64)) * np.array([1e-33, 1e-28])[:, None,
                                                                                   None, None],
                        dtype=torch.float32)
    p = fa.split_bf16x3_reference(x)
    err = ((p[0].float() + p[1].float()) + p[2].float() - x).abs()
    assert float(err.max()) <= 2.0 ** -134
    big = x.abs() >= 2.0 ** -100
    assert bool(big.any()) and float(err[big].max()) == 0.0


def test_split_wrapper_takes_the_plain_version_on_the_cpu():
    """``split_bf16x3`` on a CPU tensor is the plain version and counts no
    launch."""
    x = torch.randn(2, 2, 16, 32)
    before = fa.split_bf16x3.launches, fa.split_bf16x3_reference.cuda_runs
    assert torch.equal(fa.split_bf16x3(x, 0.25), fa.split_bf16x3_reference(x, 0.25))
    assert (fa.split_bf16x3.launches, fa.split_bf16x3_reference.cuda_runs) == before


# ----------------------------------------------------------------------------
# The six-product arithmetic against the JAX package's float32 kernels


def pieces(x, scale=1.0):
    """The three bf16 pieces of x * scale as float32 values: [3, ...]."""
    return fa.split_bf16x3_reference(x, scale).float()


def one_pass(x, scale=1.0):
    """x * scale rounded to bf16 once, as [1, ...]: the bf16 kernels' operand."""
    return (x * torch.tensor(scale, dtype=torch.float32)).bfloat16().float()[None]


def products(eq, a, b):
    """The float32 sum of the bf16 products of einsum ``eq`` over the pieces
    a, b (six for three pieces, smallest first; one for one)."""
    pairs = PAIRS if a.shape[0] == 3 else ((0, 0),)
    out = None
    for i, j in pairs:
        t = torch.einsum(eq, a[i], b[j])
        out = t if out is None else out + t
    return out


def tc_forward(q, k, v, lens, causal, scale, split=pieces):
    """The tensor-core forward on float32 inputs: q * scale (rounded to
    float32) split, key tiles of 128 with an online softmax in float32, a
    masked p selected to zero, p split before P.V, out = acc / max(l,
    1e-30), lse = m + log l."""
    B, H, T, D = q.shape
    qp, kp, vp = split(q, scale), split(k), split(v)
    mask = ac._mask(lens, T, causal).expand(B, H, T, T)
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros(B, H, T)
    acc = torch.zeros(B, H, T, D)
    for k0 in range(0, T, TILE):
        ok = mask[..., k0:k0 + TILE]
        s = torch.where(ok, products("bhqd,bhkd->bhqk", qp, kp[..., k0:k0 + TILE, :]), -1e30)
        mt = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mt)
        p = torch.where(ok, torch.exp(s - mt[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + products("bhqk,bhkd->bhqd", split(p),
                                                vp[..., k0:k0 + TILE, :])
        m = mt
    lm = l.clamp_min(1e-30)
    return acc / lm[..., None], m + torch.log(lm)


def tc_backward(q, k, v, lens, lse, out, g, g_lse, causal, scale, split=pieces):
    """The tensor-core backward on float32 inputs: S from the pieces of q *
    scale and of k, dP from those of dO and v; P = exp(S - lse) and dS = P
    (dP - delta) in float32 with delta = rowsum(dO * O) - g_lse, masked terms
    selected away; P and dS split before the second products; dq scaled at
    the end, dk from the scaled q."""
    T = q.shape[2]
    qp, kp, vp, gp = split(q, scale), split(k), split(v), split(g)
    mask = ac._mask(lens, T, causal) & (lse[..., None] > -1e29)
    s = products("bhqd,bhkd->bhqk", qp, kp)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = (g * out).sum(-1) - g_lse
    dp = products("bhqd,bhkd->bhqk", gp, vp)
    ds = torch.where(mask, p * (dp - delta[..., None]), 0.0)
    dq = products("bhqk,bhkd->bhqd", split(ds), kp) * torch.tensor(scale, dtype=torch.float32)
    dk = products("bhkq,bhqd->bhkd", split(ds.transpose(-1, -2)), qp)
    dv = products("bhkq,bhqd->bhkd", split(p.transpose(-1, -2)), gp)
    return dq, dk, dv


def inputs(hd, T, seed, B=4, H=2):
    """Seeded float32 q, k, v, dO [B, H, T, hd], an lse cotangent and key
    lengths [T, T // 2, 1, 0] (a row that sees no key)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, T, hd)).astype(np.float32) for _ in range(4))
    g_lse = rng.normal(size=(B, H, T)).astype(np.float32)
    lens = np.array([T, T // 2, 1, 0][:B], np.int32)
    return q, k, v, g, g_lse, lens


def jax_reference(q, k, v, lens, causal, g, g_lse):
    """(out, lse, dq, dk, dv) of the JAX package's float32
    flash_attention_with_lse, its Pallas kernels in interpret mode."""
    f = lambda q_, k_, v_: jfa.flash_attention_with_lse(  # noqa: E731
        q_, k_, v_, jnp.asarray(lens), causal, None, True)
    (out, lse), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    return [np.asarray(x) for x in (out, lse, *grads)]


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def jax_cases():
    """The JAX reference of each (hd, causal) at T=300, computed once."""
    cache = {}

    def get(hd, causal):
        if (hd, causal) not in cache:
            q, k, v, g, g_lse, lens = inputs(hd, 300, seed=hd + causal)
            cache[hd, causal] = ((q, k, v, g, g_lse, lens),
                                 jax_reference(q, k, v, lens, causal, g, g_lse))
        return cache[hd, causal]
    return get


@pytest.mark.parametrize("hd,causal", [(32, False), (32, True), (64, False), (64, True)])
def test_six_products_match_the_pallas_kernels(jax_cases, hd, causal):
    """T=300 (a ragged last key tile), key lengths [T, T/2, 1, 0]: the
    emulated float32 tensor-core forward within 1e-5 of the Pallas kernel's
    out and lse, its backward (with an lse cotangent) within 1e-4 of the
    largest gradient; the key-length-0 row gives zeros, the sentinel and no
    gradient."""
    (q, k, v, g, g_lse, lens), (jout, jlse, *jgrads) = jax_cases(hd, causal)
    t = [torch.from_numpy(x) for x in (q, k, v, g, g_lse, lens)]
    q_, k_, v_, g_, gl_, lens_ = t
    scale = hd ** -0.5
    out, lse = tc_forward(q_, k_, v_, lens_, causal, scale)
    live = jlse > -1e29
    np.testing.assert_array_equal(lse.numpy() > -1e29, live)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy()[live], jlse[live], rtol=0, atol=1e-5)
    assert bool((out[3] == 0).all())
    grads = tc_backward(q_, k_, v_, lens_, lse, out, g_, gl_, causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        assert rel_err(a.numpy(), b) <= 1e-4, name
        assert bool((a[3] == 0).all()), name


@pytest.mark.parametrize("hd,causal", [(32, True), (64, False)])
def test_one_bf16_pass_misses_the_float32_tolerance(jax_cases, hd, causal):
    """The same arithmetic with every operand rounded to bf16 once (the bf16
    kernels' operands) is off the Pallas kernel's float32 out by more than
    1e-5, and its gradients by more than 1e-4 of the largest: three pieces,
    not one, are what meet the float32 tolerances."""
    (q, k, v, g, g_lse, lens), (jout, jlse, *jgrads) = jax_cases(hd, causal)
    q_, k_, v_, g_, gl_, lens_ = (torch.from_numpy(x) for x in (q, k, v, g, g_lse, lens))
    scale = hd ** -0.5
    out, lse = tc_forward(q_, k_, v_, lens_, causal, scale, split=one_pass)
    assert float(np.abs(out.numpy() - jout).max()) > 1e-4
    grads = tc_backward(q_, k_, v_, lens_, torch.tensor(jlse), torch.tensor(jout), g_, gl_,
                        causal, scale, split=one_pass)
    assert max(rel_err(a.numpy(), b) for a, b in zip(grads, jgrads)) > 1e-3

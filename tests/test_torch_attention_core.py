"""PyTorch port, K2 / K3: the attention core's plain versions against the JAX
package's Pallas kernels (interpret mode) and its XLA backward, the
autograd binding, and the model-level dispatch (CPU, float32).

Tolerances: float32 on both sides, the same rounding points, sums in other
orders: 1e-5 absolute on the context and lse (values O(1)), 1e-4 relative
(to the largest magnitude) on dqkv. Inputs come from numpy seeds; B=2,
T <= 40, H in {2, 4}, hd in {8, 16}, ragged key lengths including 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicstyletransfer_tpu.ops import attention_core as jac
from musicstyletransfer_torch.models.config import TransformerConfig
from musicstyletransfer_torch.models.transformer import MultiHeadSelfAttention, TransformerStack
from musicstyletransfer_torch.ops import attention_core as ac


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CASES = [(2, 8, 40, False), (2, 16, 33, True), (4, 8, 21, True), (4, 16, 40, False)]


def inputs(H, hd, T, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(2, T, H * 3 * hd)).astype(np.float32)
    lens = np.array([T - 3, 0], np.int32)
    g = rng.normal(size=(2, T, H * hd)).astype(np.float32)
    return qkv, lens, g


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("H,hd,T,causal", CASES)
def test_forward_matches_pallas_kernel(H, hd, T, causal):
    qkv, lens, _ = inputs(H, hd, T)
    scale = 1.0 / np.sqrt(hd)
    jctx, jlse = jac._core_forward(jnp.asarray(qkv), jnp.asarray(lens), H, causal, scale, True)
    ctx, lse = ac.core_forward_reference(torch.from_numpy(qkv), torch.from_numpy(lens), H,
                                         causal, scale)
    assert ctx.shape == (2, T, H * hd) and lse.shape == (2, H, T, 1)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6, atol=1e-5)
    assert (ctx[1] == 0).all() and (lse[1] <= -1e29).all()  # key_lens 0: zeros, sentinel


@pytest.mark.parametrize("H,hd,T,causal", CASES)
def test_backward_matches_pallas_kernel_and_xla_backward(H, hd, T, causal):
    qkv, lens, g = inputs(H, hd, T, seed=1)
    scale = 1.0 / np.sqrt(hd)
    jq, jl = jnp.asarray(qkv), jnp.asarray(lens)
    jctx, jlse = jac._core_forward(jq, jl, H, causal, scale, True)
    jd = jac._core_backward(jq, jl, jlse, jctx, jnp.asarray(g), H, causal, scale, True)
    jx = jac._core_xla_backward(jq, jl, jlse, jctx, jnp.asarray(g), H, causal, scale)
    args = (torch.from_numpy(qkv), torch.from_numpy(lens), torch.from_numpy(np.array(jlse)),
            torch.from_numpy(np.array(jctx)), torch.from_numpy(g), H, causal, scale)
    assert rel_err(ac.core_backward_reference(*args), jd) <= 1e-4
    assert rel_err(ac.core_xla_backward(*args), jx) <= 1e-4


@pytest.mark.parametrize("xla_backward", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_gradient_is_the_backward(causal, xla_backward):
    """attention_core's gradient is core_backward_reference (or the XLA
    twin) on the forward's own residuals, exactly."""
    H, hd, T = 2, 16, 24
    qkv, lens, g = inputs(H, hd, T, seed=2)
    x = torch.from_numpy(qkv).requires_grad_()
    lens_t = torch.from_numpy(lens)
    out = ac.attention_core(x, lens_t, H, causal, xla_backward=xla_backward)
    (out * torch.from_numpy(g)).sum().backward()
    ctx, lse = ac.core_forward_reference(x.detach(), lens_t, H, causal, 1 / np.sqrt(hd))
    want = ac.core_backward_reference(x.detach(), lens_t, lse, ctx, torch.from_numpy(g), H,
                                      causal, 1 / np.sqrt(hd))
    torch.testing.assert_close(out.detach(), ctx, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


def test_backward_finite_at_extreme_cotangents():
    """1e19 cotangents (the wide config's spike regime): finite dqkv, equal
    to the JAX package's XLA backward there."""
    H, hd, T = 2, 16, 33
    qkv, lens, _ = inputs(H, hd, T, seed=3)
    lens = np.array([33, 20], np.int32)
    g = np.full((2, T, H * hd), 1e19, np.float32)
    scale = 1.0 / np.sqrt(hd)
    ctx, lse = ac.core_forward_reference(torch.from_numpy(qkv), torch.from_numpy(lens), H,
                                         True, scale)
    d = ac.core_backward_reference(torch.from_numpy(qkv), torch.from_numpy(lens), lse, ctx,
                                   torch.from_numpy(g), H, True, scale)
    assert torch.isfinite(d).all()
    jx = jac._core_xla_backward(jnp.asarray(qkv), jnp.asarray(lens), jnp.asarray(lse.numpy()),
                                jnp.asarray(ctx.numpy()), jnp.asarray(g), H, True, scale)
    assert rel_err(d, jx) <= 1e-4


def test_bfloat16_rounding_points():
    """In bfloat16 the plain version rounds where the Pallas kernel does
    (q*scale, p, the output): equal to it to one bf16 ulp (2^-8 relative
    of values O(1)); lse stays float32."""
    H, hd, T = 2, 16, 30
    qkv, lens, _ = inputs(H, hd, T, seed=4)
    scale = 1.0 / np.sqrt(hd)
    jctx, jlse = jac._core_forward(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(lens), H, True,
                                   scale, True)
    ctx, lse = ac.core_forward_reference(torch.from_numpy(qkv).bfloat16(),
                                         torch.from_numpy(lens), H, True, scale)
    assert ctx.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(ctx.float().numpy(), np.asarray(jctx, np.float32), atol=1e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6, atol=1e-5)


def test_interleave_qkv_weights_matches_jax():
    rng = np.random.default_rng(5)
    D, H, hd = 12, 3, 4
    ws = [rng.normal(size=s).astype(np.float32)
          for s in [(D, H * hd), (H * hd,)] * 3]
    jw, jb = jac.interleave_qkv_weights(*map(jnp.asarray, ws), H, hd)
    w, b = ac.interleave_qkv_weights(*map(torch.from_numpy, ws), H, hd)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions and count no kernel
    launch and no plain run on CUDA."""
    before = (ac.core_forward.launches, ac.core_backward.launches,
              ac.core_forward_reference.cuda_runs, ac.core_backward_reference.cuda_runs,
              ac.core_xla_backward.cuda_runs)
    qkv, lens, g = inputs(2, 8, 16, seed=6)
    x = torch.from_numpy(qkv).requires_grad_()
    ac.attention_core(x, torch.from_numpy(lens), 2, True).sum().backward()
    after = (ac.core_forward.launches, ac.core_backward.launches,
             ac.core_forward_reference.cuda_runs, ac.core_backward_reference.cuda_runs,
             ac.core_xla_backward.cuda_runs)
    assert after == before


@pytest.mark.parametrize("bad,match", [
    (lambda q, l: (q.double(), l), "float32 or bfloat16"),
    (lambda q, l: (q[:, :, :-1], l), "contiguous|multiple"),
    (lambda q, l: (q, l.long()), "int32"),
    (lambda q, l: (torch.zeros(2, 5, 2 * 3 * 12), l), "head_dim 12"),
])
def test_kernel_input_checks(bad, match):
    qkv, lens, _ = inputs(2, 16, 5)
    q, l = bad(torch.from_numpy(qkv), torch.from_numpy(lens))
    with pytest.raises(ValueError, match=match):
        ac._check(q, l, 2)


class TestDispatch:
    def test_core_window(self):
        c = TransformerConfig(model_size=32, num_heads=4, use_flash_attention=True,
                              attention_core_min_seq_len=8, flash_min_seq_len=64)
        attn = MultiHeadSelfAttention(32, 4, True, torch.float32, c)
        assert [attn._core_eligible(t) for t in (7, 8, 63, 64)] == [False, True, True, False]
        off = MultiHeadSelfAttention(32, 4, True, torch.float32,
                                     TransformerConfig(model_size=32, num_heads=4))
        assert not off._core_eligible(300)  # use_flash_attention off: dense
        wide = TransformerConfig(model_size=32, num_heads=4, use_flash_attention=True,
                                 flash_min_seq_len=4096)
        assert not MultiHeadSelfAttention(32, 4, True, torch.float32, wide)._core_eligible(1025)

    def test_flash_route_raises(self):
        c = TransformerConfig(model_size=32, num_heads=4, use_flash_attention=True,
                              attention_core_min_seq_len=0, flash_min_seq_len=16)
        stack = TransformerStack(c, causal=True, dtype=torch.float32)
        x = torch.zeros(1, 16, 32)
        with pytest.raises(NotImplementedError, match="K4/K5"):
            stack(x, torch.ones(1, 16, dtype=torch.bool))

    @pytest.mark.parametrize("field", ["remat", "ring_attention", "sequence_sharding"])
    def test_unported_options_raise(self, field):
        c = TransformerConfig(model_size=32, num_heads=4, **{field: True})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TransformerStack(c, causal=False, dtype=torch.float32)

    @pytest.mark.parametrize("xla_backward", [False, True])
    def test_core_route_equals_dense_route(self, xla_backward):
        """The stack with the core engaged equals the dense route, forward
        and every parameter gradient (valid rows; float32 sum order)."""
        def stack(core_min):
            c = TransformerConfig(model_size=32, num_layers=2, num_heads=4,
                                  use_flash_attention=True, attention_core_min_seq_len=core_min,
                                  attention_core_xla_backward=xla_backward, norm_scheme="pre")
            torch.manual_seed(0)
            return TransformerStack(c, causal=True, dtype=torch.float32)

        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.normal(size=(3, 24, 32)).astype(np.float32))
        mask = torch.arange(24)[None, :] < torch.tensor([[24], [13], [7]])
        outs = []
        for m in (stack(0), stack(1)):
            out = m(x, mask)
            (torch.where(mask[..., None], out, 0.0) ** 2).sum().backward()
            outs.append((out.detach() * mask[..., None],
                         {n: p.grad for n, p in m.named_parameters()}))
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-5)
        for n, g in outs[0][1].items():
            scale = max(float(g.abs().max()), 1.0)
            torch.testing.assert_close(outs[1][1][n], g, rtol=1e-4, atol=1e-5 * scale)

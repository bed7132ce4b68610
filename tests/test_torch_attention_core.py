"""PyTorch port, K2 / K3: the attention core's plain versions against the JAX
package's Pallas kernels (interpret mode) and its XLA backward, the
autograd binding, the choice of kernels (``core_route``), the core's layout
read as the strided heads of the tensor-core flash kernels, and the
model-level dispatch (CPU).

Tolerances: float32 on both sides, the same rounding points, sums in other
orders: 1e-5 absolute on the context and lse (values O(1)), 1e-4 relative
(to the largest magnitude) on dqkv. Inputs come from numpy seeds; B=2,
T <= 40, H in {2, 4}, hd in {8, 16}, ragged key lengths including 0; the
tensor-core route at hd 32 and 64, T <= 150, key lengths 1 and 0 among them.
Its bf16 arithmetic runs only on a card: here it is emulated in plain
PyTorch (``test_torch_flash_attention``'s emulations, on the core's views)
and held to the plain versions within ``chip_smoke.py``'s bf16 tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from musicstyletransfer_tpu.ops import attention_core as jac
from musicstyletransfer_torch.models.config import TransformerConfig
from musicstyletransfer_torch.models.transformer import MultiHeadSelfAttention, TransformerStack
from musicstyletransfer_torch.ops import attention_core as ac
from musicstyletransfer_torch.ops import flash_attention as fa
from test_torch_flash_attention import tc_backward_emulation, tc_forward_emulation


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


# ----------------------------------------------------------------------------
# The choice of kernels, and the core's layout as the tensor-core route reads it


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 32, "tensor-core"), (torch.bfloat16, 64, "tensor-core"),
    (torch.bfloat16, 8, "cuda-core"), (torch.bfloat16, 16, "cuda-core"),
    (torch.bfloat16, 128, "cuda-core"),
    (torch.float32, 32, "cuda-core"), (torch.float32, 64, "cuda-core"),
])
def test_core_route(dtype, hd, route):
    """The wrappers choose the kernels by dtype and head dimension alone,
    and the flash wrappers by the same table."""
    assert ac.core_route(dtype, hd) == route == fa.kernel_route(dtype, hd)
    qkv = torch.zeros(2, 16, 2 * 3 * hd, dtype=dtype)
    assert ac._check(qkv, torch.zeros(2, dtype=torch.int32), 2)[4] == route
    assert ac._SOURCES[route] == {"tensor-core": ("flash_attention_tc", "mst_core_tc"),
                                  "cuda-core": ("attention_core", "mst_core")}[route]


def test_core_route_rejects_other_types():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ac.core_route(torch.float16, 64)
    with pytest.raises(ValueError, match="head_dim 48"):
        ac.core_route(torch.bfloat16, 48)


@pytest.mark.parametrize("hd", [32, 64])
def test_core_views_pass_the_tensor_core_layout_check(hd):
    """At the model's widths (H=16) the views of qkv, and of a dqkv and a
    context buffer, are [B, H, T, hd] views without a copy whose rows the
    tensor-core kernels take; a qkv whose base is 8 bytes off raises."""
    B, T, H = 2, 24, 16
    qkv = torch.zeros(B, T, H * 3 * hd, dtype=torch.bfloat16)
    q, k, v = ac.head_views(qkv, H)
    assert q.shape == k.shape == v.shape == (B, H, T, hd)
    assert [x.data_ptr() - qkv.data_ptr() for x in (q, k, v)] == [0, 2 * hd, 4 * hd]
    assert q.stride() == (T * H * 3 * hd, 3 * hd, H * 3 * hd, 1)
    ctx = torch.zeros(B, T, H * hd, dtype=torch.bfloat16).reshape(B, T, H, hd).transpose(1, 2)
    fa.check_tc_layout(q=q, k=k, v=v, ctx=ctx, **dict(zip(("dq", "dk", "dv"), ac.head_views(
        torch.empty_like(qkv), H))))
    ac.check_tc_rows(qkv=qkv)
    assert ac._check(qkv, torch.zeros(B, dtype=torch.int32), H)[4] == "tensor-core"
    off = torch.zeros(B * T * H * 3 * hd + 4, dtype=torch.bfloat16)[4:].view(B, T, H * 3 * hd)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.check_tc_layout(q=ac.head_views(off, H)[0])
    with pytest.raises(ValueError, match="qkv: the tensor-core route needs a 16-byte aligned"):
        ac._check(off, torch.zeros(B, dtype=torch.int32), H)
    assert ac._check(off.float(), torch.zeros(B, dtype=torch.int32), H)[4] == "cuda-core"


def core_through_flash_references(qkv, lens, H, causal, scale, g):
    """The core's function computed by the flash plain versions on the
    strided views of ``qkv``: (ctx [B, T, H*hd], lse [B, H, T, 1], dqkv
    reassembled from dq, dk and dv written into the views of one buffer)."""
    B, T, _ = qkv.shape
    q, k, v = ac.head_views(qkv, H)
    out, lse = fa.flash_forward_reference(q, k, v, lens, causal, scale)
    ctx = out.transpose(1, 2).reshape(B, T, -1)
    g_view = g.reshape(B, T, H, -1).transpose(1, 2)
    dqkv = torch.empty_like(qkv)
    for d, view in zip(fa.flash_backward_reference(q, k, v, lens, lse, out, g_view, causal, scale),
                       ac.head_views(dqkv, H)):
        view.copy_(d)
    return ctx, lse[..., None], dqkv


@pytest.mark.parametrize("lens_of", [lambda T: [T, 1], lambda T: [T // 2, 0]])
@pytest.mark.parametrize("hd,causal,T", [(32, False, 150), (32, True, 97), (64, False, 130),
                                         (64, True, 150)])
def test_flash_references_on_the_core_views_compute_the_core(hd, causal, T, lens_of):
    """The tensor-core route's reading of the core (strided heads of qkv,
    ctx as [B, T, H, hd], dqkv as three strided outputs) computes K2/K3's
    function: the flash plain versions on the views against the core's plain
    versions and the JAX package's Pallas kernels, float32."""
    H = 2
    qkv, _, g = inputs(H, hd, T, seed=T + hd)
    lens = np.array(lens_of(T), np.int32)
    scale = 1.0 / np.sqrt(hd)
    x, kl, gt = torch.from_numpy(qkv), torch.from_numpy(lens), torch.from_numpy(g)
    ctx, lse, dqkv = core_through_flash_references(x, kl, H, causal, scale, gt)
    pctx, plse = ac.core_forward_reference(x, kl, H, causal, scale)
    torch.testing.assert_close(ctx, pctx, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-6, atol=1e-5)
    assert rel_err(dqkv, ac.core_backward_reference(x, kl, plse, pctx, gt, H, causal, scale)) <= 1e-4
    jq, jl = jnp.asarray(qkv), jnp.asarray(lens)
    jctx, jlse = jac._core_forward(jq, jl, H, causal, scale, True)
    jd = jac._core_backward(jq, jl, jlse, jctx, jnp.asarray(g), H, causal, scale, True)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6, atol=1e-5)
    assert rel_err(dqkv, jd) <= 1e-4
    for b in np.flatnonzero(lens == 0):  # a row with no key: zeros, the sentinel, no gradient
        assert (ctx[b] == 0).all() and (lse[b] <= -1e29).all() and (dqkv[b] == 0).all()


BF16_TOL_CTX = chip_smoke.TOL_CTX[torch.bfloat16]
BF16_TOL_LSE = chip_smoke.TOL_LSE[torch.bfloat16]
BF16_TOL_DQKV = chip_smoke.TOL_DQKV_REL[torch.bfloat16]


@pytest.mark.parametrize("hd,causal", [(32, True), (32, False), (64, True), (64, False)])
def test_tensor_core_arithmetic_through_the_core_layout(hd, causal):
    """The tensor-core kernels' bf16 arithmetic (emulated) on the core's
    views, reassembled into ctx, lse and dqkv, against the core's plain
    versions within chip_smoke's bf16 tolerances, and finite at 1e19
    cotangents; key lengths [T, T/2, 1, 0], T=150."""
    H, T = 2, 150
    rng = np.random.default_rng(hd + causal)
    qkv = torch.from_numpy(rng.normal(size=(4, T, H * 3 * hd)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(4, T, H * hd)).astype(np.float32)).bfloat16()
    lens = torch.tensor([T, T // 2, 1, 0], dtype=torch.int32)
    scale = 1.0 / np.sqrt(hd)
    q, k, v = ac.head_views(qkv, H)
    out, lse = tc_forward_emulation(q, k, v, lens, causal, scale, 128)
    ctx = out.transpose(1, 2).reshape(4, T, -1)
    pctx, plse = ac.core_forward_reference(qkv, lens, H, causal, scale)
    live = plse > -1e29
    assert torch.equal(lse[..., None] > -1e29, live) and (ctx[3] == 0).all()
    assert float((ctx.float() - pctx.float()).abs().max()) <= BF16_TOL_CTX
    assert float((lse[..., None] - plse)[live].abs().max()) <= BF16_TOL_LSE
    for cot in (g, torch.full_like(g, 1e19)):
        dqkv = torch.empty_like(qkv)
        grads = tc_backward_emulation(q, k, v, lens, plse[..., 0],
                                      pctx.reshape(4, T, H, hd).transpose(1, 2),
                                      cot.reshape(4, T, H, hd).transpose(1, 2), causal, scale)
        for d, view in zip(grads, ac.head_views(dqkv, H)):
            view.copy_(d)
        want = ac.core_backward_reference(qkv, lens, plse, pctx, cot, H, causal, scale)
        assert dqkv.dtype == torch.bfloat16 and bool(torch.isfinite(dqkv.float()).all())
        assert rel_err(dqkv.float(), want.float()) <= BF16_TOL_DQKV
        assert (dqkv[3] == 0).all()


def test_tensor_core_counters_stay_put_on_the_cpu():
    """``tc_launches`` exist beside ``launches`` and do not move on the CPU,
    where bfloat16 at head dimension 32 takes the plain versions."""
    before = (ac.core_forward.launches, ac.core_forward.tc_launches,
              ac.core_backward.launches, ac.core_backward.tc_launches)
    assert all(isinstance(n, int) for n in before)
    qkv, lens, g = inputs(2, 32, 20, seed=11)
    x = torch.from_numpy(qkv).bfloat16().requires_grad_()
    (ac.attention_core(x, torch.from_numpy(lens), 2, True).float() * torch.from_numpy(g)).sum().backward()
    assert before == (ac.core_forward.launches, ac.core_forward.tc_launches,
                      ac.core_backward.launches, ac.core_backward.tc_launches)


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

    def test_ring_attention_keeps_the_core_out(self):
        """As the JAX package's _core_eligible: a ring config keeps its own
        route, so at 256 <= T < 1024 on one device it runs dense attention."""
        c = TransformerConfig(model_size=32, num_heads=4, use_flash_attention=True,
                              attention_core_min_seq_len=8, flash_min_seq_len=64,
                              ring_attention=True)
        attn = MultiHeadSelfAttention(32, 4, True, torch.float32, c)
        assert [attn._core_eligible(t) for t in (7, 8, 63, 64)] == [False] * 4

    def test_flash_route_runs(self, monkeypatch):
        """At T >= flash_min_seq_len the stack takes the flash route: one
        flash forward a layer, the result equal to the dense route's."""
        from musicstyletransfer_torch.ops import flash_attention as fa

        def stack(flash_min):
            c = TransformerConfig(model_size=32, num_layers=2, num_heads=4,
                                  use_flash_attention=flash_min is not None,
                                  attention_core_min_seq_len=0,
                                  flash_min_seq_len=flash_min or 1024)
            torch.manual_seed(0)
            return TransformerStack(c, causal=True, dtype=torch.float32)

        rng = np.random.default_rng(8)
        x = torch.from_numpy(rng.normal(size=(2, 16, 32)).astype(np.float32))
        mask = torch.arange(16)[None, :] < torch.tensor([[16], [9]])
        ref = stack(None)(x, mask)
        calls = []
        real = fa.flash_forward
        monkeypatch.setattr(fa, "flash_forward", lambda *a: calls.append(1) or real(*a))
        out = stack(16)(x, mask)
        assert len(calls) == 2
        torch.testing.assert_close(out * mask[..., None], ref * mask[..., None], rtol=0,
                                   atol=1e-5)

    @pytest.mark.parametrize("field", ["remat", "ring_attention", "sequence_sharding"])
    def test_single_device_options_run(self, field):
        """Each option is accepted and, on one device, gives the output and
        gradients of the stack without it (remat in training mode, with
        dropout drawn from a generator)."""
        def run(on):
            c = TransformerConfig(model_size=32, num_layers=2, num_heads=4, dropout=0.1,
                                  use_flash_attention=True, attention_core_min_seq_len=8,
                                  flash_min_seq_len=20, **{field: on})
            torch.manual_seed(0)
            stack = TransformerStack(c, causal=False, dtype=torch.float32).train()
            rng = np.random.default_rng(9)
            out = []
            for T in (12, 24):  # below and at flash_min_seq_len
                x = torch.from_numpy(rng.normal(size=(2, T, 32)).astype(np.float32))
                mask = torch.arange(T)[None, :] < torch.tensor([[T], [T - 5]])
                y = stack(x, mask, torch.Generator().manual_seed(T))
                (y ** 2).sum().backward()
                out.append(y.detach())
            return out, [p.grad for p in stack.parameters()]

        # Under ring_attention T=12 runs dense attention instead of the
        # core: equal up to float32 sums in another order.
        (y0, g0), (y1, g1) = run(False), run(True)
        for a, b in zip(y0 + g0, y1 + g1):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)

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

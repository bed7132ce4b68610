"""PyTorch port, K1: ``musicstyletransfer_torch.ops.fused_decode``.

On the CPU the wrapper runs its plain version, ``fused_decode_reference``;
these tests hold that against the JAX package on the same weights and
inputs: its Pallas kernel in interpret mode (forced and greedy, post-LN as
the Pallas kernel supports) and its XLA loop (pre-LN and per-step
conditioning, which the Pallas kernel does not take). Tolerances: float32
on both sides, so only the order of float32 summation differs — 1e-4 on
logits and relative 1e-4 on summed scores.

The CUDA kernel itself is compared with the plain version on the card by
chip_smoke.py and by tests/test_torch_gpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from musicstyletransfer_tpu.inference.decode import _filter_logits as jax_filter_logits
from musicstyletransfer_tpu.inference.decode import decode_sampled as jax_decode_sampled
from musicstyletransfer_tpu.midi.vocab import EOS_ID, PAD_ID, SOS_ID
from musicstyletransfer_tpu.models import (
    DecoderConfig,
    EncoderConfig,
    ModelConfig,
    TransformerConfig,
    init_params,
    make_model,
)
from musicstyletransfer_tpu.models.vae import StyleVAE as JaxStyleVAE
from musicstyletransfer_tpu.ops.fused_decode import filter_support as jax_filter_support
from musicstyletransfer_tpu.ops.fused_decode import fused_decode as jax_fused_decode
from musicstyletransfer_torch.convert import params_from_jax
from musicstyletransfer_torch.inference.decode import _filter_logits
from musicstyletransfer_torch.models import StyleVAE
from musicstyletransfer_torch.models import config as tconfig
from musicstyletransfer_torch.ops import _build
from musicstyletransfer_torch.ops import fused_decode as fd


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; torch's default of one
    thread per core oversubscribes it, and its spin-waiting threads then
    slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_config(d=128, layers=1, heads=8, vocab=293, norm_scheme="post",
                class_conditioning="initial", dtype="float32"):
    """tests/test_fused_decode.py's fused_config, with the norm and
    conditioning options."""
    tc = TransformerConfig(model_size=d, dropout=0.0, num_layers=layers,
                           num_heads=heads, vocab_size=vocab, norm_scheme=norm_scheme)
    return ModelConfig(
        encoder_config=EncoderConfig(transformer_config=tc, latent_dim=32,
                                     num_classes=2, input_dim=vocab),
        decoder_config=DecoderConfig(transformer_config=tc, latent_dim=32,
                                     num_classes=2, output_dim=vocab,
                                     class_conditioning=class_conditioning),
        dtype=dtype)


def both_models(cfg, seed=0):
    jm = make_model(cfg)
    jp = init_params(jm, jax.random.key(seed), max_seq_len=8)
    tm = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(cfg)))
    tm.load_state_dict(params_from_jax(traverse_util.flatten_dict(jax.device_get(jp), sep="/")))
    return jm, jp, tm.eval()


def latents(B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 32)).astype(np.float32),
            rng.integers(0, 2, (B,)).astype(np.int32))


def torch_x0(tm, z, classes):
    with torch.no_grad():
        return tm.decode_init(torch.as_tensor(z), torch.as_tensor(classes).long()).contiguous()


def jax_forced_logits(jm, jp, z, classes, forced, T):
    """Teacher-forced logits through the JAX flax decode_step loop."""
    cache = jm.apply({"params": jp}, z, classes, T + 1, method=JaxStyleVAE.decode_prefill)
    last = jnp.full((z.shape[0],), SOS_ID, jnp.int32)
    out = []
    for t in range(1, T):
        lg, cache = jm.apply({"params": jp}, last, cache, jnp.asarray(t), classes,
                             method=JaxStyleVAE.decode_step)
        out.append(lg)
        last = forced[:, t]
    return np.asarray(jnp.stack(out, axis=1))


@pytest.fixture(scope="module")
def canonical():
    """The canonical decoder shape (D=128, H=8, NL=1, V=293), float32."""
    cfg = make_config()
    jm, jp, tm = both_models(cfg)
    z, classes = latents(4)
    return cfg, jm, jp, tm, z, classes


class TestAgainstPallasInterpret:
    def test_forced_logits(self, canonical):
        cfg, jm, jp, tm, z, classes = canonical
        T = 12
        forced = np.random.default_rng(1).integers(3, 293, (4, T)).astype(np.int32)
        x0 = jm.apply({"params": jp}, jnp.asarray(z), jnp.asarray(classes),
                      method=JaxStyleVAE.decode_init)
        _, jscores, jlogits = jax_fused_decode(
            cfg, jp, x0, T, jnp.asarray(0), mode="forced",
            forced_tokens=jnp.asarray(forced), interpret=True)
        tx0 = torch_x0(tm, z, classes)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(x0), atol=1e-5)
        _, tscores, tlogits = fd.fused_decode_reference(
            tm, tx0, T, 0, mode="forced", forced_tokens=torch.as_tensor(forced))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4)
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=1e-4)

    def test_greedy_tokens_and_scores(self, canonical):
        cfg, jm, jp, tm, z, classes = canonical
        T = 16
        x0 = jm.apply({"params": jp}, jnp.asarray(z), jnp.asarray(classes),
                      method=JaxStyleVAE.decode_init)
        jseqs, jscores = jax_fused_decode(cfg, jp, x0, T, jnp.asarray(0), mode="greedy",
                                          interpret=True)
        tseqs, tscores = fd.fused_decode(tm, torch_x0(tm, z, classes), T, 0, mode="greedy")
        np.testing.assert_array_equal(tseqs.numpy(), np.asarray(jseqs))
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=1e-4, atol=1e-4)

    def test_eos_pads_tail_and_stops_scoring(self, canonical):
        """A head biased to EOS ends every row at t=1; the tail is PAD and
        the score is that one step's -log p."""
        cfg, jm, jp, tm, z, classes = canonical
        with torch.no_grad():
            saved = tm.decoder.output_layer.bias.clone()
            tm.decoder.output_layer.bias.zero_()
            tm.decoder.output_layer.bias[EOS_ID] = 1e4
            try:
                seqs, scores = fd.fused_decode(tm, torch_x0(tm, z, classes), 12, 0, mode="greedy")
            finally:
                tm.decoder.output_layer.bias.copy_(saved)
        s = seqs.numpy()
        assert (s[:, 0] == SOS_ID).all() and (s[:, 1] == EOS_ID).all()
        assert (s[:, 2:] == PAD_ID).all()
        assert np.allclose(scores.numpy(), 0.0, atol=1e-3)


class TestAgainstXlaLoop:
    """Pre-LN with final_ln and per-step class conditioning: the Pallas
    kernel hard-codes post-LN and has no class input, so these are held
    against the JAX package's XLA loop (decode_sampled(use_fused=False))."""

    @pytest.mark.parametrize("norm_scheme,conditioning", [
        ("post", "initial"), ("pre", "initial"), ("post", "per_step"), ("pre", "per_step")])
    def test_greedy_and_forced(self, norm_scheme, conditioning):
        cfg = make_config(d=32, layers=2, heads=4, norm_scheme=norm_scheme,
                          class_conditioning=conditioning)
        jm, jp, tm = both_models(cfg, seed=5)
        z, classes = latents(4, seed=6)
        T = 16
        jseqs, jscores = jax_decode_sampled(
            jm, jp, jnp.asarray(z), jnp.asarray(classes), T, jax.random.key(0),
            greedy=True, use_fused=False)
        tx0 = torch_x0(tm, z, classes)
        tcls = torch.as_tensor(classes).long()
        tseqs, tscores = fd.fused_decode(tm, tx0, T, 0, mode="greedy", classes=tcls)
        np.testing.assert_array_equal(tseqs.numpy(), np.asarray(jseqs))
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=1e-4, atol=1e-4)

        forced = np.random.default_rng(7).integers(3, 293, (4, T)).astype(np.int32)
        jl = jax_forced_logits(jm, jp, jnp.asarray(z), jnp.asarray(classes),
                               jnp.asarray(forced), T)
        _, _, tl = fd.fused_decode(tm, tx0, T, 0, mode="forced",
                                   forced_tokens=torch.as_tensor(forced), classes=tcls)
        np.testing.assert_allclose(tl.numpy()[:, 1:], jl, atol=1e-4)
        assert (tl.numpy()[:, 0] == 0).all()

    def test_per_step_needs_classes(self):
        cfg = make_config(d=32, layers=1, heads=4, class_conditioning="per_step")
        _, _, tm = both_models(cfg)
        z, classes = latents(2)
        with pytest.raises(ValueError, match="per_step"):
            fd.fused_decode(tm, torch_x0(tm, z, classes), 4, 0, mode="greedy")


def random_logits(seed, B=8, V=293):
    return np.random.default_rng(seed).normal(scale=3.0, size=(B, V)).astype(np.float32)


class TestFilterSupport:
    @pytest.mark.parametrize("top_k,top_p", [
        (1, 0.0), (3, 0.0), (7, 0.0), (50, 0.0), (293, 0.0),
        (0, 0.1), (0, 0.5), (0, 0.9), (0, 0.99), (10, 0.7)])
    def test_matches_jax(self, top_k, top_p):
        logits = random_logits(top_k * 100 + int(top_p * 100))
        ref = np.asarray(jax_filter_logits(jnp.asarray(logits), top_k, top_p))
        jax_bisect = np.asarray(jax_filter_support(jnp.asarray(logits), top_k, top_p))
        got = fd.filter_support(torch.as_tensor(logits), top_k, top_p).numpy()
        sorted_based = _filter_logits(torch.as_tensor(logits), top_k, top_p).numpy()
        np.testing.assert_array_equal(got, jax_bisect)
        np.testing.assert_array_equal(got > -1e29, ref > -1e29)
        np.testing.assert_array_equal(sorted_based > -1e29, ref > -1e29)

    def test_top_k_keeps_ties(self):
        row = np.full((1, 293), -10.0, np.float32)
        row[0, [4, 100, 292]] = 5.0
        row[0, 7] = 3.0
        got = fd.filter_support(torch.as_tensor(row), 2, 0.0).numpy()[0]
        assert (got[[4, 100, 292]] == 5.0).all() and got[7] < -1e29
        ref = np.asarray(jax_filter_logits(jnp.asarray(row), 2, 0.0))[0]
        np.testing.assert_array_equal(got > -1e29, ref > -1e29)

    def test_top_p_always_keeps_argmax(self):
        logits = random_logits(7)
        got = fd.filter_support(torch.as_tensor(logits), 0, 1e-6).numpy()
        for b, best in enumerate(np.argmax(logits, -1)):
            assert list(np.flatnonzero(got[b] > -1e29)) == [best]

    def test_plateaus_match_jax(self):
        """Rows with exact ties at the cut (rounded logits) and smooth rows."""
        rng = np.random.default_rng(2024)
        smooth = rng.normal(scale=4.0, size=(100, 293)).astype(np.float32)
        tied = np.round(rng.normal(scale=2.0, size=(100, 293)) * 2).astype(np.float32) / 2
        logits = np.concatenate([smooth, tied])
        for top_k, top_p in [(5, 0.0), (64, 0.0), (0, 0.3), (0, 0.95), (16, 0.8)]:
            ref = np.asarray(jax_filter_logits(jnp.asarray(logits), top_k, top_p))
            got = fd.filter_support(torch.as_tensor(logits), top_k, top_p).numpy()
            np.testing.assert_array_equal(got > -1e29, ref > -1e29,
                                          err_msg=f"k={top_k} p={top_p}")

    def test_sort_keys_order(self):
        vals = np.array([-1e30, -3.5e4, -2.0, -1.0, -1e-30, -0.0, 0.0, 1e-30, 0.5,
                         1.0, 1.0000001, 7.25e8, 3.0e38], np.float32)
        keys = fd.float_sort_keys(torch.as_tensor(vals)).numpy()
        for i in range(len(vals)):
            for j in range(len(vals)):
                assert (keys[i] < keys[j]) == (vals[i] < vals[j]), (i, j)
                assert (keys[i] == keys[j]) == (vals[i] == vals[j]), (i, j)


class TestPhilox:
    # Known-answer vectors of Philox4x32-10 (Random123's kat_vectors).
    @pytest.mark.parametrize("ctr,key,out", [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ])
    def test_known_answers(self, ctr, key, out):
        c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        got = [int(w) for w in fd.philox4x32(*c, *key)]
        assert got == list(out)

    def test_uniforms_strictly_inside_unit_interval(self):
        bits = torch.tensor([0, 1, 0x7FFFFF, 0xFFFFFFFF, 0x80000000, 0x12345678],
                            dtype=torch.int64)
        u = fd.uniform_from_bits(bits)
        assert bool(((u > 0) & (u < 1)).all())
        assert bool(torch.isfinite(-torch.log(-torch.log(u))).all())

    def test_gumbel_noise_deterministic_and_distinct(self):
        a = fd.gumbel_noise(123, 5, 4, 293, torch.device("cpu"))
        assert torch.equal(a, fd.gumbel_noise(123, 5, 4, 293, torch.device("cpu")))
        assert not torch.equal(a, fd.gumbel_noise(123, 6, 4, 293, torch.device("cpu")))
        assert not torch.equal(a, fd.gumbel_noise(124, 5, 4, 293, torch.device("cpu")))
        assert abs(float(a.mean()) - 0.5772) < 0.1  # Euler-Mascheroni


class TestWrapper:
    def test_cpu_tensors_take_the_plain_version_without_building(self, canonical, monkeypatch):
        cfg, jm, jp, tm, z, classes = canonical

        def no_build(name):
            raise AssertionError("the CPU route must not build the CUDA kernel")

        monkeypatch.setattr(_build, "load", no_build)
        launches = fd.fused_decode.launches
        x0 = torch_x0(tm, z, classes)
        a = fd.fused_decode(tm, x0, 10, 3, 0.8, "sample", top_k=20, top_p=0.9)
        b = fd.fused_decode_reference(tm, x0, 10, 3, 0.8, "sample", top_k=20, top_p=0.9)
        assert fd.fused_decode.launches == launches
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_bad_mode_and_temperature(self, canonical):
        cfg, jm, jp, tm, z, classes = canonical
        x0 = torch_x0(tm, z, classes)
        with pytest.raises(ValueError, match="mode"):
            fd.fused_decode(tm, x0, 4, 0, mode="beam")
        with pytest.raises(ValueError, match="temperature"):
            fd.fused_decode(tm, x0, 4, 0, temperature=0.0)

    def test_build_raises_without_nvcc(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build("fused_decode")

    def test_library_name_follows_source_hash(self):
        p = _build.library_path("fused_decode")
        assert p.parent == _build.BUILD_DIR and p.name.startswith("fused_decode-")
        assert p == _build.library_path("fused_decode")



# The recipes' decoders: (model size, heads, FF, layers, max_len).
DECODERS = {"canonical": (128, 8, 512, 1, 130), "wide": (512, 16, 2048, 2, 1026),
            "long": (256, 8, 1024, 2, 4094)}


class TestPlan:
    """``plan``: how the CUDA kernel groups rows into clusters and whether
    the weights stay resident (no kernel is built)."""

    @pytest.mark.parametrize("esize", [2, 4])
    @pytest.mark.parametrize("B", [1, 3, 17, 64, 256])
    @pytest.mark.parametrize("decoder", sorted(DECODERS))
    def test_every_row_covered_once(self, decoder, B, esize):
        D, H, FF, NL, T = DECODERS[decoder]
        p = fd.plan(B, D, H, FF, 293, NL, T, esize)
        rows, C, G = p["rows"], p["cluster"], p["groups"]
        assert 1 <= rows <= 16 and G == -(-B // rows) and p["blocks"] == G * C
        covered = [r for g in range(G) for r in range(g * rows, min((g + 1) * rows, B))]
        assert covered == list(range(B))  # each row once, the last group ragged, none empty
        assert (G - 1) * rows < B
        assert H % C == 0 and D % (8 * C) == 0 and FF % (8 * C) == 0 and C <= fd.MAX_CLUSTER
        assert p["smem"] == fd.smem_bytes(rows, C, D, H, FF, 293, esize, NL, p["resident"])
        assert p["smem"] <= 232448 - 1024

    @pytest.mark.parametrize("decoder,B,want", [
        ("canonical", 64, (5, 8, 13, True)), ("wide", 16, (2, 8, 8, False)),
        ("long", 16, (2, 8, 8, False))])
    def test_the_recipes_plans(self, decoder, B, want):
        D, H, FF, NL, T = DECODERS[decoder]
        p = fd.plan(B, D, H, FF, 293, NL, T, 2)
        assert (p["rows"], p["cluster"], p["groups"], p["resident"]) == want

    def test_resident_only_where_the_slices_fit(self):
        # the canonical decoder's slices: 0.54 MB over 8 blocks
        assert fd.slice_bytes(8, 128, 512, 293, 1, 2) == 81408
        # the long decoder's 3.4 MB over 8 blocks do not fit a block
        assert fd.slice_bytes(8, 256, 1024, 293, 2, 2) > 232448
        assert fd.smem_bytes(4, 8, 128, 8, 512, 293, 2, 1, True) == (
            fd.smem_bytes(4, 8, 128, 8, 512, 293, 2, 1) + 81408)

    def test_float32_wide_group_fits_shared_memory(self):
        assert fd.smem_bytes(16, 8, 512, 16, 2048, 293, 4) > 232448 - 1024
        assert fd.plan(16, 512, 16, 2048, 293, 2, 32, 4)["smem"] <= 232448 - 1024

    @pytest.mark.parametrize("D,H,C", [(512, 4, 4), (384, 16, 8), (96, 8, 4), (384, 32, 8)])
    def test_any_head_dimension(self, D, H, C):
        """Head dimensions 128, 24, 12 (and 12 with 32 heads) take the
        kernel's run-time head dimension."""
        p = fd.plan(16, D, H, 4 * D, 293, 2, 64, 2)
        assert p["cluster"] == C and H % C == 0

    @pytest.mark.parametrize("D,H,FF,V,match", [
        (128, 3, 512, 293, "not a multiple of the 3 heads"), (128, 8, 512, 0, "vocabulary 0")])
    def test_shapes_the_kernel_does_not_take(self, D, H, FF, V, match):
        """Only what the JAX package refuses too: heads that do not divide
        the model size, and an empty vocabulary."""
        with pytest.raises(ValueError, match=match):
            fd.plan(8, D, H, FF, V, 1, 16, 2)

    @pytest.mark.parametrize("D,H,FF,V,Dp,FFp", [
        (100, 4, 400, 293, 128, 416), (128, 8, 400, 293, 128, 416),
        (128, 8, 512, 321, 128, 512), (128, 8, 512, 400, 128, 512),
        (60, 3, 240, 293, 96, 256), (30, 5, 120, 1, 160, 128)])
    @pytest.mark.parametrize("esize", [2, 4])
    def test_lifted_shapes_plan(self, D, H, FF, V, Dp, FFp, esize):
        """Any model size the heads divide, any FF, any vocabulary: the plan
        runs at the padded widths (Dp a multiple of 32 the heads divide)."""
        assert fd.padded_widths(D, H, FF) == (Dp, FFp)
        p = fd.plan(8, D, H, FF, V, 1, 16, esize)
        C = p["cluster"]
        assert (p["D"], p["FF"]) == (Dp, FFp) and H % C == 0
        assert Dp % (8 * C) == 0 and FFp % (8 * C) == 0
        assert p["smem"] == fd.smem_bytes(p["rows"], C, Dp, H, FFp, V, esize, 1, p["resident"])


class TestPack:
    """``pack_weights``' layout and its plain inverse ``unpack_weights``."""

    def test_mma_order(self):
        assert sorted(fd.MMA_ORDER) == list(range(32))
        for q in range(4):  # lane q's B fragments of both k steps, contiguous
            assert fd.MMA_ORDER[8 * q:8 * q + 8] == [2 * q + o for o in (0, 1, 8, 9, 16, 17,
                                                                          24, 25)]
        w = torch.arange(6 * 64, dtype=torch.float32).reshape(6, 64)
        assert torch.equal(fd._mma_unpack(fd._mma_pack(w)), w)
        assert not torch.equal(fd._mma_pack(w), w)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("norm_scheme,conditioning", [("post", "initial"),
                                                          ("pre", "per_step")])
    def test_unpack_gives_back_the_weights(self, dtype, norm_scheme, conditioning):
        cfg = make_config(d=64, layers=2, heads=4, norm_scheme=norm_scheme,
                          class_conditioning=conditioning, dtype=dtype)
        torch.manual_seed(0)
        model = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(cfg)))
        dt = model.compute_dtype
        got = fd.unpack_weights(fd.pack_weights(model), 64, 256, 2, 293)
        stack = model.decoder.decoder
        for l, layer in enumerate(stack.layers):
            att, ff = layer.attention, layer.ff
            want = {"wqkv": torch.cat([att.w_q.weight, att.w_k.weight, att.w_v.weight]),
                    "wo": att.w_o.weight, "w1": ff.ff1.weight, "w2": ff.ff2.weight,
                    "bqkv": torch.cat([att.w_q.bias, att.w_k.bias, att.w_v.bias]),
                    "bo": att.w_o.bias, "b1": ff.ff1.bias, "b2": ff.ff2.bias}
            for name, w in want.items():
                assert torch.equal(got[f"layers.{l}.{name}"], w.detach().to(dt)), name
            for name, w in (("ln1s", layer.ln1.weight), ("ln1b", layer.ln1.bias),
                            ("ln2s", layer.ln2.weight), ("ln2b", layer.ln2.bias)):
                assert torch.equal(got[f"layers.{l}.{name}"], w.detach().float()), name
        if norm_scheme == "pre":
            assert torch.equal(got["final_lns"], stack.final_ln.weight.detach().float())
            assert torch.equal(got["final_lnb"], stack.final_ln.bias.detach().float())
        else:
            assert bool((got["final_lns"] == 1).all() and (got["final_lnb"] == 0).all())
        assert torch.equal(got["head"], model.decoder.output_layer.weight.detach().float())
        assert torch.equal(got["head_b"], model.decoder.output_layer.bias.detach().float())


def padded_model(d, heads, vocab, norm_scheme, conditioning, seed=0):
    """A float32 decoder whose widths the kernel pads (FF = 4 * d)."""
    cfg = make_config(d=d, layers=2, heads=heads, vocab=vocab, norm_scheme=norm_scheme,
                      class_conditioning=conditioning)
    torch.manual_seed(seed)
    model = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(cfg))).eval()
    with torch.no_grad():  # LayerNorm parameters away from ones/zeros
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.normal_(1.0, 0.2)
                m.bias.normal_(0.0, 0.2)
    return model


@torch.no_grad()
def padded_forced_logits(model, x0, forced, classes):
    """The kernel's arithmetic in float32 on the padded pack (zeros in every
    pad, LayerNorm statistics over the true columns): forced logits [B, T, V]."""
    pack = fd.pack_weights(model)
    D, H, FF, Dp, FFp = pack["dims"]
    tc = model.decoder.config.transformer_config
    NL, V = tc.num_layers, model.decoder.config.output_dim
    w = fd.padded_weights(pack, NL, V)
    hdp, B, T = Dp // H, x0.shape[0], forced.shape[1]
    pre = tc.norm_scheme == "pre"

    def ln(x, s, b):
        mean = x[:, :D].mean(-1, keepdim=True)
        var = ((x[:, :D] - mean) ** 2).mean(-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + 1e-6) * s + b
        return torch.cat([y[:, :D], torch.zeros_like(y[:, D:])], -1)

    bias = (fd._pad(model.decoder.step_bias(classes), B, Dp)
            if model.decoder.per_step_conditioning else 0.0)
    caches = [([], []) for _ in range(NL)]
    x = pack["scale"] * fd._pad(x0, B, Dp) + pack["pos"][0]
    out = torch.zeros(B, T, V)
    for t in range(T):
        if t > 0:  # the input of position t: SOS, then the forced tokens
            tok = forced[:, t - 1].long() if t > 1 else torch.full((B,), SOS_ID)
            x = pack["scale"] * (pack["emb"][tok] + bias) + pack["pos"][t]
        for l in range(NL):
            g = {k.split(".")[-1]: v for k, v in w.items() if k.startswith(f"layers.{l}.")}
            inp = ln(x, g["ln1s"], g["ln1b"]) if pre else x
            q, k, v = (inp @ g["wqkv"].T + g["bqkv"]).reshape(B, 3, H, hdp).unbind(1)
            caches[l][0].append(k)
            caches[l][1].append(v)
            K, Vc = torch.stack(caches[l][0], 2), torch.stack(caches[l][1], 2)
            p = torch.softmax(torch.einsum("bhd,bhkd->bhk", q, K) / pack["head_scale"], -1)
            o = torch.einsum("bhk,bhkd->bhd", p, Vc).reshape(B, Dp) @ g["wo"].T + g["bo"]
            if pre:
                x = x + o
                h = torch.relu(ln(x, g["ln2s"], g["ln2b"]) @ g["w1"].T + g["b1"])
                x = x + h @ g["w2"].T + g["b2"]
            else:
                x = ln(x + o, g["ln1s"], g["ln1b"])
                h = torch.relu(x @ g["w1"].T + g["b1"])
                x = ln(x + h @ g["w2"].T + g["b2"], g["ln2s"], g["ln2b"])
        h = ln(x, w["final_lns"], w["final_lnb"]) if pre else x
        if t > 0:
            out[:, t] = h @ w["head"].T + w["head_b"]
    return out


class TestPaddedWidths:
    """Decoders whose widths the kernel pads (D=100 with 4 heads of 25, FF
    400, a vocabulary of 400): the pack's pads are zeros that change no
    product. Tolerance: float32 sums in another order, 1e-4 on logits."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_unpack_gives_back_the_weights(self, dtype):
        cfg = make_config(d=100, layers=2, heads=4, norm_scheme="pre", dtype=dtype)
        torch.manual_seed(0)
        model = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(cfg)))
        pack = fd.pack_weights(model)
        assert pack["dims"] == (100, 4, 400, 128, 416)
        got = fd.unpack_weights(pack, 100, 400, 2, 293)
        att = model.decoder.decoder.layers[1].attention
        want = torch.cat([att.w_q.weight, att.w_k.weight, att.w_v.weight])
        assert torch.equal(got["layers.1.wqkv"], want.detach().to(model.compute_dtype))
        assert torch.equal(got["layers.1.wo"], att.w_o.weight.detach().to(model.compute_dtype))
        padded = fd.padded_weights(pack, 2, 293)["layers.1.wqkv"].float()
        heads = padded.reshape(3, 4, 32, 128)
        assert not heads[:, :, 25:].any() and not heads[..., 100:].any()

    @pytest.mark.parametrize("d,heads,vocab,norm_scheme,conditioning", [
        (100, 4, 293, "post", "initial"), (100, 4, 400, "pre", "per_step"),
        (60, 3, 293, "post", "per_step"), (128, 8, 400, "pre", "initial")])
    def test_padded_pack_computes_the_model(self, d, heads, vocab, norm_scheme, conditioning):
        model = padded_model(d, heads, vocab, norm_scheme, conditioning)
        rng = np.random.default_rng(1)
        B, T = 3, 9
        classes = torch.as_tensor(rng.integers(0, 2, B))
        with torch.no_grad():
            x0 = model.decode_init(torch.as_tensor(rng.normal(size=(B, 32)),
                                                   dtype=torch.float32), classes)
        forced = torch.as_tensor(rng.integers(3, vocab, (B, T)), dtype=torch.int32)
        _, _, want = fd.fused_decode_reference(model, x0, T, 0, mode="forced",
                                               forced_tokens=forced, classes=classes)
        got = padded_forced_logits(model, x0, forced, classes)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)

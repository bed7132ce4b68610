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


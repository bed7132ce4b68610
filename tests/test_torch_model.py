"""PyTorch port, model layer: the converter, the export, and the encoder /
decoder against the JAX ``StyleVAE`` on the same weights and inputs (CPU).

Tolerances: float32 on both sides, so the only difference is the order of
float32 summation (XLA's vs PyTorch's CPU kernels) — 1e-4 on logits of
magnitude ~10, 1e-5 on the latent.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from musicstyletransfer_tpu.models import (
    Config,
    DecoderConfig,
    EncoderConfig,
    ModelConfig,
    TransformerConfig,
    init_params,
    make_model,
)
from musicstyletransfer_tpu.models.transformer import (
    positional_encodings as jax_positional_encodings,
)
from musicstyletransfer_torch.convert import load_npz, params_from_jax
from musicstyletransfer_torch.inference.sampler import load_inference_model
from musicstyletransfer_torch.models import StyleVAE
from musicstyletransfer_torch.models import config as tconfig
from musicstyletransfer_torch.models.transformer import positional_encodings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "models", "guitar_bass")
EXPORT = os.path.join(MODEL, "torch")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; torch's default of one
    thread per core oversubscribes it, and its spin-waiting threads then
    slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_params_from_npz(path):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in load_npz(path).items()})


def torch_model(jax_config, state_dict):
    """The port's StyleVAE for a JAX ModelConfig, float32 weights loaded."""
    model = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(jax_config)))
    model.load_state_dict(state_dict)
    return model.eval()


def source_batch(seed, B=4, L=16, vocab=293):
    """SOS-prefixed, PAD-suffixed token rows with their lengths and classes."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, L + 1), np.int32)
    tokens[:, 0] = 1
    for b, n in enumerate(rng.integers(4, L + 1, B)):
        tokens[b, 1:n] = rng.integers(3, vocab, n - 1)
    seq_lens = (tokens != 0).sum(1).astype(np.int32)
    classes = rng.integers(0, 2, B).astype(np.int32)
    return tokens, seq_lens, classes


def run_both(jax_model, jax_params, tmodel, tokens, seq_lens, classes):
    logits, mu, logvar = jax_model.apply(
        {"params": jax_params}, jnp.asarray(tokens), jnp.asarray(seq_lens),
        jnp.asarray(classes), train=False)
    with torch.no_grad():
        t_logits, t_mu, t_logvar = tmodel(
            torch.as_tensor(tokens).long(), torch.as_tensor(seq_lens).long(),
            torch.as_tensor(classes).long())
    return ((np.asarray(logits), np.asarray(mu), np.asarray(logvar)),
            (t_logits.numpy(), t_mu.numpy(), t_logvar.numpy()))


def small_config(norm_scheme="post", class_conditioning="initial"):
    enc = TransformerConfig(model_size=32, num_layers=2, num_heads=4, dropout=0.0,
                            vocab_size=293, norm_scheme=norm_scheme)
    dec = TransformerConfig(model_size=32, num_layers=1, num_heads=4, dropout=0.0,
                            vocab_size=293, norm_scheme=norm_scheme)
    return ModelConfig(
        encoder_config=EncoderConfig(transformer_config=enc, latent_dim=16),
        decoder_config=DecoderConfig(transformer_config=dec, latent_dim=16,
                                     class_conditioning=class_conditioning),
        dtype="float32")


@pytest.fixture(scope="module")
def shipped():
    """The shipped guitar_bass weights, float32 compute, on both sides."""
    cfg = Config.load(os.path.join(MODEL, "config")).copy(dtype="float32")
    jparams = jax_params_from_npz(os.path.join(EXPORT, "params.npz"))
    tmodel = torch_model(cfg,
                         load_inference_model(MODEL, -1, torch.device("cpu")).state_dict())
    return make_model(cfg), jparams, tmodel


class TestConvert:
    def test_round_trip_names_shapes_and_values(self):
        """flat npz -> state_dict -> flax paths again gives back every array."""
        flat = load_npz(os.path.join(EXPORT, "params.npz"))
        sd = params_from_jax(flat)
        assert len(sd) == len(flat)
        back = {}
        for name, t in sd.items():
            parts = name.replace("layers.", "layer").split(".")
            leaf = parts[-1]
            if leaf == "weight":
                if parts[-2].endswith("emb"):
                    leaf, arr = "embedding", t.numpy()
                elif parts[-2].startswith("ln") or parts[-2] == "final_ln":
                    leaf, arr = "scale", t.numpy()
                else:
                    leaf, arr = "kernel", t.numpy().T
            else:
                arr = t.numpy()
            back["/".join(parts[:-1] + [leaf])] = arr
        assert set(back) == set(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k], err_msg=k)

    def test_nested_tree_matches_flat(self):
        nested = traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in load_npz(os.path.join(EXPORT, "params.npz")).items()})
        a, b = params_from_jax(nested), params_from_jax(load_npz(os.path.join(EXPORT, "params.npz")))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])

    def test_loads_into_model_strictly(self):
        model = load_inference_model(MODEL, -1, torch.device("cpu"))
        assert model.config.dtype == "bfloat16"
        assert model.config.decoder_config.transformer_config.model_size == 128
        n = sum(p.numel() for p in model.parameters())
        assert n == 2_093_349

    def test_unknown_leaf_rejected(self):
        with pytest.raises(ValueError, match="unknown flax parameter"):
            params_from_jax({"encoder/foo/mystery": np.zeros(3)})

    def test_checkpoint_mismatch_raises(self):
        with pytest.raises(ValueError, match="holds checkpoint 6"):
            load_inference_model(MODEL, 3, torch.device("cpu"))


class TestExport:
    def test_committed_export_equals_fresh_export(self, tmp_path):
        """The committed params.npz/config.json are what the export script
        writes from params.6 today."""
        spec = importlib.util.spec_from_file_location(
            "export_torch_weights", os.path.join(REPO, "scripts", "export-torch-weights.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.export_params(MODEL, 6, str(tmp_path))
        fresh, committed = (load_npz(os.path.join(d, "params.npz")) for d in (tmp_path, EXPORT))
        assert fresh.keys() == committed.keys()
        for k in fresh:
            assert fresh[k].dtype == np.float32
            np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
        with open(tmp_path / "config.json") as f1, open(os.path.join(EXPORT, "config.json")) as f2:
            assert json.load(f1) == json.load(f2)

    def test_config_round_trip(self):
        cfg, ckpt = tconfig.load_config(os.path.join(EXPORT, "config.json"))
        jcfg = Config.load(os.path.join(MODEL, "config"))
        assert ckpt == 6
        for side in ("encoder_config", "decoder_config"):
            jt = getattr(jcfg, side).transformer_config
            tt = getattr(cfg, side).transformer_config
            for f in ("model_size", "num_layers", "num_heads", "ffn_multiplier",
                      "max_positions", "norm_scheme"):
                assert getattr(jt, f) == getattr(tt, f), (side, f)
        assert cfg.decoder_config.class_conditioning == "initial"
        assert cfg.dtype == jcfg.dtype == "bfloat16"


class TestParity:
    def test_positional_encodings(self):
        np.testing.assert_array_equal(positional_encodings(128, 130),
                                      jax_positional_encodings(128, 130))

    def test_shipped_weights_float32(self, shipped):
        jm, jp, tm = shipped
        (jl, jmu, jlv), (tl, tmu, tlv) = run_both(jm, jp, tm, *source_batch(0))
        np.testing.assert_allclose(tmu, jmu, atol=1e-5)
        np.testing.assert_allclose(tlv, jlv, atol=1e-5)
        np.testing.assert_allclose(tl, jl, atol=1e-4)

    def test_shipped_weights_bfloat16_close(self):
        """bf16 on both sides: rounding happens at the same places, but XLA
        and PyTorch round different float32 sums; a bf16 ulp is 0.4%."""
        cfg = Config.load(os.path.join(MODEL, "config"))
        jp = jax_params_from_npz(os.path.join(EXPORT, "params.npz"))
        tm = load_inference_model(MODEL, -1, torch.device("cpu"))
        (jl, jmu, _), (tl, tmu, _) = run_both(make_model(cfg), jp, tm, *source_batch(1))
        np.testing.assert_allclose(tmu, jmu, atol=0.05)
        np.testing.assert_allclose(tl, jl, atol=0.5)

    @pytest.mark.parametrize("norm_scheme,conditioning", [
        ("post", "initial"), ("pre", "initial"), ("pre", "per_step")])
    def test_small_config(self, norm_scheme, conditioning):
        cfg = small_config(norm_scheme, conditioning)
        jm = make_model(cfg)
        jp = init_params(jm, jax.random.key(3), max_seq_len=16)
        flat = traverse_util.flatten_dict(jax.device_get(jp), sep="/")
        tm = torch_model(cfg, params_from_jax(flat))
        (jl, jmu, jlv), (tl, tmu, tlv) = run_both(jm, jp, tm, *source_batch(2))
        np.testing.assert_allclose(tmu, jmu, atol=1e-5)
        np.testing.assert_allclose(tlv, jlv, atol=1e-5)
        np.testing.assert_allclose(tl, jl, atol=1e-4)


class TestIncrementalDecode:
    @pytest.mark.parametrize("norm_scheme,conditioning", [
        ("post", "initial"), ("pre", "per_step")])
    def test_step_matches_batched_causal_forward(self, norm_scheme, conditioning):
        """Feeding a sequence one cached step at a time gives the teacher-
        forced (batched causal) logits: the invariant tests/test_model.py
        pins for the JAX stack."""
        cfg = small_config(norm_scheme, conditioning)
        torch.manual_seed(0)
        model = StyleVAE(tconfig.ModelConfig.from_dict(dataclasses.asdict(cfg))).eval()
        tokens, _, classes = source_batch(4, L=10)
        tokens = torch.as_tensor(tokens).long()
        tokens[tokens == 0] = 5  # every position valid
        classes = torch.as_tensor(classes).long()
        seq_lens = torch.full((tokens.shape[0],), tokens.shape[1])
        z = torch.randn(tokens.shape[0], 16)
        with torch.no_grad():
            batched = model.decoder(tokens, seq_lens, z, classes)
            cache = model.decode_prefill(z, classes, tokens.shape[1] + 1)
            steps = [model.decode_step(tokens[:, t], cache, t + 1, classes)
                     for t in range(tokens.shape[1])]
        np.testing.assert_allclose(torch.stack(steps, 1).numpy(), batched.numpy(),
                                   atol=1e-5)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports without pulling
    in jax, flax, optax, orbax or yaml."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import musicstyletransfer_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'yaml'))\n"
        "assert len(mods) >= 12, mods\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

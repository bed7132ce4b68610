"""PyTorch port, mesh-sharded inference (``inference/sharded.py``) against the
JAX package and against one process (CPU): the counterparts of
``tests/test_sharding.py::TestShardedInferenceAPI``.

The port's ranks are two gloo processes (``tests/torch_dist_worker.py``,
scenarios ``sharded_dp`` and ``sharded_tp``), each called with the same
global inputs, on the weights of a JAX checkpoint moved through the
converter; there K1 runs as its plain version. The JAX side runs on
``conftest.py``'s virtual CPU devices, its XLA decode loop
(``use_fused=False``).

- dp=2 pads 5 rows to 6 and drops the padding; greedy tokens equal the JAX
  decode's exactly and scores to 1e-5 on every route (the step loop that
  the CPU picks, K1's plain version forced, the loop forced);
- the auto route makes no K1 call on the CPU, a forced one one call a rank;
- sampled: shard d's rows equal ``sample_sequences`` on those rows with key
  d of the caller's generator (the K1 route: ``fused_decode_reference``);
- tp=2: greedy tokens exact, the cached decode's teacher-forced logits to
  1e-5 of the unsharded model's (ROADMAP queue 3, fault 5: its cache holds
  the rank's heads), ``use_fused=True`` refused;
- the all-classes transfer equals the unsharded call token for token;
- ``make_mesh`` without a device follows the world's backend (fault 4).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from musicstyletransfer_tpu.inference.decode import sample_sequences as jax_sample_sequences
from musicstyletransfer_tpu.inference.sampler import \
    load_inference_model as jax_load_inference_model
from musicstyletransfer_torch.inference import decode
from musicstyletransfer_torch.inference.decode import decode_stepwise
from musicstyletransfer_torch.inference.sampler import load_inference_model
from musicstyletransfer_torch.inference.sharded import _pad_rows, draw_keys
from musicstyletransfer_torch.midi import smf
from musicstyletransfer_torch.midi.codec import Melody, MelodyWriter
from musicstyletransfer_torch.midi.vocab import EOS_ID, PAD_ID, SOS_ID, note_on_id, timeshift_id
from musicstyletransfer_torch.ops.fused_decode import fused_decode_reference
from musicstyletransfer_torch.parallel import initialize_distributed, make_mesh
from musicstyletransfer_torch.parallel.mesh import default_device
from tests.test_torch_parallel import WORKER, child_env, free_port
from tests.test_torch_service import jax_model_folder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CONFIG = dict(vocab=293, classes=3, latent=8, size=16, heads=2, layers=1)
B, L, MAX_LEN = 5, 6, 10


def midi_bytes(pitches):
    tokens = []
    for p in pitches:
        tokens += [note_on_id(p), timeshift_id(120)]
    return smf.dump_midifile(MelodyWriter().to_midifile(Melody(tokens=np.asarray(tokens,
                                                                                 np.int32))))


REQUESTS = [midi_bytes((40 + i, 45 + i, 50 + i)) for i in range(3)]


def run_workers(folder, scenarios, timeout=300):
    """Two gloo ranks running ``scenarios`` of torch_dist_worker.py on
    ``folder``; returns rank 0's results by scenario."""
    spec = os.path.join(folder, f"spec-{scenarios[0]}.json")
    with open(spec, "w") as f:
        json.dump({"folder": str(folder), "scenarios": scenarios}, f)
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, spec, str(r), "2", port], cwd=REPO,
                              env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        assert p.returncode == 0, out[-5000:]
    results = {}
    for name in scenarios:
        with np.load(os.path.join(folder, f"{name}.npz")) as z:
            results[name] = {k: z[k] for k in z.files}
    return results


def write_spec(folder):
    """The workers' inputs beside a model folder of ``CONFIG``'s model: rows
    of tokens made from a numpy seed, forced tokens, ``REQUESTS``."""
    rng = np.random.default_rng(3)
    tokens = np.concatenate([np.full((B, 1), SOS_ID), rng.integers(3, 293, (B, L))], 1)
    forced = np.concatenate([np.full((B, 1), SOS_ID), rng.integers(3, 293, (B, MAX_LEN - 1))], 1)
    inputs = {"tokens": tokens.astype(np.int64), "seq_lens": np.full(B, L + 1, np.int64),
              "classes": rng.integers(0, 3, B).astype(np.int64),
              "forced": forced.astype(np.int32)}
    np.savez(os.path.join(folder, "sharded_inputs.npz"), **inputs)
    with open(os.path.join(folder, "sharded.json"), "w") as f:
        json.dump({"model": folder, "max_len": MAX_LEN, "classes": 3,
                   "requests": [m.hex() for m in REQUESTS]}, f)
    return inputs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX checkpoint and its export, the inputs, and the worker spec."""
    folder = jax_model_folder(tmp_path_factory, "sharded-model", **CONFIG)
    return folder, write_spec(folder)


@pytest.fixture(scope="module")
def results(setup):
    return run_workers(setup[0], ["sharded_dp", "sharded_tp"])


@pytest.fixture(scope="module")
def model(setup):
    return load_inference_model(setup[0], -1, CPU)


@pytest.fixture(scope="module")
def jax_greedy(setup):
    """The JAX package's XLA greedy decode of the inputs, unsharded."""
    folder, x = setup
    jm, params = jax_load_inference_model(folder, -1, max_seq_len=8)
    seqs, scores = jax_sample_sequences(
        jm, params, jnp.asarray(x["tokens"], jnp.int32), jnp.asarray(x["seq_lens"], jnp.int32),
        jnp.asarray(x["classes"], jnp.int32), MAX_LEN, jax.random.key(1), greedy=True,
        use_fused=False)
    return np.asarray(seqs), np.asarray(scores)


def well_formed(seqs):
    assert (seqs[:, 0] == SOS_ID).all()
    for row in seqs:
        ends = np.flatnonzero(row[1:] == EOS_ID)
        if ends.size:
            assert (row[ends[0] + 2:] == PAD_ID).all()


@pytest.mark.parametrize("route", ["auto", "fused", "loop"])
def test_dp_matches_unsharded_with_padding(results, jax_greedy, route):
    """dp=2 on 5 rows (padded to 6, the padding dropped): greedy tokens equal
    the JAX decode's on every route, scores to 1e-5."""
    r = results["sharded_dp"]
    assert r[f"{route}_seqs"].shape == (B, MAX_LEN)
    np.testing.assert_array_equal(r[f"{route}_seqs"], jax_greedy[0])
    np.testing.assert_allclose(r[f"{route}_scores"], jax_greedy[1], atol=1e-5)
    well_formed(r["sampled_seqs"])


def test_dp_exact_when_batch_divides(setup, results, model):
    """Sampled, 4 rows over 2 shards and 5 padded to 6: shard d's rows equal
    ``sample_sequences`` on those rows with key d of the caller's generator,
    bit for bit (the step loop, and K1's plain version)."""
    _, x = setup
    r = results["sharded_dp"]
    keys = draw_keys(torch.Generator().manual_seed(1), 2)
    for name, rows, got in (("loop", 4, r["divides_seqs"]), ("loop", B, r["sampled_seqs"]),
                            ("fused", B, r["sampled_fused_seqs"])):
        per = -(-rows // 2)
        padded = {k: _pad_rows(torch.as_tensor(v[:rows]), 2 * per) for k, v in x.items()}
        want = []
        for d in range(2):
            t, s, c = (padded[k][d * per:(d + 1) * per] for k in ("tokens", "seq_lens", "classes"))
            z = decode._encode_deterministic(model, t, s, c)
            if name == "loop":
                seqs, _ = decode_stepwise(model, z, c, MAX_LEN, keys[d])
            else:
                seqs, _ = fused_decode_reference(model, model.decode_init(z, c).contiguous(),
                                                 MAX_LEN, keys[d], classes=c)
            want.append(seqs.numpy())
        np.testing.assert_array_equal(got, np.concatenate(want)[:rows], err_msg=f"{name} {rows}")


def test_tp_decode_well_formed(results, jax_greedy):
    """tp=2: each rank holds one of the two heads; greedy tokens equal the
    JAX decode's, scores to 1e-5."""
    r = results["sharded_tp"]
    assert int(r["local_heads"]) == 1
    np.testing.assert_array_equal(r["greedy_seqs"], jax_greedy[0])
    np.testing.assert_allclose(r["greedy_scores"], jax_greedy[1], atol=1e-5)


def test_tp2_cached_decode_equals_unsharded(setup, results, model):
    """ROADMAP queue 3, fault 5: under tp=2 the cached step's cache holds the
    rank's heads, and its teacher-forced logits equal the unsharded model's
    within 1e-5 (float32)."""
    _, x = setup
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    with torch.inference_mode():
        z = decode._encode_deterministic(model, t["tokens"], t["seq_lens"], t["classes"])
        _, _, logits = decode_stepwise(model, z, t["classes"], MAX_LEN, 0, mode="forced",
                                       forced_tokens=t["forced"])
    np.testing.assert_allclose(results["sharded_tp"]["forced_logits"], logits.numpy(),
                               atol=1e-5)


def test_fused_per_shard_greedy_matches_xla(results, jax_greedy):
    """use_fused=True runs K1 (its plain version on the CPU) once a rank on
    the rank's rows; greedy equals the JAX XLA loop exactly. The auto route
    takes the step loop on the CPU: no K1 call."""
    r = results["sharded_dp"]
    assert int(r["fused_k1"]) == 1 and int(r["auto_k1"]) == 0 and int(r["loop_k1"]) == 0
    np.testing.assert_array_equal(r["fused_seqs"], jax_greedy[0])


def test_forced_fused_rejects_unsupported_args(results, gloo_world, model, setup):
    """use_fused=True raises on a model axis > 1 (the kernel holds whole
    weights); top_k with use_fused=True is taken (greedy ignores it)."""
    assert "data-parallel" in str(results["sharded_tp"]["refused"])
    from musicstyletransfer_torch.inference.sharded import sharded_sample_sequences

    _, x = setup
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    seqs, _ = sharded_sample_sequences(model, t["tokens"], t["seq_lens"], t["classes"],
                                       MAX_LEN, torch.Generator(), make_mesh(1), top_k=5,
                                       greedy=True, use_fused=True)
    assert seqs.shape == (B, MAX_LEN)


def test_all_classes_matches_unsharded(setup, results, model, jax_greedy):
    """The all-classes wrapper tiles to C*B = 15 rows (padded to 16 over 2
    shards) and equals the unsharded call token for token, and the JAX
    greedy decode on the tiled rows."""
    _, x = setup
    seqs, scores = decode.style_transfer_all_classes(
        model, torch.as_tensor(x["tokens"]), torch.as_tensor(x["seq_lens"]), MAX_LEN, 3, 0,
        greedy=True)
    r = results["sharded_dp"]
    assert r["all_seqs"].shape == (3, B, MAX_LEN)
    np.testing.assert_array_equal(r["all_seqs"], seqs.numpy())
    np.testing.assert_allclose(r["all_scores"], scores.numpy(), atol=1e-5)


@pytest.fixture
def gloo_world():
    """A world of one gloo rank in this process."""
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_follows_the_backend(gloo_world, monkeypatch):
    """ROADMAP queue 3, fault 4: ``make_mesh`` without a device lays the mesh
    on the world's device: the CPU on gloo, this process's current card on
    NCCL (the rule, with the backend passed in)."""
    assert make_mesh(1).device == CPU
    assert default_device("gloo") == CPU
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert default_device("nccl") == torch.device("cuda", 3)
    with pytest.raises(ValueError, match="backend"):
        default_device("mpi")

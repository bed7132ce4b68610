"""Ring attention in the PyTorch port (``musicstyletransfer_torch/ops/
ring_attention.py``: K4/K5's plain versions on the CPU, driven per visiting
chunk) against the JAX package's ``ring_attention_sharded`` in interpret
mode, on the same numpy-seeded inputs: over two gloo processes
(``tests/torch_dist_worker.py``, the package's NCCL/gloo rotation) and in
lock step in one process at n = 4 (the step code ``chip_smoke.py`` drives on
the card). Cases: causal and not, T not divisible by the ring, key lengths
that leave whole chunks with 0 visible keys.

Tolerances (float32 on both sides, the partials merged in another order):
out 1e-5, dq/dk/dv 1e-4, the merged lse 1e-5 against a logsumexp of the
whole scores.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicstyletransfer_tpu.ops import ring_attention_sharded as jax_ring
from musicstyletransfer_tpu.parallel import make_mesh
from musicstyletransfer_torch.ops import ring_attention as ra
from musicstyletransfer_torch.parallel.mesh import SeqShard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")

# (T, causal, key lengths): ragged rows, a T that no ring of 2 or 4
# divides, and rows whose keys end inside the first chunk (the later chunks
# see 0 visible keys)
CASES = [(32, False, [32, 17, 5, 11]), (32, True, [32, 19, 5, 11]),
         (29, True, [29, 22, 3, 14]), (29, False, [29, 12, 3, 1])]


def inputs(i, T, B=4, H=2, D=8):
    rng = np.random.default_rng(100 + i)
    return [rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(4)]


def jax_ring_and_grads(mesh, q, k, v, w, lens, causal):
    def f(q, k, v):
        return jax_ring(q, k, v, jnp.asarray(lens, jnp.int32), causal=causal, mesh=mesh,
                        interpret=True)

    @jax.jit
    def both(q, k, v, w):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(w)

    out, grads = both(*(jnp.asarray(x) for x in (q, k, v, w)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Two gloo ranks running ring_attention_sharded on every case."""
    folder = tmp_path_factory.mktemp("ring")
    arrays = {"cases": json.dumps([{"causal": c} for _, c, _ in CASES])}
    for i, (T, _, lens) in enumerate(CASES):
        for name, x in zip("qkvw", inputs(i, T)):
            arrays[f"{name}{i}"] = x
        arrays[f"lens{i}"] = np.asarray(lens, np.int32)
    np.savez(folder / "ring_cases.npz", **arrays)
    (folder / "spec.json").write_text(json.dumps({"folder": str(folder),
                                                  "scenarios": ["ring_op"]}))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(folder / "spec.json"), str(r), "2",
                               port], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    with np.load(folder / "ring_op.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("i", range(len(CASES)))
def test_two_gloo_ranks_match_jax_ring(gloo_results, cpu_devices, i):
    """n = 2 over two processes: out and the gradients of sum(out * w)."""
    T, causal, lens = CASES[i]
    q, k, v, w = inputs(i, T)
    out, grads = jax_ring_and_grads(make_mesh(cpu_devices[:2], tp=2), q, k, v, w, lens, causal)
    np.testing.assert_allclose(gloo_results[f"out{i}"], out, atol=1e-5)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(gloo_results[f"{name}{i}"], g, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_lockstep_ring_of_four_matches_jax_ring(cpu_devices, i):
    """n = 4 in lock step in one process (the per-rank step code with a
    rotation by list index): out, the global lse, and dq/dk/dv from the
    re-rotating backward; T padded to the ring and the padding dropped."""
    T, causal, lens = CASES[i]
    n = 4
    q, k, v, w = inputs(i, T)
    out, grads = jax_ring_and_grads(make_mesh(cpu_devices[:n], tp=n), q, k, v, w, lens, causal)
    chunks = [[SeqShard(T, n, r).local(torch.as_tensor(x), 2).contiguous() for r in range(n)]
              for x in (q, k, v, w)]
    key_lens = torch.as_tensor(lens, dtype=torch.int32)
    scale = q.shape[-1] ** -0.5
    fwd = ra.ring_forward_lockstep(*chunks[:3], key_lens, causal, scale)
    got = torch.cat([o for o, _ in fwd], 2)[:, :, :T]
    np.testing.assert_allclose(got.numpy(), out, atol=1e-5)

    lse = torch.cat([l for _, l in fwd], 2)[:, :, :T].numpy()
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    mask = np.arange(T)[None, :] < np.asarray(lens)[:, None, None, None]
    if causal:
        mask = mask & np.tril(np.ones((T, T), bool))
    mask = np.broadcast_to(mask, s.shape)
    live = mask.any(-1)
    s = np.where(mask, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse[live], want[live], atol=1e-5)
    assert (lse[~live] <= -1e29).all()  # rows without keys keep the sentinel

    bwd = ra.ring_backward_lockstep(*chunks[:3], key_lens, [o for o, _ in fwd],
                                    [l for _, l in fwd], chunks[3], causal, scale)
    for j, (name, g) in enumerate(zip(("dq", "dk", "dv"), grads)):
        got = torch.cat([b[j] for b in bwd], 2)[:, :, :T]
        np.testing.assert_allclose(got.numpy(), g, atol=1e-4, err_msg=name)


def test_merge_of_two_empty_partials_reads_as_no_key():
    """Two partials of a row that sees no key (zeros, lse -1e30) merge to
    zeros and an lse K5 still treats as dead (<= -1e29)."""
    z = torch.zeros(1, 1, 2, 4)
    l = torch.full((1, 1, 2), -1e30)
    out, lse = ra._merge(z, l, z, l)
    assert torch.equal(out, z) and (lse <= -1e29).all() and torch.isfinite(lse).all()

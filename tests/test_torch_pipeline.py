"""Pipeline parallelism in the PyTorch port (``musicstyletransfer_torch/
parallel/pipeline.py`` and ``transformer_pipeline.py``) against the JAX
package's ``pipeline_apply`` and ``pipeline_transformer_stack`` on
``conftest.py``'s virtual CPU devices, and against the sequential stack.

Most cases run the port's stages in lock step in this process
(``pipeline_apply_lockstep``); one runs a 2-process gloo world through the
real hops with autograd (``tests/torch_dist_worker.py``, scenario
``pipeline``).

Tolerances (float32 throughout): MLP forward 1e-6, MLP gradients 1e-5; the
stage stacking exactly; stack forwards 1e-5; stack gradients and the
parameters after one Adam step 1e-4.
"""

import dataclasses
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
from flax import traverse_util

from musicstyletransfer_tpu.models.config import TransformerConfig as JTransformerConfig
from musicstyletransfer_tpu.models.transformer import TransformerStack as JTransformerStack
from musicstyletransfer_tpu.parallel import make_mesh as jmake_mesh
from musicstyletransfer_tpu.parallel import pipeline_transformer_stack as jpipeline_stack
from musicstyletransfer_tpu.parallel import stack_stage_params as jstack_stage_params
from musicstyletransfer_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from musicstyletransfer_torch.convert import params_from_jax
from musicstyletransfer_torch.models import transformer as tmod
from musicstyletransfer_torch.models.config import TransformerConfig
from musicstyletransfer_torch.parallel import (pipeline_apply_lockstep,
                                               pipeline_transformer_stack,
                                               stack_stage_params, transformer_stage_fn)
from musicstyletransfer_torch.parallel.pipeline import sequential_apply
from musicstyletransfer_torch.training.optimizer import Optimizer, OptimizerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
N_LAYERS, HEADS, D, T, B = 4, 16, 64, 8, 4
LENS = np.array([T, T - 2, T - 5, 3])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def mlp_params(n_stages, d, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(scale=0.5, size=(n_stages, d, d)).astype(np.float32),
            "b": rng.normal(scale=0.1, size=(n_stages, d)).astype(np.float32)}


def jmlp(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def tmlp(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def torch_params(params, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in params.items()}


@pytest.mark.parametrize("pp,microbatches", [(2, 4), (4, 2), (4, 8)])
def test_mlp_forward_matches_jax(cpu_devices, pp, microbatches):
    params = mlp_params(pp, 8, 0)
    x = np.random.default_rng(1).normal(size=(8, 8)).astype(np.float32)
    want = jpipeline_apply(jmlp, params, jnp.asarray(x), mesh=jmake_mesh(cpu_devices[:8], tp=pp),
                           microbatches=microbatches)
    got = pipeline_apply_lockstep(tmlp, torch_params(params), torch.tensor(x), pp, microbatches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_mlp_grads_match_jax(cpu_devices):
    """The backward through the lock-step hops equals jax.grad through the
    JAX pipeline (scan + ppermute's transpose), parameters and input."""
    pp = 4
    params = mlp_params(pp, 8, 2)
    rng = np.random.default_rng(3)
    x, w = (rng.normal(size=(8, 8)).astype(np.float32) for _ in range(2))
    mesh = jmake_mesh(cpu_devices[:8], tp=pp)

    def f(p, xx):
        return jnp.sum(jpipeline_apply(jmlp, p, xx, mesh=mesh, microbatches=4) * w)

    jgp, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    tp = torch_params(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    (pipeline_apply_lockstep(tmlp, tp, tx, pp, 4) * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]), atol=1e-5)


# ---- the transformer stack --------------------------------------------------


def configs(norm_scheme="post", **kw):
    jc = JTransformerConfig(model_size=D, num_layers=N_LAYERS, num_heads=HEADS, dropout=0.0,
                            norm_scheme=norm_scheme, **kw)
    return jc, TransformerConfig.from_dict(dataclasses.asdict(jc))


def stack_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None, :] < LENS[:, None])
    return x, mask


def build_stacks(scheme):
    """A seeded JAX TransformerStack, its parameters, and the port's stack
    with the same weights; ragged PAD suffixes in the mask."""
    jc, tc = configs(scheme)
    x, mask = stack_inputs(7)
    module = JTransformerStack(config=jc, causal=True)
    params = module.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask, jnp.int32),
                         False)["params"]
    stack = tmod.TransformerStack(tc, True, torch.float32)
    stack.load_state_dict(params_from_jax(params))
    return scheme, jc, module, params, stack, x, mask


@pytest.fixture(scope="module", params=["post", "pre"])
def stacks(request):
    return build_stacks(request.param)


def test_stacking_equals_jax(stacks):
    """stack_stage_params on the port's state_dict is the JAX stacking with
    each (stage, layer) slice converted by params_from_jax, exactly."""
    _, _, _, params, stack, _, _ = stacks
    for S in (1, 2, 4):
        jst = jstack_stage_params(params, S)
        got = stack_stage_params(stack.state_dict(), S)
        for s in range(S):
            for k in range(N_LAYERS // S):
                want = params_from_jax(jax.tree.map(lambda a: np.asarray(a)[s, k], jst))
                assert set(want) == set(got)
                for name, v in want.items():
                    assert torch.equal(got[name][s, k], v), (S, s, k, name)


@pytest.mark.parametrize("pp,microbatches", [(2, 2), (4, 4)])
def test_stack_forward_matches_jax(cpu_devices, stacks, pp, microbatches):
    """Post-LN: the JAX pipelined stack. Pre-LN: JAX TransformerStack.apply,
    the sequential stack, whose final LayerNorm the JAX adapter leaves out
    (the port applies it)."""
    scheme, jc, module, params, stack, x, mask = stacks
    got = pipeline_transformer_stack(stack, torch.tensor(x), torch.tensor(mask), mesh=None,
                                     microbatches=microbatches, n_stages=pp)
    jmask = jnp.asarray(mask, jnp.int32)
    if scheme == "post":
        want = jpipeline_stack(params, jnp.asarray(x), jmask, config=jc, causal=True,
                               mesh=jmake_mesh(cpu_devices[:8], tp=pp),
                               microbatches=microbatches)
    else:
        want = module.apply({"params": params}, jnp.asarray(x), jmask, False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_pre_ln_applies_final_ln():
    """Without final_ln the pipelined pre-LN stack would differ from the
    sequential one (what the JAX adapter returns)."""
    _, _, _, params, stack, x, mask = build_stacks("pre")
    with torch.no_grad():
        got = pipeline_transformer_stack(stack, torch.tensor(x), torch.tensor(mask), mesh=None,
                                         microbatches=2, n_stages=2)
        ref = stack.eval()(torch.tensor(x), torch.tensor(mask))
    assert float((got - ref).abs().max()) <= 1e-5
    assert "final_ln" in params
    with torch.no_grad():
        raw, _ = pipeline_apply_lockstep(
            transformer_stage_fn(stack.layers[0]), stack_stage_params(stack.state_dict(), 2),
            (stack.scale * torch.tensor(x) + stack.pos_table[:T], torch.tensor(mask)), 2, 2)
    assert float((raw - ref).abs().max()) > 1e-2


def test_stack_grads_and_adam_step_match_sequential(stacks):
    """Gradients of mean(out**2) and the parameters after one Adam step
    through the pipelined stack equal the sequential stack's."""
    _, _, _, _, stack, x, mask = stacks
    stack.eval()
    results = []
    for pipelined in (True, False):
        model = tmod.TransformerStack(stack.config, True, torch.float32).eval()
        model.load_state_dict(stack.state_dict())
        xt = torch.tensor(x, requires_grad=True)
        out = (pipeline_transformer_stack(model, xt, torch.tensor(mask), mesh=None,
                                          microbatches=2, n_stages=2)
               if pipelined else model(xt, torch.tensor(mask)))
        out.pow(2).mean().backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        opt = Optimizer(list(model.parameters()), OptimizerConfig("adam", "", 1e-3))
        g = opt.flat_grad()
        opt.step(g)
        results.append((grads, xt.grad, {n: p.detach().clone()
                                         for n, p in model.named_parameters()}, g))
    (gp, gxp, pp_, flat_p), (gs, gxs, ps, flat_s) = results
    np.testing.assert_allclose(gxp.numpy(), gxs.numpy(), atol=1e-4)
    for n in gs:
        np.testing.assert_allclose(gp[n].numpy(), gs[n].numpy(), atol=1e-4, err_msg=n)
    # Adam's first step is lr * sign(g): compare where the gradient stands
    # above float32 noise (the key bias's gradient is noise: softmax ignores
    # a shared shift)
    for n in ps:
        keep = gs[n].abs() > 1e-6
        np.testing.assert_allclose(pp_[n][keep].numpy(), ps[n][keep].numpy(), atol=1e-4,
                                   err_msg=n)


def test_core_route_matches_dense(stacks):
    """use_flash_attention with attention_core_min_seq_len=1 sends every
    stage's attention through the core (K2/K3's plain versions here); the
    result equals the dense route's sequential stack."""
    scheme, _, _, _, stack, x, mask = stacks
    _, core_cfg = configs(scheme, use_flash_attention=True, attention_core_min_seq_len=1)
    core = tmod.TransformerStack(core_cfg, True, torch.float32)
    core.load_state_dict(stack.state_dict())
    calls = []
    real = tmod.attention_core

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    tmod.attention_core = counted
    try:
        xt = torch.tensor(x, requires_grad=True)
        got = pipeline_transformer_stack(core, xt, torch.tensor(mask), mesh=None,
                                         microbatches=2, n_stages=2)
        got.pow(2).mean().backward()
    finally:
        tmod.attention_core = real
    assert len(calls) == N_LAYERS * 2  # every layer, both microbatches
    xs = torch.tensor(x, requires_grad=True)
    want = stack.eval()(xs, torch.tensor(mask))
    want.pow(2).mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), xs.grad.numpy(), atol=1e-4)


# ---- a 2-process world -------------------------------------------------------


def test_two_process_world_matches_sequential(tmp_path):
    """pp=2 gloo ranks through the real hops (P2P forward, the reverse
    rotation backward, the last stage's broadcast): the MLP and a post-LN
    stack with the long recipe's ring_attention set (and the flash route's
    plain versions) under use_mesh(mesh) equal the sequential stages, with
    no ring attention and no time scatter; gradients summed over the two
    ranks' stages equal the sequential ones."""
    pp, d = 2, 8
    params = mlp_params(pp, d, 11)
    rng = np.random.default_rng(12)
    x, wt = (rng.normal(size=(8, d)).astype(np.float32) for _ in range(2))
    hx, mask = stack_inputs(13)
    jc, tc = configs("post", ring_attention=True, use_flash_attention=True,
                     flash_min_seq_len=T)
    jparams = JTransformerStack(config=jc, causal=False).init(
        jax.random.key(3), jnp.asarray(hx), jnp.asarray(mask, jnp.int32), False)["params"]
    flat = {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(jparams)).items()}
    np.savez(tmp_path / "stack.npz", **flat)
    np.savez(tmp_path / "pipeline_inputs.npz", w=params["w"], b=params["b"], x=x, wt=wt, hx=hx,
             mask=mask)
    (tmp_path / "pipeline_stack.json").write_text(json.dumps(
        {"config": dataclasses.asdict(tc), "causal": False}))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"folder": str(tmp_path), "scenarios": ["pipeline"]}))
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, str(spec), str(r), "2", port], cwd=REPO,
                              env=child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    with np.load(tmp_path / "pipeline.npz") as z:
        got = {k: z[k] for k in z.files}

    tp_ = torch_params(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    want = sequential_apply(tmlp, tp_, tx, pp)
    (want * torch.tensor(wt)).sum().backward()
    np.testing.assert_allclose(got["mlp_out"], want.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(got["mlp_grads"], torch.cat(
        [tp_["w"].grad.reshape(-1), tp_["b"].grad.reshape(-1)]).numpy(), atol=1e-5)
    np.testing.assert_allclose(got["mlp_gx"], tx.grad.numpy(), atol=1e-5)  # stage 0's

    stack = tmod.TransformerStack(tc, False, torch.float32).eval()
    stack.load_state_dict(params_from_jax(jparams))
    hs = torch.tensor(hx, requires_grad=True)
    ref = stack(hs, torch.tensor(mask))
    ref.pow(2).mean().backward()
    assert got["calls"].tolist() == [0, 0]
    np.testing.assert_allclose(got["stack_out"], ref.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(got["stack_gx"], hs.grad.numpy(), atol=1e-4)
    for name, p in stack.named_parameters():
        np.testing.assert_allclose(got[f"stack_grad/{name}"], p.grad.numpy(), atol=1e-4,
                                   err_msg=name)


# ---- the contract ------------------------------------------------------------


def test_rejects_bad_shapes(stacks):
    _, _, _, _, stack, _, _ = stacks
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="stage_params leading axis"):
        pipeline_apply_lockstep(tmlp, torch_params(mlp_params(4, 8, 0)), x, 2, 4)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply_lockstep(tmlp, torch_params(mlp_params(2, 8, 0)), x, 2, 3)
    with pytest.raises(ValueError, match="batch axis"):
        pipeline_apply_lockstep(lambda p, h: h, torch_params(mlp_params(2, 8, 0)),
                                (x, torch.zeros(4, 8)), 2, 2)
    with pytest.raises(ValueError, match="shapes and dtypes"):
        pipeline_apply_lockstep(lambda p, h: h[:, :4], torch_params(mlp_params(2, 8, 0)), x,
                                2, 2)
    with pytest.raises(ValueError, match="equal stages"):
        stack_stage_params(stack.state_dict(), 3)

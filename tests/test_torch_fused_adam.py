"""Adam's update route (``training.optimizer.update_route``) and the kernels
of ``ops.fused_adam`` as far as the CPU reaches them.

The kernels run only on a card (``tests/test_torch_gpu.py`` holds them to
the chain bit for bit there). Here: the route follows the buffer's device,
the optimizer's name and its accumulation; the counters are registered; the
launch grid; the wrappers refuse CPU tensors; and the optimizer's kernel
route, with the two kernels replaced by ``kernel_b``/``grad_stats``
written out in torch in the kernels' own order of roundings, equals the
chain bit for bit: the arguments the optimizer hands the kernels (rate, bias
corrections, norm, the guard's decision) and the arithmetic the source
does.
"""

import math

import numpy as np
import pytest
import torch

from musicstyletransfer_torch.ops import counters
from musicstyletransfer_torch.ops import fused_adam
from musicstyletransfer_torch.training.optimizer import (
    Optimizer,
    OptimizerConfig,
    update_route,
)
from adam_helpers import EXTRAS, adam_pair, assert_same_state


@pytest.mark.parametrize("device,name,k,route", [
    ("cuda", "adam", 1, "kernel"), ("cuda", "adamw", 1, "kernel"),
    ("cuda", "adam", 2, "chain"), ("cuda", "sgd", 1, "chain"), ("cuda", "rmsprop", 1, "chain"),
    ("cpu", "adam", 1, "chain"), ("cpu", "adamw", 1, "chain"), ("cpu", "sgd", 2, "chain")])
def test_route_follows_device_name_and_accumulation(device, name, k, route):
    assert update_route(torch.device(device), name, k) == route


def test_cpu_optimizer_runs_the_chain_and_counts_no_cuda_step():
    before = counters.read()
    opt = Optimizer([torch.nn.Parameter(torch.ones(5))], OptimizerConfig("adam", "", 1e-2))
    assert opt.route == "chain"
    opt.step(torch.ones(5))
    assert counters.read() == before


def test_adam_counters_are_registered_and_replayed():
    assert {"adam", "adam stats", "adam plain"} <= set(counters.COUNTERS)
    assert "adam plain" in counters.PLAIN
    assert "adam" not in counters.PLAIN and "adam stats" not in counters.PLAIN
    saved = counters.read()
    try:
        counters.reset()
        counters.add({k: int(k.startswith("adam")) for k in counters.COUNTERS})
        assert fused_adam.adam_update.launches == 1
        assert fused_adam.grad_stats.launches == 1
        assert fused_adam.adam_update.chain_cuda_runs == 1
    finally:
        counters.write(saved)


@pytest.mark.parametrize("n,sms,kernel,grid", [
    (1, 132, "update", 1), (3, 132, "update", 1), (4 * 256, 132, "update", 1),
    (4 * 256 + 3, 132, "update", 1), (4 * 256 * 5, 132, "update", 5),
    (1_690_000_000, 132, "update", 528), (1_690_000_000, 132, "stats", 1056),
    (3_000_000, 132, "stats", 1056), (3_000_000, 132, "update", 528),
    (100_000, 132, "stats", 98)])
def test_grid_from_the_length_and_the_sms(n, sms, kernel, grid):
    assert fused_adam.grid_of(n, sms, kernel) == grid


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros(8)
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam.grad_stats(x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam.adam_update(x, x.clone(), x.clone(), x.clone(), one, one, one, b1=0.9,
                               b2=0.999, eps=1e-8)


def test_grad_stats_reference_sums_in_double():
    rng = np.random.default_rng(0)
    g = rng.normal(size=10_001).astype(np.float32) * 1e3
    sq, finite = fused_adam.grad_stats_reference(torch.from_numpy(g))
    exact = math.fsum(float(x) * float(x) for x in g)
    assert bool(finite) and sq.dtype == torch.float32
    assert abs(float(sq) - exact) <= 2.0 ** -23 * exact
    for bad in (np.nan, np.inf, -np.inf):
        h = g.copy()
        h[17] = bad
        assert not bool(fused_adam.grad_stats_reference(torch.from_numpy(h))[1])


def f32(x: float) -> torch.Tensor:
    """A Python float as TensorIterator casts a scalar for a float32 op."""
    return torch.tensor(x, dtype=torch.float32)


def kernel_b(flat, mu, nu, grad, rate, bc1, bc2, *, b1, b2, eps, clip=None, max_norm=None,
             norm=None, wd=0.0, adamw_wd=0.0, apply=None):
    """``csrc/fused_adam.cu``'s ``adam_element`` on whole vectors, one torch
    op a rounding, in the source's order."""
    u = grad
    if clip is not None:
        lo, hi = f32(-clip), f32(clip)
        m = torch.where(u < lo, lo, u)
        u = torch.where(m > hi, hi, m)
    if norm is not None and not bool(norm < f32(max_norm)):
        u = (u / norm) * f32(max_norm)
    if wd != 0.0:
        u = u + f32(wd) * flat
    m_new = f32(1.0 - b1) * u + f32(b1) * mu
    v_new = f32(1.0 - b2) * (u * u) + f32(b2) * nu
    step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + f32(eps))
    if adamw_wd != 0.0:
        step = step + f32(adamw_wd) * flat
    update = rate * step
    applied = True if apply is None else bool(apply)
    if applied:
        mu.copy_(m_new)
        nu.copy_(v_new)
    flat.copy_(flat + (update if applied else torch.zeros_like(update)))
    fused_adam.adam_update.launches += 1


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("extra", sorted(EXTRAS))
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_kernel_route_equals_the_chain(monkeypatch, name, extra, skip):
    """Ten steps across a warmup and a cosine decay, with non-finite
    gradients at steps 2-3 and 7-9 (under skip_nonfinite:2 the guard skips
    two and lets the third through): parameters, moments, counts and the
    returned sum of squares of the kernel route (kernels written out in
    torch) against the chain."""
    monkeypatch.setattr(fused_adam, "adam_update", kernel_b)
    monkeypatch.setattr(fused_adam, "grad_stats", fused_adam.grad_stats_reference)
    fused_adam.adam_update.launches = 0
    extras = ",".join(x for x in (EXTRAS[extra], "warmup_steps:2,decay_steps:5",
                                  "skip_nonfinite:2" if skip else "") if x)
    rng = np.random.default_rng(11)
    init = torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32))
    kern, chain = adam_pair(init, name, extras)
    for step in range(10):
        g = torch.from_numpy((rng.normal(size=21) * 3).astype(np.float32))
        if step in (2, 3, 7, 8, 9):
            g[5] = (np.nan, np.inf, np.nan, -np.inf, np.nan)[(2, 3, 7, 8, 9).index(step)]
        assert chain.step(g.clone()) is None
        sq_kern = kern.step(g.clone())
        sq_chain = chain.sq_sum(g)
        assert_same_state(kern, chain, step)
        if bool(torch.isfinite(g).all()):
            assert float(sq_kern) == pytest.approx(float(sq_chain), rel=1e-6)
        else:
            assert not bool(torch.isfinite(sq_kern)) and not bool(torch.isfinite(sq_chain))
    assert fused_adam.adam_update.launches == 10
    if skip:  # five non-finite steps, the last three in a row: the third went through
        assert int(kern.state["total_notfinite"]) == 5
        assert int(kern.state["notfinite_count"]) == 3 and bool(torch.isnan(kern.flat).any())

"""A run's check fails where it must, at sizes a CPU test holds: the
control (the reference computed with fp8 products in the program's place)
and each fault a cell can have, planted under the timed path, make
``correct`` come out false. The chip's readings at the cells' own sizes
come from ``tools/readings.py``."""

import pytest
import torch

from helpers import run_cpu, tiny_config
from reference import model as ref


@pytest.fixture(scope="module")
def transfer_run():
    return run_cpu("canonical_convert", seed=2**31 + 3, seconds=1.0)


def test_transfer_program_passes_and_control_fails(transfer_run):
    import transfer
    from tools import readings

    result, ctx = transfer_run
    assert result["correct"]
    picked = transfer.sample(ctx.results, ctx.window_batches, ctx.seed,
                             ctx.traffic["check_tokens"])
    found = readings.control_readings(ctx.cfg, ctx.traffic, picked, ctx.midi,
                                      torch.device("cpu"))
    assert found["control_gap"] > ctx.limits["logit_gap"] >= ctx.found["logit_gap"]


@pytest.mark.parametrize("cell", ["canonical_convert"])
def test_altered_token_fails(cell, monkeypatch):
    """A token altered where K1 produces it."""
    from musicstyletransfer_torch.inference import decode

    real = decode.fused_decode

    def altered(*a, **k):
        seqs, scores = real(*a, **k)
        seqs = seqs.clone()
        col = seqs[:, 4]
        seqs[:, 4] = torch.where(col > 2, 3 + (col - 3 + 7) % 290, col)
        return seqs, scores

    monkeypatch.setattr(decode, "fused_decode", altered)
    result, ctx = run_cpu(cell, seed=11, seconds=0.5)
    assert not result["correct"] and ctx.found["logit_gap"] > ctx.limits["logit_gap"]


@pytest.mark.parametrize("cell", ["long_train_fp32", "canonical_train"])
def test_train_control_fails(cell):
    from drivers import train_window as tw

    # the program at this size reads other than at the cell's own; the chip's
    # readings at the cell's size hold it to the limits
    result, ctx = run_cpu(cell, seed=21, seconds=0.3, config=tiny_config(cell))
    batches = tw.host_batches(ctx)
    control = ref.Numerics(ref.Numerics.CONTROL[ctx.cfg["dtype"]])
    prog = tw.reference_run(ctx.cfg, batches, ctx.seed, ctx.names, control, "cpu")
    refr = tw.reference_run(ctx.cfg, batches, ctx.seed, ctx.names, ref.Numerics(), "cpu",
                            start_b=tw.b_starts(prog))
    ctl = tw.gaps(prog, refr, ctx.names)
    assert any(ctl[k] > ctx.limits[k] for k in ctx.limits)


@pytest.mark.parametrize("cell", ["long_train_fp32", "canonical_train"])
def test_unchanged_state_fails(cell, monkeypatch):
    """A step that returns its state unchanged."""
    from musicstyletransfer_torch.training.optimizer import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self, grad: None)
    result, ctx = run_cpu(cell, seed=22, seconds=0.3,
                          config=tiny_config(cell, "float32"))
    assert not result["correct"] and ctx.found["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["long_train_fp32", "canonical_train"])
def test_half_batch_fails(cell, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from musicstyletransfer_torch.training import trainer

    real = trainer.step_body

    def half(model, opt, loss, state, *tensors, **kw):
        n = tensors[0].shape[0] // 2
        return real(model, opt, loss, state, *(t[:n] for t in tensors), **kw)

    monkeypatch.setattr(trainer, "step_body", half)
    result, ctx = run_cpu(cell, seed=23, seconds=0.3,
                          config=tiny_config(cell, "float32"))
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["long_train_fp32", "canonical_train"])
def test_group_staged_wrong_fails(cell, monkeypatch):
    """A group that trains its first batch at every step of the group (the
    rest of its batches staged nowhere)."""
    from musicstyletransfer_torch.training.trainer import Trainer

    real = Trainer.train_batches
    monkeypatch.setattr(Trainer, "train_batches",
                        lambda self, group: real(self, [group[0]] * len(group)))
    result, ctx = run_cpu(cell, seed=24, seconds=0.3,
                          config=tiny_config(cell, "float32"))
    assert not result["correct"]

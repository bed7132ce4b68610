"""The plain reference against the port's CPU path at a tiny size: the same
training steps, the same transfer logits and noise, the same tokens."""

import numpy as np
import pytest
import torch

from helpers import harness, run_cpu, tiny_config
from reference import model as ref
from reference import noise, smf


@pytest.mark.parametrize("cell", ["long_train_fp32", "canonical_train"])
def test_training_steps_match_in_float32(cell):
    result, ctx = run_cpu(cell, seed=2**32 + 9, seconds=0.3, config=tiny_config(cell, "float32"))
    assert result["correct"]
    assert ctx.found["loss1_gap"] < 1e-5 and ctx.found["loss_gap_worst_group"] < 1e-5
    assert ctx.found["grad_gap"] < 1e-4 and ctx.found["grad_error"] < 1e-4
    assert ctx.found["moment2_error"] < 1e-4
    assert ctx.found["b_grad_error"] < 1e-4 and ctx.found["b_moment2_error"] < 1e-4
    assert ctx.found["change_gap"] < 1e-3 and ctx.found["b_change_gap"] < 1e-3
    # only the attention's key biases move by round-off alone (softmax ignores them)
    assert all(n.endswith("attention/w_k/bias") for n in ctx.found["left_out"])


def test_transfer_logits_and_noise_match_the_port():
    from musicstyletransfer_torch.ops.fused_decode import fused_decode_reference, gumbel_steps
    from drivers.train_window import load_weights, model_config
    from musicstyletransfer_torch.models.vae import StyleVAE

    cfg = tiny_config("canonical_convert", "float32")
    p = ref.init_params(cfg, 3, "cpu")
    model = StyleVAE(model_config(cfg)).eval()
    load_weights(model, p)
    g = torch.Generator().manual_seed(0)
    sos = torch.ones(2, 1, dtype=torch.long)
    src = torch.cat([sos, torch.randint(3, 293, (2, 6), generator=g)], 1)
    rows = torch.cat([sos, torch.randint(3, 293, (2, 9), generator=g)], 1)
    classes = torch.tensor([0, 1])
    with torch.no_grad():
        mu, _ = model.encode(src, None, classes)
        x0 = model.decode_init(mu, classes)
        _, _, logits = fused_decode_reference(model, x0, rows.shape[1], 0, mode="forced",
                                              forced_tokens=rows.int(), classes=classes)
    mine = ref.transfer_logits(p, cfg, src, rows, classes, ref.Numerics())
    assert torch.allclose(mine, logits[:, 1:], atol=1e-4, rtol=1e-4)
    key = (2**31 + 5 << 32) | 3
    port = gumbel_steps(key, 1, 9, 4, 293, torch.device("cpu"))
    for r in range(4):
        assert np.abs(noise.gumbel(key, r, 9, 293) - port[:, r].numpy()).max() < 1e-5


def test_request_tokens_match_the_service():
    from musicstyletransfer_torch.inference.service import tokens_from_midi

    cell = harness.Cell("canonical_convert")
    import transfer

    pool = transfer.requests(cell.traffic)
    assert len(pool) > 500
    for m in pool:
        assert (smf.request_tokens(m, 64) == tokens_from_midi(m, 64)).all()


def test_written_midi_reads_back():
    toks = np.array([3 + 60, 259 + 4, 131 + 60, 259 + 40, 259 + 2, 3 + 62, 1, 131 + 62])
    raw = smf.write_midi(toks)
    assert smf.note_messages(raw) == smf.expected_messages(toks) == [
        (0, 0x90, 60, 127), (120, 0x80, 60, 64), (1260, 0x90, 62, 127), (0, 0x80, 62, 64)]
    from musicstyletransfer_torch.midi import smf as port_smf

    assert len(port_smf.parse_midifile(raw).tracks) == 1

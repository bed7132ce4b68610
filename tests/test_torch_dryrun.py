"""The port's multi-process dry run (``python -m musicstyletransfer_torch.
dryrun``, the counterpart of ``__graft_entry__.dryrun_multichip``) on four
gloo CPU ranks: every leg of ``_dryrun_body`` but the XLA lowering prints
its OK line, and the run exits 0; a world that cannot form fails it."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LEGS = (
    "dryrun train step OK: mesh={'data': 2, 'model': 2}, total_loss=",
    "dryrun train step OK: mesh={'data': 4, 'model': 1}, total_loss=",
    "dryrun train step OK: mesh={'data': 1, 'model': 4}, total_loss=",
    "dryrun train step OK: mesh={'data': 2, 'model': 2} (attention core)",
    "dryrun sharded fused sample OK: mesh={'data': 4, 'model': 1}, B=8",
    "dryrun ring-attention train step OK: mesh={'data': 2, 'model': 2}",
    "dryrun pipeline OK: pp=4, microbatches=4",
    "dryrun transformer pipeline OK: 4 layers as pp=2 stages of 2",
    "dryrun GAN dp step OK: mesh={'data': 4, 'model': 1}",
    "dryrun streaming mesh OK: mesh={'data': 4, 'model': 1}, slots=4",
    "dryrun_multichip(4) OK:",
)


def env():
    e = dict(os.environ, OMP_NUM_THREADS="1")
    e.pop("XLA_FLAGS", None)
    return e


def test_dryrun_four_cpu_processes():
    res = subprocess.run([sys.executable, "-m", "musicstyletransfer_torch.dryrun",
                          "--processes", "4", "--cpu"], cwd=REPO, env=env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = [x for x in res.stdout.splitlines() if x.startswith("dryrun")]
    assert len(lines) == len(LEGS), lines
    for want, got in zip(LEGS, lines):
        assert got.startswith(want), (want, got)
    assert "OK" in lines[-1] and "SKIPPED" not in res.stdout


def test_dryrun_without_cards_refuses():
    """Without --cpu the ranks are one a card: fewer cards than processes
    is an error before any rank starts."""
    res = subprocess.run([sys.executable, "-m", "musicstyletransfer_torch.dryrun",
                          "--processes", "2"], cwd=REPO, env=env(), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "needs 2 CUDA cards" in res.stderr

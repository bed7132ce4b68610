"""Kill -9 mid-save and resume, on the port's multi-process training (the
counterpart of ``tests/test_distributed.py::TestFaultInjection``): two gloo
ranks (``tests/torch_fault_worker.py``) run the port's ``Trainer`` with DP=2
and a checkpoint every 4 steps; rank 1 SIGKILLs itself as checkpoint 3's
save begins and the test SIGKILLs rank 0 about 2 s later. A fresh pair on
the same folder resumes from the last complete checkpoint (2, or 3 if its
save won the race) with the parameters that save recorded, bit for bit,
and writes the next checkpoint; both ranks agree."""

import json
import os
import signal
import socket
import subprocess
import sys
import time

from musicstyletransfer_torch.training import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_fault_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(folder, mode):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    port = str(free_port())
    return [subprocess.Popen([sys.executable, WORKER, str(r), port, folder, mode], cwd=REPO,
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in (0, 1)]


def test_kill9_midrun_resumes_bitwise(tmp_path):
    folder = str(tmp_path / "fault-model")
    procs = spawn(folder, "crash")
    out1, err1 = procs[1].communicate(timeout=300)
    assert procs[1].returncode == -signal.SIGKILL, f"rank 1 should die by SIGKILL:\n{out1}\n{err1}"
    assert "SAVING 3" in out1
    time.sleep(2.0)
    procs[0].kill()
    out0, err0 = procs[0].communicate(timeout=60)
    assert "DURABLE 2" in out0, f"{out0}\n{err0}"
    names = os.listdir(folder)
    assert {"params.1.pt", "params.2.pt", "checksums.jsonl"} <= set(names), names
    assert ckpt.checkpoint_indices(folder)[-1] in (2, 3)

    procs = spawn(folder, "resume")
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"resume rank failed:\n{out}\n{err}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for o in outs:
        assert o["resumed_from"] in (2, 3), o
        assert o["sha_match"], o
        assert o["resumed_step"] == 4 * o["resumed_from"], o
        assert o["final_ckpt"] == o["resumed_from"] + 1, o
    assert outs[0]["resumed_from"] == outs[1]["resumed_from"]
    assert outs[0]["sha"] == outs[1]["sha"]
    final = os.path.join(folder, f"params.{outs[0]['final_ckpt']}.pt")
    assert os.path.exists(final), os.listdir(folder)
    assert ckpt.restore_checkpoint(folder, outs[0]["final_ckpt"])["step"] == \
        4 * outs[0]["final_ckpt"]

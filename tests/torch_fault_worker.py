"""One rank of the port's kill -9 resume test (gloo, JAX-free):

    python tests/torch_fault_worker.py RANK PORT FOLDER MODE

``crash``: two ranks train a tiny VAE with the port's ``Trainer`` (DP=2, a
checkpoint every 4 steps). Before each save the primary appends the sha256
of the flat parameters to ``FOLDER/checksums.jsonl``. Checkpoints 1 and 2
complete; as checkpoint 3's save begins rank 1 SIGKILLs itself, and the
test SIGKILLs rank 0 moments later.

``resume``: a fresh pair on the same folder restores the last complete
checkpoint (``Trainer._load_latest_checkpoint``, newest first), hashes the
restored parameters, trains 4 more steps and writes the next checkpoint;
prints one JSON line. ``tests/test_torch_fault.py`` drives both.
"""

import hashlib
import json
import os
import signal
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from musicstyletransfer_torch.data import MelodyDataset  # noqa: E402
from musicstyletransfer_torch.midi.codec import Melody  # noqa: E402
from musicstyletransfer_torch.models import (DecoderConfig, EncoderConfig,  # noqa: E402
                                             ModelConfig, StyleVAE, TransformerConfig,
                                             init_params)
from musicstyletransfer_torch.parallel import (ProcessShardedDataset,  # noqa: E402
                                               initialize_distributed, make_mesh)
from musicstyletransfer_torch.parallel.distributed import data_process_info  # noqa: E402
from musicstyletransfer_torch.training.optimizer import OptimizerConfig  # noqa: E402
from musicstyletransfer_torch.training.train_step import batch_tensors  # noqa: E402
from musicstyletransfer_torch.training.trainer import TrainConfig, Trainer  # noqa: E402

STEPS_PER_CKPT = 4


def main() -> None:
    rank, port, folder, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", 2, rank)
    mesh = make_mesh(1)
    melodies = {"a": [Melody(tokens=np.arange(10, 52, dtype=np.int32))],
                "b": [Melody(tokens=np.arange(12, 44, dtype=np.int32))]}
    dataset = ProcessShardedDataset(MelodyDataset(4, 4, melodies, seed=11),
                                    data_process_info(mesh))
    tc = TransformerConfig(model_size=16, num_layers=1, num_heads=2, dropout=0.1)
    model = init_params(StyleVAE(ModelConfig(EncoderConfig(tc, latent_dim=8),
                                             DecoderConfig(tc, latent_dim=8),
                                             dtype="float32")), 0)
    trainer = Trainer(TrainConfig(batch_size=4, sampling_frequency=0,
                                  checkpoint_frequency=10 ** 9, num_checkpoints_not_improved=-1,
                                  prefetch=0, log_every=10 ** 9,
                                  logdir=os.path.join(folder, f"log-{mode}-{rank}"),
                                  optimizer=OptimizerConfig("adam", "", 1e-3)),
                      model, mesh=mesh)

    def params_sha() -> str:
        flat = trainer._full(trainer.optimizer.flat)
        return hashlib.sha256(flat.detach().cpu().numpy().tobytes()).hexdigest()

    sidecar = os.path.join(folder, "checksums.jsonl")

    def record(index: int, sha: str) -> None:
        if mesh.is_primary:
            with open(sidecar, "a") as fh:
                fh.write(json.dumps({"index": index, "sha": sha}) + "\n")

    def train_steps(n: int) -> None:
        done = 0
        while done < n:
            for batch in dataset:
                trainer.train_batches([batch_tensors(batch, "cpu")])
                trainer.progress.n_batches += 1
                done += 1
                if done >= n:
                    break

    os.makedirs(folder, exist_ok=True)
    if mode == "crash":
        for index in (1, 2):
            train_steps(STEPS_PER_CKPT)
            record(index, params_sha())
            trainer._checkpoint(folder, None)
            print(f"DURABLE {index}", flush=True)
        train_steps(STEPS_PER_CKPT)
        record(3, params_sha())
        if rank == 1:  # die as checkpoint 3's save begins
            def die(flat):
                os.kill(os.getpid(), signal.SIGKILL)

            trainer._full = die
        print("SAVING 3", flush=True)
        trainer._checkpoint(folder, None)
        print("PRIMARY_WAITING", flush=True)
        time.sleep(120)  # the test SIGKILLs this rank here
        return

    assert mode == "resume", mode
    trainer._load_latest_checkpoint(folder)  # newest first, then assert_in_sync
    resumed_from = trainer.progress.n_checkpoints
    resumed_step = trainer.step
    sha = params_sha()
    expected = {}
    with open(sidecar) as fh:
        for line in fh:
            entry = json.loads(line)
            expected[entry["index"]] = entry["sha"]
    train_steps(STEPS_PER_CKPT)
    trainer._checkpoint(folder, None)
    print(json.dumps({"rank": rank, "resumed_from": resumed_from,
                      "resumed_step": resumed_step, "sha_match": expected.get(resumed_from) == sha,
                      "sha": sha, "recorded": sorted(expected),
                      "final_ckpt": trainer.progress.n_checkpoints}), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

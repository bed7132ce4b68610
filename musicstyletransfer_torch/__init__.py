"""musicstyletransfer_torch: the PyTorch / CUDA port of ``musicstyletransfer_tpu``.

The JAX package stays the reference; this package mirrors its module names
so each counterpart is found by path:

- ``midi``, ``data`` — MIDI <-> tokens, corpus loading and batching: the
                  port's own copies of the JAX package's host modules.
- ``models``    — the class-conditional sequence VAE as ``nn.Module``s,
                  loaded from a ``<model>/torch/`` export
                  (``scripts/export-torch-weights.py``) or trained here.
- ``ops``       — hand-written Hopper kernels (CUDA C++ in ``ops/csrc``,
                  built with ``nvcc`` at first use) and their plain PyTorch
                  versions.
- ``training``  — loss, metrics, optimizer, train step, checkpoints, fit loop.
- ``inference`` — encode -> class swap -> sampled decode -> MIDI files.
- ``cli``       — ``python -m musicstyletransfer_torch.cli.main`` (training)
                  and ``.cli.sample``; both run on CUDA unless ``--cpu``.

The package imports nothing of JAX or of the JAX package.
"""

__version__ = "0.2.0"

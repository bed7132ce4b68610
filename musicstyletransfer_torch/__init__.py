"""musicstyletransfer_torch: the PyTorch / CUDA port of ``musicstyletransfer_tpu``.

The JAX package stays the reference; this package mirrors its module names
so each counterpart is found by path:

- ``models``    — the class-conditional sequence VAE as ``nn.Module``s,
                  loaded from a ``<model>/torch/`` export
                  (``scripts/export-torch-weights.py``).
- ``ops``       — hand-written Hopper kernels (CUDA C++ in ``ops/csrc``,
                  built with ``nvcc`` at first use) and their plain PyTorch
                  versions.
- ``inference`` — encode -> class swap -> sampled decode -> MIDI files.
- ``cli``       — ``python -m musicstyletransfer_torch.cli.sample``.

Host layers (``midi``, ``data``, ``cli.flags``) are shared with the JAX
package, whose modules there import no JAX.
"""

__version__ = "0.1.0"

"""Training of the VAE on the PyTorch port: loss, metrics, the optax-style
optimizer, one train/eval step, checkpoints and the fit loop (counterparts
of ``musicstyletransfer_tpu/training``)."""

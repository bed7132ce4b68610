"""Sampled decode and style transfer (counterpart of ``musicstyletransfer_tpu.inference``)."""

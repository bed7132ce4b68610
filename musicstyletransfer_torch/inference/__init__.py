"""Sampled decode, style transfer, serving and mesh-sharded inference
(counterpart of ``musicstyletransfer_tpu.inference``)."""

from .decode import beam_search, decode_beam, decode_sampled, sample_sequences
from .sampler import BeamSearchSampler, Sampling, SamplerBase, get_sampler, load_inference_model
from .service import ServiceStats, StyleTransferService, TransferResult
from .sharded import (prepare_params, sharded_sample_sequences,
                      sharded_style_transfer_all_classes)
from .streaming import StreamingTransferEngine

__all__ = [
    "beam_search",
    "decode_beam",
    "decode_sampled",
    "sample_sequences",
    "BeamSearchSampler",
    "Sampling",
    "SamplerBase",
    "get_sampler",
    "load_inference_model",
    "ServiceStats",
    "StreamingTransferEngine",
    "StyleTransferService",
    "TransferResult",
    "prepare_params",
    "sharded_sample_sequences",
    "sharded_style_transfer_all_classes",
]

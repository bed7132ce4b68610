"""Sampled decode, style transfer and serving (counterpart of ``musicstyletransfer_tpu.inference``).

The sharded exports (``prepare_params``, ``sharded_*``) wait for ROADMAP
queue 1 item 9b (sharded inference)."""

from .service import ServiceStats, StyleTransferService, TransferResult
from .streaming import StreamingTransferEngine

__all__ = [
    "ServiceStats",
    "StreamingTransferEngine",
    "StyleTransferService",
    "TransferResult",
]

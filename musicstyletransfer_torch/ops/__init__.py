"""The hand-written Hopper kernels (``csrc/``) behind their wrappers and
plain PyTorch versions (counterpart of ``musicstyletransfer_tpu/ops``).
``flash_attention`` is the module of that name, which is callable as its
function ``flash_attention``."""

from . import flash_attention
from .flash_attention import flash_attention_with_lse, reference_attention
from .ring_attention import ring_attention_sharded, ring_flash_attention

__all__ = [
    "flash_attention", "flash_attention_with_lse", "reference_attention",
    "ring_attention_sharded", "ring_flash_attention",
]

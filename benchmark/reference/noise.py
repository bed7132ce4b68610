"""The sampling noise of a served decode, worked out again from its key.

The service's decode draws Gumbel-max: at step t of row r it emits
argmax_v(logit_v + g), g = -log(-log(u)), u from the low 23 bits of the
first word of Philox4x32-10 (Salmon et al., SC'11) at counter
(r, t, v, 0) under the 64-bit key, mapped strictly inside (0, 1) as
(bits & 0x7FFFFF) * 2^-23 + 2^-24. This is a plain numpy Philox written
from the paper; a served token is then judged as a greedy token of the
perturbed logits.
"""

from __future__ import annotations

import numpy as np

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_LO = np.uint64(0xFFFFFFFF)


def philox_word0(c0, c1, c2, c3, key: int) -> np.ndarray:
    """The first output word of Philox4x32-10 at counters (c0, c1, c2, c3)
    (uint64 arrays holding 32-bit words) under the 64-bit ``key``."""
    k0, k1 = key & 0xFFFFFFFF, (key >> 32) & 0xFFFFFFFF
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) for c in (c0, c1, c2, c3))
    for _ in range(10):
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ np.uint64(k0), p1 & _LO,
                          (p0 >> np.uint64(32)) ^ c3 ^ np.uint64(k1), p0 & _LO)
        k0, k1 = (k0 + _W0) & 0xFFFFFFFF, (k1 + _W1) & 0xFFFFFFFF
    return c0


def gumbel(key: int, row: int, steps: int, vocab: int) -> np.ndarray:
    """[steps, vocab] float32 noise of decode steps 1..steps of ``row``
    (index t-1 holds step t)."""
    t = np.arange(1, steps + 1, dtype=np.uint64)[:, None]
    v = np.arange(vocab, dtype=np.uint64)[None, :]
    shape = (steps, vocab)
    bits = philox_word0(np.full(shape, row, np.uint64), np.broadcast_to(t, shape),
                        np.broadcast_to(v, shape), np.zeros(shape, np.uint64), key)
    u = (bits & np.uint64(0x7FFFFF)).astype(np.float32) * np.float32(2.0 ** -23) \
        + np.float32(2.0 ** -24)
    return -np.log(-np.log(u))

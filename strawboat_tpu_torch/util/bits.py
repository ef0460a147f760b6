"""BitPacker4x packing on the host (numpy).

Counterpart of ``pack_blocks`` and ``unpack_blocks`` in
``strawboat_tpu/util/bits.py``.  The
layout is the ``bitpacking`` crate's ``BitPacker4x`` used by the reference
(src/compression/integer/bp.rs:36-86): 128 u32 values a block as 4
interleaved 32-value lanes; lane ``l`` holds ``v[l::4]`` packed LSB-first
at ``num_bits`` bits into 32-bit words, and word ``w`` of lane ``l`` is u32
index ``w*4 + l`` of the block.
"""

from __future__ import annotations

import numpy as np

BLOCK_LEN = 128  # BitPacker4x::BLOCK_LEN
_LANES = 4
_PER_LANE = BLOCK_LEN // _LANES  # 32 values per lane


def pack_blocks(values: np.ndarray, num_bits: int) -> np.ndarray:
    """(n, 128) u32 values (< 2^num_bits) → (n, num_bits*4) u32 words."""
    n = values.shape[0]
    b = num_bits
    if b == 0:
        return np.zeros((n, 0), dtype=np.uint32)
    v = values.reshape(n, _PER_LANE, _LANES)
    words = np.zeros((n, b, _LANES), dtype=np.uint32)
    for t in range(_PER_LANE):
        w0, sh = divmod(t * b, 32)
        vt = v[:, t, :]
        words[:, w0, :] |= (vt << np.uint32(sh)) if sh else vt
        if sh + b > 32:  # value t straddles into the next word
            words[:, w0 + 1, :] |= vt >> np.uint32(32 - sh)
    return words.reshape(n, b * _LANES)


def unpack_blocks(words: np.ndarray, num_bits: int) -> np.ndarray:
    """(n, num_bits*4) u32 words of same-width blocks → (n, 128) u32
    values; value ``t`` of a lane spans at most two of the lane's words."""
    n = words.shape[0]
    b = num_bits
    if b == 0:
        return np.zeros((n, BLOCK_LEN), dtype=np.uint32)
    lanes = words.reshape(n, b, _LANES)
    mask = np.uint32((1 << b) - 1) if b < 32 else np.uint32(0xFFFFFFFF)
    out = np.empty((n, _PER_LANE, _LANES), dtype=np.uint32)
    for t in range(_PER_LANE):
        w0, sh = divmod(t * b, 32)
        v = lanes[:, w0, :] >> np.uint32(sh)
        if sh + b > 32:
            v = v | (lanes[:, w0 + 1, :] << np.uint32(32 - sh))
        out[:, t, :] = v & mask
    return out.reshape(n, BLOCK_LEN)

"""The validity prelude of a simple (non-nested) page.

Counterpart of ``read_validity`` in ``strawboat_tpu/read/levels.py``
(the reference's src/read/read_basic.rs:36-63), over the port's
``util/hybrid_rle.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..util.hybrid_rle import decode_validity


def read_validity(buf, pos: int, length: int) -> Tuple[Optional[np.ndarray], int]:
    """``[u32 def_levels_len][def levels]`` → (bool validity or None when
    the page has no nulls, position after the prelude)."""
    def_len = int(np.frombuffer(buf, "<u4", 1, pos)[0])
    pos += 4
    if def_len == 0:
        return None, pos
    validity = decode_validity(bytes(buf[pos : pos + def_len]), length)
    return validity, pos + def_len

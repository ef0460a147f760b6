"""Boolean pages: the writer's raw bitmap and the reader's host decoders.

Counterpart of ``strawboat_tpu/codecs/boolean.py`` (the reference's
src/compression/boolean/).  A raw-mode body is the LSB-first bitmap of
the values, and the header's uncompressed size is the ROW count.  RLE
pages hold ``[u32 run length][u8 value]`` runs (nulls fold into the
runs) and ONE_VALUE pages one byte.  The writer emits raw NONE pages; the
RLE flag and the ratio competition (which reaches ONE_VALUE and RLE) come
with the adaptive chooser.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import Compression
from ..errors import NotYetImplementedError, OutOfSpecError
from ..util import env
from . import WriteOptions, write_header

_CHOOSER = "ROADMAP.md 'Modules to port': the port's adaptive writer chooser"


def compress_boolean(values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions) -> bytes:
    """Header + body of one boolean page: the raw bitmap."""
    if options.default_compress_ratio is not None:
        raise NotYetImplementedError(f"default_compress_ratio ({_CHOOSER})")
    if env.check_rle_env() and Compression.RLE not in options.forbidden_compressions:
        raise NotYetImplementedError(f"the boolean RLE encoder ({_CHOOSER})")
    if options.default_compression != Compression.NONE:
        raise NotYetImplementedError(
            f"default_compression={options.default_compression.name} "
            "(ROADMAP.md 'Modules to port': LZ4/Zstd compression on write)"
        )
    body = np.packbits(values.astype(np.uint8), bitorder="little").tobytes()
    return write_header(Compression.NONE, len(body), len(values)) + body


def rle_decode(buf, body: int, length: int) -> np.ndarray:
    """The bool values of an RLE body covering ``length`` rows."""
    if length == 0:
        return np.zeros(0, dtype=bool)
    rec = np.dtype({"names": ["len", "val"], "formats": ["<u4", "u1"],
                    "offsets": [0, 4], "itemsize": 5})
    avail = (len(buf) - body) // 5
    recs = np.frombuffer(buf, dtype=rec, count=avail, offset=body)
    cum = np.cumsum(recs["len"].astype(np.int64))
    k = int(np.searchsorted(cum, length, side="left")) + 1
    if k > avail or cum[k - 1] < length:
        raise OutOfSpecError("boolean RLE truncated")
    return np.repeat(recs["val"][:k] != 0, recs["len"][:k].astype(np.int64))[:length]


def one_value_decode(buf, body: int, length: int) -> np.ndarray:
    if body >= len(buf):
        raise OutOfSpecError("data size is less than 1")
    return np.full(length, buf[body] > 0, dtype=bool)

"""A roaring bitmap in its portable serialization (numpy).

Counterpart of ``serialize`` and ``deserialize`` in
``strawboat_tpu/util/roaring.py``.  The
FREQ codec stores its exception positions as a roaring bitmap (reference
src/compression/integer/freq.rs:74-78, the Rust ``roaring`` crate's
portable format):

  no-run form : u32 cookie=12346, u32 n_containers,
                then per container [u16 key, u16 cardinality-1],
                then per container u32 byte offset, then the bodies.
  run form    : u32 (12347 | (n_containers-1) << 16), a run-flag bitset
                ((n+7)/8 bytes), the headers, offsets only if n >= 4, bodies.
  container   : cardinality <= 4096 → sorted u16 array;
                else → 8 KiB bitset (1024 u64 LE words).
  run container: u16 n_runs then n_runs * [u16 start, u16 len-1].

The writer emits the no-run form only, with offsets: the reference never
calls ``run_optimize``.
"""

from __future__ import annotations

import numpy as np

from ..errors import OutOfSpecError

SERIAL_COOKIE_NO_RUNCONTAINER = 12346
SERIAL_COOKIE = 12347
NO_OFFSET_THRESHOLD = 4
_ARRAY_LIMIT = 4096


def serialize(values: np.ndarray) -> bytes:
    """Sorted distinct u32 positions → a portable roaring bitmap (no-run
    form)."""
    values = np.asarray(values, dtype=np.uint32)
    keys = (values >> 16).astype(np.uint16)
    lows = (values & 0xFFFF).astype(np.uint16)
    # one container per key: where the key changes
    starts = np.flatnonzero(np.diff(keys.astype(np.int32), prepend=-1))
    ends = np.append(starts[1:], len(values))
    bodies = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        if e - s <= _ARRAY_LIMIT:
            bodies.append(lows[s:e].astype("<u2").tobytes())
        else:
            bits = np.zeros(1 << 16, dtype=np.uint8)
            bits[lows[s:e]] = 1
            bodies.append(np.packbits(bits, bitorder="little").tobytes())
    n = len(starts)
    desc = np.empty(2 * n, dtype="<u2")
    desc[0::2] = keys[starts]
    desc[1::2] = ends - starts - 1
    sizes = np.array([len(b) for b in bodies], dtype=np.int64)
    offsets = (8 + 8 * n + np.cumsum(sizes) - sizes).astype("<u4")
    head = np.array([SERIAL_COOKIE_NO_RUNCONTAINER, n], dtype="<u4").tobytes()
    return head + desc.tobytes() + offsets.tobytes() + b"".join(bodies)


def deserialize(buf: bytes) -> np.ndarray:
    """A portable roaring bitmap → its sorted u32 positions."""
    if len(buf) < 4:
        raise OutOfSpecError("roaring bitmap truncated")
    cookie = int.from_bytes(buf[0:4], "little")
    pos = 4
    run_flags = None
    if (cookie & 0xFFFF) == SERIAL_COOKIE:
        n = (cookie >> 16) + 1
        nbytes = (n + 7) // 8
        run_flags = np.unpackbits(
            np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=pos),
            bitorder="little",
        )[:n].astype(bool)
        pos += nbytes
    elif cookie == SERIAL_COOKIE_NO_RUNCONTAINER:
        n = int.from_bytes(buf[4:8], "little")
        pos = 8
    else:
        raise OutOfSpecError(f"bad roaring cookie {cookie}")

    desc = np.frombuffer(buf, dtype="<u2", count=2 * n, offset=pos)
    pos += 4 * n
    keys = desc[0::2].astype(np.uint32)
    cards = desc[1::2].astype(np.int64) + 1
    if run_flags is None or n >= NO_OFFSET_THRESHOLD:
        pos += 4 * n  # the containers are read in turn: offsets are redundant

    chunks = []
    for i in range(n):
        card = int(cards[i])
        if run_flags is not None and run_flags[i]:
            n_runs = int.from_bytes(buf[pos : pos + 2], "little")
            pos += 2
            runs = np.frombuffer(buf, dtype="<u2", count=2 * n_runs, offset=pos)
            pos += 4 * n_runs
            starts = runs[0::2].astype(np.uint32)
            lens = runs[1::2].astype(np.uint32) + 1
            vals = np.concatenate(
                [np.arange(s, s + l, dtype=np.uint32) for s, l in zip(starts, lens)]
            ) if n_runs else np.empty(0, dtype=np.uint32)
        elif card <= _ARRAY_LIMIT:
            vals = np.frombuffer(buf, dtype="<u2", count=card, offset=pos).astype(np.uint32)
            pos += 2 * card
        else:
            words = np.frombuffer(buf, dtype="<u8", count=1024, offset=pos)
            pos += 8192
            vals = np.flatnonzero(np.unpackbits(words.view(np.uint8), bitorder="little"))
            vals = vals.astype(np.uint32)
        chunks.append((keys[i] << 16) + vals)
    if not chunks:
        return np.empty(0, dtype=np.uint32)
    return np.concatenate(chunks).astype(np.uint32)

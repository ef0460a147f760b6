"""The port's native host library: build at first use, bind with ctypes.

Counterpart of ``strawboat_tpu/native/__init__.py``, with the functions
the port calls: :func:`available`, :func:`decompress_batch`,
:func:`decompress_batch_into`, :func:`compress_batch`, :func:`int_stats`,
:func:`bp_walk`, :func:`bp_encode`, :func:`factorize`,
:func:`patas_decode_native` and :func:`patas_encode_native`
(``strawboat_native.cpp`` beside this file).

The library builds with ``g++`` at first use into ``build/`` beside this
file (git-ignored), never at import.  It links liblz4 and libzstd, and
libsnappy only where the host has ``libsnappy.so.1``; the two builds have
different file names, so a build directory copied to another host is not
taken for the other build.  :func:`available` is False when the build or
the load failed (:func:`load_error` says why); every other function then
raises, and so do :func:`decompress_batch` and :func:`compress_batch` for
Snappy where the library was built without it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..constants import Compression
from ..errors import OutOfSpecError, StrawboatError

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "strawboat_native.cpp")
BUILD = os.path.join(_HERE, "build")
_SNAPPY = "libsnappy.so.1"

_lock = threading.Lock()
_state: dict = {}  # "lib" (CDLL or None) and "error" (str or None), once tried


def _host_has_snappy() -> bool:
    try:
        ctypes.CDLL(_SNAPPY)
    except OSError:
        return False
    return True


def library_path(snappy: Optional[bool] = None) -> str:
    """Where the library is built: ``build/libstrawboat_native.so``, or
    ``build/libstrawboat_native_snappy.so`` where the host has Snappy."""
    if snappy is None:
        snappy = _host_has_snappy()
    name = "libstrawboat_native_snappy.so" if snappy else "libstrawboat_native.so"
    return os.path.join(BUILD, name)


def _build(out: str, snappy: bool) -> None:
    os.makedirs(BUILD, exist_ok=True)
    # compile to a temporary name, then rename: a process loading the
    # library side by side never sees a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp,
           "-l:liblz4.so.1", "-l:libzstd.so.1", "-lpthread"]
    if snappy:
        cmd += ["-DSB_SNAPPY", f"-l:{_SNAPPY}"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise StrawboatError(f"{' '.join(cmd)} failed:\n{proc.stderr[-2000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sb_has_snappy.restype = ctypes.c_int
    lib.sb_has_snappy.argtypes = []
    lib.sb_decompress_batch.restype = ctypes.c_int
    lib.sb_decompress_batch.argtypes = [
        ctypes.c_int, i64, ctypes.POINTER(p), ctypes.POINTER(i64),
        ctypes.POINTER(p), ctypes.POINTER(i64), ctypes.c_int,
    ]
    lib.sb_bp_walk.restype = i64
    lib.sb_bp_walk.argtypes = [p, i64, i64, i64, p]
    lib.sb_bp_encode.restype = i64
    lib.sb_bp_encode.argtypes = [p, i64, p, p]
    for fn in (lib.sb_factorize_u64, lib.sb_factorize_u32):
        fn.restype = i64
        fn.argtypes = [p, i64, p, p, i64]
    lib.sb_patas_decode.restype = ctypes.c_int
    lib.sb_patas_decode.argtypes = [p, i64, i64, ctypes.c_int, p]
    lib.sb_patas_encode.restype = i64
    lib.sb_patas_encode.argtypes = [p, i64, ctypes.c_int, p]
    lib.sb_compress_bound.restype = i64
    lib.sb_compress_bound.argtypes = [ctypes.c_int, i64]
    lib.sb_compress_batch.restype = ctypes.c_int
    lib.sb_compress_batch.argtypes = [
        ctypes.c_int, i64, ctypes.POINTER(p), ctypes.POINTER(i64),
        ctypes.POINTER(p), ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.c_int,
    ]
    for kind in ("i", "u"):
        for bits in (8, 16, 32, 64):
            fn = getattr(lib, f"sb_int_stats_{kind}{bits}")
            fn.restype = ctypes.c_int
            fn.argtypes = [p, p, i64, p]


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        lib, error = None, None
        try:
            snappy = _host_has_snappy()
            out = library_path(snappy)
            if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(_SRC):
                _build(out, snappy)
            lib = ctypes.CDLL(out)
            _bind(lib)
        except (OSError, subprocess.SubprocessError, StrawboatError) as e:
            lib, error = None, f"{type(e).__name__}: {e}"
        _state.update(lib=lib, error=error)
        return lib


def available() -> bool:
    """Whether the library built and loaded on this host."""
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library did not build or load (None when it did)."""
    _load()
    return _state.get("error")


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise StrawboatError(f"the native library did not build or load: {_state.get('error')}")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _require_codec(codec: int) -> ctypes.CDLL:
    lib = _require()
    if codec == Compression.SNAPPY and not lib.sb_has_snappy():
        raise StrawboatError(
            f"SNAPPY pages need {_SNAPPY}, which this host lacks: the native "
            "library was built without Snappy"
        )
    return lib


def _u8(buf) -> np.ndarray:
    return buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, dtype=np.uint8)


def _run_batch(codec: int, inputs, out_ptrs, out_lens) -> None:
    """Decompress page ``i`` of ``inputs`` into ``out_lens[i]`` bytes at
    address ``out_ptrs[i]``, on native threads."""
    lib = _require_codec(codec)
    n = len(inputs)
    in_bufs = [_u8(b) for b in inputs]
    in_ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in in_bufs])
    in_lens = (ctypes.c_int64 * n)(*[b.size for b in in_bufs])
    outs = (ctypes.c_void_p * n)(*out_ptrs)
    sizes = (ctypes.c_int64 * n)(*[int(size) for size in out_lens])
    rc = lib.sb_decompress_batch(int(codec), n, in_ptrs, in_lens, outs, sizes, 0)
    if rc != 0:
        raise OutOfSpecError(f"native batch decompression failed (rc={rc})")


def decompress_batch(codec: int, inputs, out_lens) -> List[np.ndarray]:
    """Decompress a batch of pages of one codec in parallel native threads.

    inputs: bytes-like or uint8 arrays; out_lens: each page's decompressed
    size.  Returns uint8 arrays."""
    outs = [np.empty(int(size), dtype=np.uint8) for size in out_lens]
    _run_batch(codec, inputs, [o.ctypes.data for o in outs], out_lens)
    return outs


def decompress_batch_into(codec: int, inputs, out_buf: np.ndarray, out_offsets, out_lens) -> None:
    """Decompress pages in parallel straight into one buffer: page ``i``
    fills ``out_buf[out_offsets[i] : out_offsets[i] + out_lens[i]]``, with
    no allocation per page.  ``out_buf``: a C-contiguous uint8 array that
    holds every slice (checked)."""
    if out_buf.dtype != np.uint8 or not out_buf.flags.c_contiguous:
        raise TypeError("out_buf must be a C-contiguous uint8 array")
    offs = np.asarray(out_offsets, dtype=np.int64)
    lens = np.asarray(out_lens, dtype=np.int64)
    if len(offs) != len(inputs) or len(lens) != len(inputs):
        raise ValueError("one offset and one length per page")
    if len(offs) and (offs.min() < 0 or int((offs + lens).max()) > out_buf.size):
        raise ValueError("a page's slice lies outside out_buf")
    base = out_buf.ctypes.data
    _run_batch(codec, inputs, [base + int(o) for o in offs], lens)


def compress_batch(codec: int, inputs) -> List[bytes]:
    """Compress each of ``inputs`` (bytes-like or uint8 arrays) with one
    byte codec (LZ4 block format, Zstd frames at level 0, raw Snappy), on
    native threads: the bytes of the reference's ``common.compress``."""
    lib = _require_codec(codec)
    n = len(inputs)
    if n == 0:
        return []
    in_bufs = [np.ascontiguousarray(_u8(b)) for b in inputs]
    caps = [int(lib.sb_compress_bound(int(codec), b.size)) for b in in_bufs]
    if min(caps) < 0:
        raise StrawboatError(f"codec {codec} is not a byte codec of this build")
    outs = [np.empty(max(c, 1), dtype=np.uint8) for c in caps]
    lens = (ctypes.c_int64 * n)()
    rc = lib.sb_compress_batch(
        int(codec), n, (ctypes.c_void_p * n)(*[b.ctypes.data for b in in_bufs]),
        (ctypes.c_int64 * n)(*[b.size for b in in_bufs]),
        (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs]),
        (ctypes.c_int64 * n)(*[o.size for o in outs]), lens, 0)
    if rc != 0:
        raise OutOfSpecError(f"native compression failed (rc={rc})")
    return [o[: lens[i]].tobytes() for i, o in enumerate(outs)]


def int_stats(values: np.ndarray, validity: Optional[np.ndarray]) -> np.ndarray:
    """One-pass stats of an integer page (any width 1..8, signed or not):
    int64 ``[min, max, null_count, run_count, is_sorted, unique_count,
    top_value, max_count]``, min / max / top as the int64 holding the
    value's bits (zero-extended for unsigned types)."""
    lib = _require()
    dtype = values.dtype
    fn = getattr(lib, f"sb_int_stats_{dtype.kind}{dtype.itemsize * 8}")
    v = np.ascontiguousarray(values)
    mask = None if validity is None else np.ascontiguousarray(validity, dtype=np.uint8)
    out = np.zeros(8, dtype=np.int64)
    fn(_ptr(v), None if mask is None else _ptr(mask), len(v), _ptr(out))
    return out


def bp_walk(buf: np.ndarray, body: int, n_blocks: int) -> Tuple[np.ndarray, int]:
    """Walk the block headers of a bit-packed page from ``body`` → (each
    block's width as uint8, end offset).  Raises on truncated input."""
    lib = _require()
    nbs = np.empty(n_blocks, dtype=np.uint8)
    end = lib.sb_bp_walk(_ptr(buf), buf.size, body, n_blocks, _ptr(nbs))
    if end < 0:
        raise OutOfSpecError("bitpacked page truncated")
    return nbs, int(end)


def bp_encode(payload_blocks: np.ndarray, width_blocks: np.ndarray) -> bytes:
    """(n, 128) u32 blocks → ``[u8 num_bits][packed words]`` per block, a
    block's width being that of the OR of its ``width_blocks`` row."""
    lib = _require()
    payload_blocks = np.ascontiguousarray(payload_blocks, dtype=np.uint32)
    width_blocks = np.ascontiguousarray(width_blocks, dtype=np.uint32)
    out = np.empty(payload_blocks.shape[0] * (1 + 32 * 16), dtype=np.uint8)
    written = lib.sb_bp_encode(_ptr(payload_blocks), payload_blocks.shape[0],
                               _ptr(width_blocks), _ptr(out))
    return out[:written].tobytes()


def factorize(values: np.ndarray, max_uniq: int = 1 << 62):
    """First-occurrence factorization of a u32 or u64 array → (u32 codes,
    distinct values), or None when the distinct count exceeds
    ``max_uniq``."""
    lib = _require()
    if values.dtype not in (np.uint64, np.uint32):
        raise TypeError(f"factorize takes uint32 or uint64, got {values.dtype}")
    values = np.ascontiguousarray(values)
    n = len(values)
    codes = np.empty(n, dtype=np.uint32)
    uniq = np.empty(min(n, max_uniq) if n else 1, dtype=values.dtype)
    fn = lib.sb_factorize_u64 if values.dtype == np.uint64 else lib.sb_factorize_u32
    n_uniq = fn(_ptr(values), n, _ptr(codes), _ptr(uniq), int(min(max_uniq, max(n, 1))))
    if n_uniq < 0:
        return None
    return codes, uniq[:n_uniq]


def patas_decode_native(buf: np.ndarray, pos: int, length: int, dtype) -> np.ndarray:
    """``length`` PATAS-coded f32 or f64 values at ``buf[pos:]`` → a numpy
    array of ``dtype``.  Raises on a stream that ends early."""
    lib = _require()
    dtype = np.dtype(dtype)
    width = dtype.itemsize
    out = np.empty(length, dtype=np.uint64)
    src = np.ascontiguousarray(buf[pos:], dtype=np.uint8)
    rc = lib.sb_patas_decode(_ptr(src), src.size, length, width, _ptr(out))
    if rc != 0:
        raise OutOfSpecError(f"native patas decode failed (rc={rc})")
    return out.astype(f"<u{width}").view(dtype)


def patas_encode_native(values: np.ndarray) -> bytes:
    """f32 or f64 values → their PATAS stream (the reference's layout)."""
    lib = _require()
    width = values.dtype.itemsize
    bits = np.ascontiguousarray(values).view(f"<u{width}").astype(np.uint64)
    n = len(bits)
    if n == 0:
        return b""
    out = np.empty(n * (width + 2) + width, dtype=np.uint8)
    written = lib.sb_patas_encode(_ptr(bits), n, width, _ptr(out))
    return out[:written].tobytes()

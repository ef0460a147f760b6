"""The planned whole-column host read: page headers parse in one pass,
then every page body decompresses on native threads straight into the
column's final buffer, wrapped as an arrow array without a copy.

Counterpart of ``strawboat_tpu/read/fast.py`` (the host side of the
reference's batch read, src/read/batch_read.rs:27-64).  It covers flat
fixed-width columns whose pages mix raw (NONE / LZ4 / Zstd / Snappy),
BITPACKING, DELTA_BITPACKING, ONE_VALUE and DICT pages, and string
columns whose pages are all of the dictionary family (DICT, FREQ,
ONE_VALUE) or all raw (with ONE_VALUE).  Any other column, and every
column without the native library, gives None: the general reader
(``read/batch_read.py``) takes it.  pyarrow is imported where an array is
built.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from .. import native
from ..codecs import decompress_raw, read_header
from ..codecs.binary import parse_len_prefixed
from ..columns import pa_type
from ..constants import Compression
from ..errors import OutOfSpecError
from ..meta import ColumnMeta
from ..schema import Field, int_storage
from ..util import roaring
from .levels import read_validity

_FAST_FLOATS = {"float32": np.float32, "float64": np.float64}


class ReadArena:
    """Output buffers recycled across host reads.

    Once decoding runs on native threads, the fresh output buffer is the
    read's main cost: the kernel zeroes and faults in every page of it.
    An arena hands the same buffers back on the next read, the batch
    read's counterpart of the reference's page-buffer recycling
    (``PageIterator::swap_buffer``, src/read/mod.rs:26-57).

    Arrays a read returns through an arena alias its buffers and are
    INVALIDATED by the next read that passes the same arena; copy them out
    to keep them longer (or pass no arena).
    """

    def __init__(self) -> None:
        self._free: Dict[int, List[np.ndarray]] = {}
        self._lent: List[np.ndarray] = []
        # ``read_table`` reads its columns from a thread pool that shares
        # one arena
        self._lock = threading.Lock()

    def get(self, nbytes: int) -> np.ndarray:
        """A uint8 buffer of exactly ``nbytes``, recycled when one is free."""
        with self._lock:
            bucket = self._free.get(nbytes)
            buf = bucket.pop() if bucket else np.empty(nbytes, dtype=np.uint8)
            self._lent.append(buf)
        return buf

    def recycle(self) -> None:
        """Take back every buffer lent since the last recycle (called when
        a read starts: the previous read's arrays are then invalid)."""
        with self._lock:
            for buf in self._lent:
                self._free.setdefault(buf.nbytes, []).append(buf)
            self._lent.clear()


def _fixed_np_dtype(field: Field) -> Optional[np.dtype]:
    """The numpy dtype whose bytes are the arrow values buffer of a flat
    integer, temporal or float32 / float64 field, else None."""
    if field.is_flat_int:
        return np.dtype(int_storage(field.dtype))
    if field.is_flat_float and field.dtype in _FAST_FLOATS:
        return np.dtype(_FAST_FLOATS[field.dtype])
    return None


def _null_bitmap(validities, meta: ColumnMeta):
    """The column's arrow validity buffer, or None when no page has nulls."""
    import pyarrow as pa

    if not any(v is not None for v in validities):
        return None
    bits = np.concatenate([np.ones(p.num_values, dtype=bool) if v is None else v
                           for v, p in zip(validities, meta.pages)])
    return pa.py_buffer(np.packbits(bits, bitorder="little").tobytes())


def _raw_u32_codes(codec: Compression, buf, body: int, csize: int, n: int) -> np.ndarray:
    """A DICT page's index subpage under a byte codec → its u32 codes."""
    (raw,) = decompress_raw(codec, [np.asarray(buf[body : body + csize], dtype=np.uint8)], [n * 4])
    return np.frombuffer(raw, np.uint32, n)


def read_binary_column_fast(file_bytes: np.ndarray, meta: ColumnMeta, field: Field):
    """A flat string / binary column of dictionary-family pages or of raw
    pages → ``pa.Array``, else None.

    DICT pages decode their codes in one native walk a page and their
    dictionaries concatenate, FREQ pages become a dictionary of their top
    value and exceptions, a ONE_VALUE page a dictionary of one; one arrow
    ``take`` (null codes give null rows) builds the strings.  Raw pages
    take :func:`_read_raw_binary_column`."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if not native.available() or not field.is_flat_string:
        return None
    t = pa_type(field)
    nullable = bool(field.nullable)
    odtype = np.dtype(np.int64 if field.dtype.startswith("large_") else np.int32)
    jobs = []  # (num_values, buf, index body, pa dictionary, (is_delta, raw codes))
    # (num_values, codec or -1, offsets block or the constant, offsets
    # bytes, values block, values bytes)
    raw_jobs = []
    n_freq = 0
    validities = []
    pos = meta.offset
    for page in meta.pages:
        page_end = pos + page.length
        buf = file_bytes[pos:page_end]
        pos = page_end
        p = 0
        if nullable:
            v, p = read_validity(buf, 0, page.num_values)
            validities.append(v)
        codec, csize, _us, body = read_header(buf, p)
        if codec.raw_mode:
            # two raw blocks: zero-based offsets, then the bytes
            codec2, csize2, usize2, body2 = read_header(buf, body + csize)
            if codec2 != codec:
                return None
            raw_jobs.append((page.num_values, int(codec), buf[body : body + csize],
                             (page.num_values + 1) * odtype.itemsize,
                             buf[body2 : body2 + csize2], usize2))
            continue
        if codec == Compression.ONE_VALUE:
            # [u32 len][bytes]: a dictionary of one, or a constant run
            ln = int(np.frombuffer(buf, "<u4", 1, body)[0])
            val = bytes(buf[body + 4 : body + 4 + ln])
            jobs.append((page.num_values, None, None, pa.array([val], pa.binary()),
                         (False, np.zeros(page.num_values, dtype=np.uint32))))
            raw_jobs.append((page.num_values, -1, val, 0, None, 0))
            continue
        if codec == Compression.FREQ:
            # [u64 top_len][top][u32 size][roaring][[u64 len][bytes] per
            # exception]: the dictionary [top, exceptions...], code 0 but
            # at the exceptions (binary/freq.rs:44-145)
            top_len = int(np.frombuffer(buf, "<u8", 1, body)[0])
            fp = body + 8
            top = bytes(buf[fp : fp + top_len])
            fp += top_len
            bm_size = int(np.frombuffer(buf, "<u4", 1, fp)[0])
            positions = roaring.deserialize(bytes(buf[fp + 4 : fp + 4 + bm_size]))
            sets = [top] + parse_len_prefixed(buf, fp + 4 + bm_size, len(positions))[0]
            codes = np.zeros(page.num_values, dtype=np.uint32)
            codes[np.asarray(positions, dtype=np.int64)] = np.arange(
                1, len(positions) + 1, dtype=np.uint32)
            jobs.append((page.num_values, None, None, pa.array(sets, pa.binary()), (False, codes)))
            n_freq += 1
            continue
        if codec != Compression.DICT:
            return None
        icodec, icsize, _ius, ibody = read_header(buf, body)
        if icodec in (Compression.BITPACKING, Compression.DELTA_BITPACKING):
            spec = (icodec == Compression.DELTA_BITPACKING, None)
        elif icodec.raw_mode:
            spec = (False, _raw_u32_codes(icodec, buf, ibody, icsize, page.num_values))
        else:
            return None
        vpos = ibody + icsize
        count = int(np.frombuffer(buf, "<u4", 1, vpos)[0])
        if count == 0:
            return None
        sets, _end = parse_len_prefixed(buf, vpos + 4, count)
        jobs.append((page.num_values, buf, ibody, pa.array(sets, pa.binary()), spec))
    n_dict = sum(1 for j in jobs if j[1] is not None) + n_freq
    n_raw = sum(1 for j in raw_jobs if j[1] >= 0)
    if n_dict and n_raw:
        return None  # dictionary and raw pages mixed: the general reader
    if n_raw or (not n_dict and raw_jobs):
        return _read_raw_binary_column(raw_jobs, meta, field, odtype, validities)
    if not jobs:
        return None  # no pages: the general reader gives the empty array
    n_rows = int(sum(j[0] for j in jobs))
    dicts = [j[3] for j in jobs]
    bases = np.zeros(len(dicts), dtype=np.int64)
    bases[1:] = np.cumsum([len(d) for d in dicts[:-1]])
    all_dict = pa.concat_arrays(dicts) if len(dicts) > 1 else dicts[0]
    codes = np.empty(n_rows, dtype=np.int64)
    row = 0
    for (num_values, buf, ibody, _d, (is_delta, raw_idx)), base in zip(jobs, bases):
        if raw_idx is not None:
            vals = raw_idx[:num_values]
        else:
            vals, _end = native.bp_decode(buf, ibody, (num_values + 127) // 128)
            vals = vals[:num_values]
            if is_delta:
                vals = np.cumsum(vals, dtype=np.uint32)
        np.add(vals, base, out=codes[row : row + num_values])
        row += num_values
    mask = None
    if nullable and any(v is not None for v in validities):
        mask = ~np.concatenate([np.ones(p.num_values, dtype=bool) if v is None else v
                                for v, p in zip(validities, meta.pages)])
    try:
        arr = pc.take(all_dict, pa.array(codes, mask=mask))
    except pa.ArrowIndexError as e:
        raise OutOfSpecError(f"dict index out of range: {e}") from None
    return arr.cast(t) if arr.type != t else arr


def _read_raw_binary_column(raw_jobs, meta: ColumnMeta, field: Field, odtype, validities):
    """Raw two-block string pages (and ONE_VALUE pages, their constant
    inline): every offsets block and every values block decompresses in
    one threaded native batch straight into the final buffers; each page's
    offsets are rebased by a vectorized add."""
    import pyarrow as pa

    n_rows = int(sum(j[0] for j in raw_jobs))
    n_pages = len(raw_jobs)
    counts = np.asarray([j[0] for j in raw_jobs], dtype=np.int64)
    val_lens = np.asarray([j[0] * len(j[2]) if j[1] < 0 else j[5] for j in raw_jobs],
                          dtype=np.int64)
    val_offs = np.zeros(n_pages + 1, dtype=np.int64)
    np.cumsum(val_lens, out=val_offs[1:])
    values_buf = pa.allocate_buffer(int(val_offs[-1]))
    values = np.frombuffer(values_buf, np.uint8) if val_offs[-1] else np.empty(0, np.uint8)
    # page i's (n_i + 1) offsets land after those of the pages before it
    obytes = (counts + 1) * odtype.itemsize
    ooffs = np.zeros(n_pages + 1, dtype=np.int64)
    np.cumsum(obytes, out=ooffs[1:])
    offs_all = np.empty(int(ooffs[-1]), dtype=np.uint8)
    i = 0
    while i < n_pages:
        j = i + 1
        while j < n_pages and raw_jobs[j][1] == raw_jobs[i][1]:
            j += 1
        codec = raw_jobs[i][1]
        if codec < 0:  # ONE_VALUE pages fill their value slices
            for k in range(i, j):
                nv, val = raw_jobs[k][0], raw_jobs[k][2]
                if len(val):
                    values[val_offs[k] : val_offs[k + 1]] = np.tile(np.frombuffer(val, np.uint8), nv)
        else:
            native.decompress_batch_into(codec, [r[2] for r in raw_jobs[i:j]], offs_all,
                                         ooffs[i:j], obytes[i:j])
            native.decompress_batch_into(codec, [r[4] for r in raw_jobs[i:j]], values,
                                         val_offs[i:j], val_lens[i:j])
        i = j
    offs_typed = offs_all.view(odtype)
    out_offs_buf = pa.allocate_buffer((n_rows + 1) * odtype.itemsize)
    out_offs = np.frombuffer(out_offs_buf, odtype)
    out_offs[0] = 0
    row = 0
    for k in range(n_pages):
        nv = int(counts[k])
        dst = out_offs[row + 1 : row + nv + 1]
        if raw_jobs[k][1] < 0:  # a constant's stride
            ln = len(raw_jobs[k][2])
            np.add(np.arange(1, nv + 1, dtype=odtype) * odtype.type(ln),
                   odtype.type(val_offs[k]), out=dst)
        else:
            opos = int(ooffs[k]) // odtype.itemsize
            np.add(offs_typed[opos + 1 : opos + nv + 1], odtype.type(val_offs[k]), out=dst)
        row += nv
    bitmap = _null_bitmap(validities, meta) if field.nullable else None
    return pa.Array.from_buffers(pa_type(field), n_rows, [bitmap, out_offs_buf, values_buf])


def read_column_fast(file_bytes: np.ndarray, meta: ColumnMeta, field: Field,
                     arena: Optional[ReadArena] = None):
    """A flat fixed-width column → ``pa.Array``, or None when a page is
    RLE / FREQ / PATAS, a DICT page has an empty dictionary, or the native
    library is missing.

    Raw runs decompress on native threads into the final buffer; bit-packed
    pages decode in one native pass each; ONE_VALUE pages fill; DICT pages
    take one native call (codes and gather, threaded over pages) against
    their concatenated dictionaries.  With ``arena`` the values buffer is
    the arena's (see :class:`ReadArena` for how long it stays valid)."""
    import pyarrow as pa

    np_dtype = _fixed_np_dtype(field)
    if np_dtype is None or not native.available():
        return None
    width = np_dtype.itemsize
    raw_jobs = []  # (codec, body, row, bytes)
    bp_jobs = []  # (buf, body, num_values, row, is_delta)
    dict_jobs = []  # (buf or raw codes, body or None, num_values, row, dictionary, kind)
    one_jobs = []  # (value bytes, num_values, row)
    validities = []
    pos, row = meta.offset, 0
    for page in meta.pages:
        page_end = pos + page.length
        buf = file_bytes[pos:page_end]
        pos = page_end
        p = 0
        if field.nullable:
            v, p = read_validity(buf, 0, page.num_values)
            validities.append(v)
        codec, csize, _us, body = read_header(buf, p)
        if codec == Compression.DICT:
            icodec, icsize, _ius, ibody = read_header(buf, body)
            if icodec == Compression.BITPACKING:
                spec = (buf, ibody, 0)
            elif icodec == Compression.DELTA_BITPACKING:
                spec = (buf, ibody, 2)
            elif icodec.raw_mode:
                # a tail page's codes ride a byte codec
                codes = _raw_u32_codes(icodec, buf, ibody, icsize, page.num_values)
                spec = (codes.view(np.uint8), None, 1)
            else:
                return None
            vpos = ibody + icsize
            count = int(np.frombuffer(buf, "<u4", 1, vpos)[0])
            if count == 0:
                return None  # a page of nulls: the general reader
            dvals = np.frombuffer(buf, np_dtype, count, vpos + 4)
            dict_jobs.append((spec[0], spec[1], page.num_values, row, dvals, spec[2]))
        elif codec in (Compression.BITPACKING, Compression.DELTA_BITPACKING):
            if width != 4 or np_dtype.kind not in "iu":
                return None  # the reference bit-packs 4-byte integers only (bp.rs:92-100)
            bp_jobs.append((buf, body, page.num_values, row,
                            codec == Compression.DELTA_BITPACKING))
        elif codec == Compression.ONE_VALUE:
            one_jobs.append((bytes(buf[body : body + width]), page.num_values, row))
        elif codec.raw_mode:
            raw_jobs.append((int(codec), buf[body : body + csize], row, page.num_values * width))
        else:
            return None
        row += page.num_values
    total = row * width
    if arena is not None:
        out = arena.get(total)
        out_buf = pa.py_buffer(out)
    else:
        # arrow's pool recycles freed buffers, where a fresh np.empty pays
        # page zeroing and first touch on every byte
        out_buf = pa.allocate_buffer(total)
        out = np.frombuffer(out_buf, np.uint8) if total else np.empty(0, np.uint8)
    out_typed = out.view(np_dtype)
    i = 0
    while i < len(raw_jobs):
        j = i + 1
        while j < len(raw_jobs) and raw_jobs[j][0] == raw_jobs[i][0]:
            j += 1
        native.decompress_batch_into(raw_jobs[i][0], [c[1] for c in raw_jobs[i:j]], out,
                                     [c[2] * width for c in raw_jobs[i:j]],
                                     [c[3] for c in raw_jobs[i:j]])
        i = j
    for buf, body, nv, r, is_delta in bp_jobs:
        vals, _end = native.bp_decode(buf, body, (nv + 127) // 128)
        vals = vals[:nv]
        if is_delta:
            vals = np.cumsum(vals, dtype=np.uint32)
        out_typed[r : r + nv] = vals.view(np_dtype)
    for vb, nv, r in one_jobs:
        out_typed[r : r + nv] = np.frombuffer(vb, np_dtype, 1)[0]
    if dict_jobs:
        dicts = [j[4] for j in dict_jobs]
        bases = np.zeros(len(dicts), dtype=np.int64)
        bases[1:] = np.cumsum([len(d) for d in dicts[:-1]])
        native.dict_column_decode(
            [(b, body, nv, r, base, kind) for (b, body, nv, r, _d, kind), base in zip(dict_jobs, bases)],
            np.ascontiguousarray(np.concatenate(dicts)), out_typed)
    bitmap = _null_bitmap(validities, meta) if field.nullable else None
    return pa.Array.from_buffers(pa_type(field), row, [bitmap, out_buf])

"""Damaged files and the writer's state machine: the port reacts as the
JAX package does.

Mirrors ``tests/test_corruption.py`` (the reference's explicit size
guards, e.g. integer/dict.rs:80-86): a truncated file, a bad codec byte
and a clobbered page body raise from ``read_table`` (and from
``scan_file``) with the JAX functions' errors; ``NativeWriter`` refuses a
write before ``start``, a second ``start``, a second ``write`` and a
second ``finish``; a damaged zone block reads as no zones.  A binary
DICT page whose codes pass its dictionary, or whose body runs past its
buffer, raises ``OutOfSpecError`` from the port's page decoder.
"""

import io
import struct

import numpy as np
import pyarrow as pa
import pytest

from strawboat_tpu import errors as ref_errors
from strawboat_tpu.api import read_table as ref_read_table, write_file as ref_write
from strawboat_tpu.exec.pruning import read_zones as ref_read_zones
from strawboat_tpu.exec.scan import scan_file as ref_scan
from strawboat_tpu_torch import errors
from strawboat_tpu_torch.api import read_table, write_file
from strawboat_tpu_torch.exec import scan_file
from strawboat_tpu_torch.exec.pruning import read_zones
from test_torch_api import options


@pytest.fixture
def valid_file(tmp_path):
    path = str(tmp_path / "v.str")
    table = pa.table({"a": pa.array(np.arange(1000, dtype=np.int64))})
    write_file(path, table, options=options("LZ4", None, 256)[1])
    return path


def _mutate(path, out, fn):
    raw = bytearray(open(path, "rb").read())
    fn(raw)
    with open(out, "wb") as f:
        f.write(raw)
    return out


def _same_error(path, port_error, ref_error):
    """``read_table`` and ``scan_file`` of both packages raise the named
    errors (the port's and the JAX package's of the same name)."""
    for call in (lambda: read_table(path), lambda: scan_file(path, "cpu")):
        with pytest.raises(port_error):
            call()
    for call in (lambda: ref_read_table(path), lambda: ref_scan(path)):
        with pytest.raises(ref_error):
            call()


def test_truncated_footer(valid_file, tmp_path):
    out = str(tmp_path / "t.str")
    raw = open(valid_file, "rb").read()
    with open(out, "wb") as f:
        f.write(raw[: len(raw) // 2])
    _same_error(out, OSError, OSError)


def test_corrupt_codec_id(valid_file, tmp_path):
    out = _mutate(valid_file, str(tmp_path / "c.str"), lambda raw: raw.__setitem__(8, 99))
    _same_error(out, errors.StrawboatError, ref_errors.StrawboatError)
    _same_error(out, errors.OutOfSpecError, ref_errors.OutOfSpecError)


def test_corrupt_compressed_body(valid_file, tmp_path):
    def clobber(raw):
        for i in range(20, 60):
            raw[i] = 0xAB

    out = _mutate(valid_file, str(tmp_path / "b.str"), clobber)
    _same_error(out, errors.OutOfSpecError, ref_errors.OutOfSpecError)


def test_writer_state_machine():
    from strawboat_tpu.write.writer import NativeWriter as RefWriter
    from strawboat_tpu_torch.write import NativeWriter

    table = pa.table({"a": pa.array([1], type=pa.int64())})
    ref_opts, opts = options(ratio=None)
    for writer, err in ((NativeWriter(io.BytesIO(), table.schema, opts), errors.OutOfSpecError),
                        (RefWriter(io.BytesIO(), table.schema, ref_opts), ref_errors.OutOfSpecError)):
        with pytest.raises(err, match="started before"):
            writer.write(table)
        with pytest.raises(err, match="written before"):
            writer.finish()
        writer.start()
        with pytest.raises(err, match="started once"):
            writer.start()
        writer.write(table)
        with pytest.raises(err, match="one RowGroup"):
            writer.write(table)
        writer.finish()
        with pytest.raises(err, match="written before"):
            writer.finish()
    with pytest.raises(errors.OutOfSpecError, match="arity"):
        w = NativeWriter(io.BytesIO(), table.schema, opts)
        w.start()
        w.write(table.append_column("b", pa.array([2])))


def _zone_file(tmp_path):
    table = pa.table({"k": pa.array(np.arange(4096, dtype=np.int64))})
    path = str(tmp_path / "z.str")
    write_file(path, table, options=options("LZ4", None, 1024, zone_maps=True)[1])
    return path


def test_zone_block_truncated_payload_ignored(tmp_path):
    path = _zone_file(tmp_path)
    assert read_zones(path) is not None and ref_read_zones(path) is not None
    data = bytearray(open(path, "rb").read())
    schema_size, meta_size = struct.unpack("<II", bytes(data[-16:-8]))
    data[len(data) - 16 - meta_size - schema_size - 8] ^= 0xFF  # the payload's length
    bad = str(tmp_path / "bad.str")
    open(bad, "wb").write(bytes(data))
    assert read_zones(bad) is None and ref_read_zones(bad) is None
    assert scan_file(bad, "cpu").num_rows == 4096


def test_file_without_zone_block_reads_none(tmp_path):
    table = pa.table({"k": pa.array(np.arange(128, dtype=np.int64))})
    path = str(tmp_path / "nz.str")
    ref_write(path, table, options=options("LZ4", None)[0])
    assert read_zones(path) is None and ref_read_zones(path) is None


def _binary_dict_page(monkeypatch):
    """(page bytes, rows) of a binary DICT page: three distinct strings."""
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.codecs.binary import BinaryColumn, compress_binary
    from strawboat_tpu_torch.util import env

    monkeypatch.setenv(env.DICT_ENV, "1")
    rows = [b"ab", b"c", b"ab", b"def", b"c", b"ab"]
    offsets = np.concatenate(([0], np.cumsum([len(r) for r in rows]))).astype(np.int64)
    col = BinaryColumn(offsets, np.frombuffer(b"".join(rows), np.uint8))
    page = compress_binary(col, None, WriteOptions(), large=False)
    return np.frombuffer(page, np.uint8), rows


def test_binary_dict_page_roundtrip_and_bad_code(monkeypatch):
    from strawboat_tpu_torch.codecs import Compression, read_header
    from strawboat_tpu_torch.codecs.binary import decode_binary_page

    page, rows = _binary_dict_page(monkeypatch)
    assert read_header(page, 0)[0] == Compression.DICT
    offsets, values, end = decode_binary_page(page, 0, len(rows), False)
    assert end == len(page)
    assert [values[a:b].tobytes() for a, b in zip(offsets[:-1], offsets[1:])] == rows
    # the dictionary's count cut to 1: codes 1 and 2 pass its end
    _codec, _cs, _us, body = read_header(page, 0)
    _ic, icsize, _ius, ibody = read_header(page, body)
    cut = page.copy()
    cut[ibody + icsize : ibody + icsize + 4] = np.frombuffer(struct.pack("<I", 1), np.uint8)
    with pytest.raises(errors.OutOfSpecError, match="dictionary code out of range"):
        decode_binary_page(cut, 0, len(rows), False)
    with pytest.raises(errors.OutOfSpecError, match="truncated"):
        decode_binary_page(page[:-1], 0, len(rows), False)

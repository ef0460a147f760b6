"""The port's page introspection (``strawboat_tpu_torch/stat.py``) against
the JAX package's ``stat.py``, page for page.

Mirrors ``tests/test_stat.py`` (the reference's src/stat.rs:174-270
tests, with the DICT and FREQ page shapes forced by the env flags), then
every flat column of a mixed file under each codec option.
"""

import numpy as np
import pyarrow as pa
import pytest

from conftest import create_random_bool, create_random_double, create_random_i64, create_random_string
from strawboat_tpu import stat as ref_stat
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.read.reader import open_readers as ref_open
from strawboat_tpu.util import env as ref_env
from strawboat_tpu_torch import stat
from strawboat_tpu_torch.api import write_file
from strawboat_tpu_torch.columns import field_from_arrow
from strawboat_tpu_torch.read.reader import open_readers
from test_torch_api import options


@pytest.fixture(autouse=True)
def _clean_env():
    ref_env.remove_all_env()
    yield
    ref_env.remove_all_env()


def _page(p):
    """A ``PageInfo`` of either package as plain tuples (codecs by name)."""
    if p is None:
        return None
    b = p.body
    return (p.validity_size, p.compressed_size, p.uncompressed_size, b.kind,
            None if b.common is None else b.common.name,
            None if b.dict is None else (_page(b.dict.indices), b.dict.unique_num),
            None if b.freq is None else (_page(b.freq.exceptions), b.freq.exceptions_bitmap_size))


def _stats(tmp_path, table, codec="LZ4", ratio=None, page=2048):
    """Every flat column's stat through both packages (the port's file is
    the JAX writer's, byte for byte) → the port's ``ColumnInfo`` list."""
    ref_opts, opts = options(codec, ratio, page)
    jpath, ppath = str(tmp_path / "j.str"), str(tmp_path / "p.str")
    ref_metas = ref_write(jpath, table, options=ref_opts)
    metas = write_file(ppath, table, options=opts)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    out = []
    for i, f in enumerate(table.schema):
        (r,), (rr,) = open_readers(ppath, metas[i : i + 1]), ref_open(jpath, ref_metas[i : i + 1])
        info = stat.stat_simple(r, field_from_arrow(f))
        ref_info = ref_stat.stat_simple(rr, f)
        r.page_reader.close()
        rr.page_reader.close()
        assert [_page(p) for p in info.pages] == [_page(p) for p in ref_info.pages], f.name
        assert info.field == field_from_arrow(f)
        out.append(info)
    return out


def test_stat_common(tmp_path):
    schema = pa.schema([pa.field("a", pa.int64(), nullable=False)])
    table = pa.table({"a": pa.array(np.arange(5000, dtype=np.int64))}, schema=schema)
    (info,) = _stats(tmp_path, table)
    assert len(info.pages) == 3
    for p in info.pages:
        assert p.body.kind == "common" and p.body.common.name == "LZ4"
        assert p.validity_size is None


def test_stat_dict_forced(tmp_path, monkeypatch):
    monkeypatch.setenv(ref_env.DICT_ENV, "1")
    table = pa.table({"a": pa.array([int(i % 4) if i % 7 else None for i in range(4000)],
                                    type=pa.int64())})
    (info,) = _stats(tmp_path, table)
    p = info.pages[0]
    assert p.body.kind == "dict" and p.body.dict.unique_num == 4
    assert p.validity_size is not None
    assert p.body.dict.indices.body.kind in ("common", "rle", "bitpack", "one_value")


def test_stat_freq_forced(tmp_path, monkeypatch):
    monkeypatch.setenv(ref_env.FREQ_ENV, "1")
    vals = np.full(4000, 1 << 20, dtype=np.int64)
    vals[::100] = 7
    (info,) = _stats(tmp_path, pa.table({"a": pa.array(vals)}))
    p = info.pages[0]
    assert p.body.kind == "freq" and p.body.freq.exceptions_bitmap_size > 0
    assert p.body.freq.exceptions is not None


def test_stat_binary_freq(tmp_path, monkeypatch):
    monkeypatch.setenv(ref_env.FREQ_ENV, "1")
    table = pa.table({"s": pa.array(["dom"] * 3900 + [f"x{i}" for i in range(100)])})
    (info,) = _stats(tmp_path, table, page=4096)
    p = info.pages[0]
    assert p.body.kind == "freq" and p.body.freq.exceptions is None


@pytest.mark.parametrize("codec,ratio,flag", [
    ("LZ4", 1.0, None), ("ZSTD", None, None), ("NONE", 1.0, None),
    ("LZ4", None, "DICT_ENV"), ("NONE", None, "FREQ_ENV"), ("LZ4", None, "RLE_ENV"),
    ("LZ4", None, "PATAS_ENV"), ("LZ4", None, "BITPACK_ENV"),
])
def test_stat_of_every_flat_column_matches_jax(tmp_path, monkeypatch, codec, ratio, flag):
    if flag is not None:
        monkeypatch.setenv(getattr(ref_env, flag), "1")
    n = 4096 + 37
    r = np.random.default_rng(11)
    table = pa.table({
        "i32": pa.array(r.integers(0, 300, n).astype(np.int32)),
        "i64": create_random_i64(n, 0.1),
        "f64": create_random_double(n, 0.1),
        "f32": pa.array(np.round(r.normal(size=n), 2).astype(np.float32)),
        "b": create_random_bool(n, 0.2),
        "s": create_random_string(n, 0.1, 40),
        "d": pa.array([None if i % 9 == 0 else i % 50 for i in range(n)], type=pa.decimal128(10, 2)),
    })
    infos = _stats(tmp_path, table, codec, ratio, page=1024)
    assert [len(i.pages) for i in infos] == [5] * 7

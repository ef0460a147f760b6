"""The torch port's dataset layer against the JAX package's.

Every function of the JAX ``exec/dataset.py`` runs beside its port on the
same part files (written by the JAX writer, or by both writers when the
write itself is under test), the port on the CPU with its plain kernel
versions, the JAX package as its own tests run it (``tests/test_dataset.
py``; Pallas interpreted for the resident loaders).  Everything is exact:
values, codes and validities bit for bit, the merged dictionaries in the
same order, part files byte for byte, resident planes word for word.
Dictionary codes are compared on the valid rows, with the validity: the
code a null slot holds is whatever its part's remap gives.
"""

import collections
import dataclasses
import importlib
import json
import os
import runpy
import sys
from decimal import Decimal
from unittest import mock

import numpy as np
import pyarrow as pa
import pytest
import torch

import strawboat_tpu.kernels  # noqa: F401  (JAX x64 on)
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.errors import OutOfSpecError as RefOutOfSpecError
from strawboat_tpu.exec import dataset as ref_ds
from strawboat_tpu.exec import expr as ref_expr
from strawboat_tpu.exec.pruning import Comparison as RefComparison
from strawboat_tpu.exec.query import Query as RefQuery
from strawboat_tpu.exec.resident import load_resident as ref_load
from strawboat_tpu.parallel.dist_scan import _merge_dictionaries as ref_merge_dictionaries
from strawboat_tpu.util.env import _ALL as FLAG_NAMES
from strawboat_tpu_torch.codecs import WriteOptions
from strawboat_tpu_torch.constants import Compression
from strawboat_tpu_torch.errors import NotYetImplementedError, OutOfSpecError
from strawboat_tpu_torch.exec import Query, col, dataset, iter_dataset_chunks, load_resident, scan_dataset
from strawboat_tpu_torch.exec.pruning import Comparison
from strawboat_tpu_torch.exec.scan import host_values
from strawboat_tpu_torch.util.obs import device_trace

from test_torch_load import _assert_same_planes

TILE = 512
REF_OPTS = RefOptions(default_compression=RefCompression.LZ4, default_compress_ratio=None,
                      max_page_size=256, zone_maps=True)
# the README's adaptive options (bench.py's), at a small page
ADAPTIVE = dict(default_compress_ratio=1.0, max_page_size=256, sample_seed=3, zone_maps=True)


def _adaptive_opts():
    return (WriteOptions(default_compression=Compression.LZ4, **ADAPTIVE),
            RefOptions(default_compression=RefCompression.LZ4, **ADAPTIVE))


@pytest.fixture(autouse=True)
def _no_flags(monkeypatch):
    for n in FLAG_NAMES:
        monkeypatch.delenv(n, raising=False)


@pytest.fixture(scope="module")
def interp_pallas():
    """Every reference pallas_call of this module runs interpreted."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    from strawboat_tpu.kernels import bitunpack_pallas as m

    with mock.patch.object(pl, "pallas_call", patched):
        importlib.reload(m)
        yield
    importlib.reload(m)


def _write_parts(tmp_path, n_files=3, rows=700, with_strings=True):
    """``tests/test_dataset.py``'s parts: sorted ``a`` in a range of its
    own per file, and ``s`` over vocabularies that overlap across files."""
    paths, tables = [], []
    for i in range(n_files):
        rng = np.random.default_rng(i)
        base = i * 10_000
        cols = {"a": pa.array(np.sort(rng.integers(base, base + 5000, rows)).astype(np.int64))}
        if with_strings:
            vocab = [f"s{i}", f"s{i + 1}", "common"]
            cols["s"] = pa.array([vocab[j % 3] for j in range(rows)])
        t = pa.table(cols)
        p = str(tmp_path / f"part-{i}.str")
        ref_write(p, t, options=REF_OPTS)
        paths.append(p)
        tables.append(t)
    return paths, tables


def _assert_same_table(got, want):
    """A port DeviceTable equals a JAX one: columns, rows, values (codes on
    the valid rows), validities and dictionaries in order."""
    assert list(got.columns) == list(want.columns)
    assert got.num_rows == want.num_rows
    for name, c in got.columns.items():
        r = want.columns[name]
        valid = None if r.validity is None else np.asarray(r.validity)
        if valid is None:
            assert c.validity is None or bool(c.validity.all()), name
            valid = np.ones(len(c), dtype=bool)
        else:
            np.testing.assert_array_equal(c.validity.numpy(), valid, err_msg=name)
        vals = host_values(c)
        ref_vals = r.host_exact if getattr(r, "host_exact", None) is not None else np.asarray(r.values)
        assert (c.dictionary is None) == (r.dictionary is None), name
        if c.dictionary is not None:
            assert list(c.dictionary) == r.dictionary.to_pylist(), name
        np.testing.assert_array_equal(vals[valid], ref_vals[valid].astype(vals.dtype), err_msg=name)


def _same_arrow(got: pa.Table, want: pa.Table):
    assert got.schema.names == want.schema.names
    for name in want.schema.names:
        assert got.column(name).type == want.column(name).type, name
        assert got.column(name).to_pylist() == want.column(name).to_pylist(), name


# ---------------------------------------------------------------------------
# tests/test_dataset.py, each against the JAX function


def test_scan_dataset_concat_matches_arrow(tmp_path):
    paths, tables = _write_parts(tmp_path)
    dt = scan_dataset(paths, "cpu")
    _assert_same_table(dt, ref_ds.scan_dataset(paths))
    _same_arrow(dt.to_arrow(), ref_ds.scan_dataset(paths).to_arrow())
    exp = pa.concat_tables(tables)
    assert dt.to_arrow().column("s").to_pylist() == exp.column("s").to_pylist()
    assert dt.num_rows == exp.num_rows


def test_scan_dataset_glob(tmp_path):
    paths, tables = _write_parts(tmp_path, with_strings=False)
    glob = str(tmp_path / "part-*.str")
    assert dataset.resolve_paths(glob) == ref_ds.resolve_paths(glob) == paths
    dt = scan_dataset(glob, "cpu")
    assert dt.num_rows == sum(t.num_rows for t in tables)
    _assert_same_table(dt, ref_ds.scan_dataset(glob))


def test_file_level_pruning_skips_whole_files(tmp_path):
    paths, tables = _write_parts(tmp_path, with_strings=False)
    preds = [Comparison("a", "ge", 10_000), Comparison("a", "lt", 15_000)]
    ref_preds = [RefComparison("a", "ge", 10_000), RefComparison("a", "lt", 15_000)]
    got = [dataset.file_may_match(p, preds) for p in paths]
    assert got == [ref_ds.file_may_match(p, ref_preds) for p in paths] == [False, True, False]
    dt = scan_dataset(paths, "cpu", predicates=preds)
    _assert_same_table(dt, ref_ds.scan_dataset(paths, predicates=ref_preds))
    np.testing.assert_array_equal(dt["a"].values.numpy(), tables[1].column("a").to_numpy())


def test_dataset_prunes_to_empty_keeps_schema(tmp_path):
    paths, _ = _write_parts(tmp_path)
    dt = scan_dataset(paths, "cpu", predicates=[Comparison("a", "ge", 10**9)])
    ref = ref_ds.scan_dataset(paths, predicates=[RefComparison("a", "ge", 10**9)])
    assert dt.num_rows == ref.num_rows == 0
    assert list(dt.columns) == list(ref.columns) == ["a", "s"]
    assert len(dt["a"]) == len(dt["s"]) == 0
    _same_arrow(dt.to_arrow(), ref.to_arrow())


def test_dataset_nullable_and_dict_merge(tmp_path):
    t1 = pa.table({"a": pa.array([1, None, 3], type=pa.int64()), "s": pa.array(["x", "y", "x"])})
    t2 = pa.table({"a": pa.array([4, 5, 6], type=pa.int64()), "s": pa.array(["y", "z", None])})
    p1, p2 = str(tmp_path / "n1.str"), str(tmp_path / "n2.str")
    ref_write(p1, t1, options=REF_OPTS)
    ref_write(p2, t2, options=REF_OPTS)
    dt = scan_dataset([p1, p2], "cpu")
    _assert_same_table(dt, ref_ds.scan_dataset([p1, p2]))
    _same_arrow(dt.to_arrow(), pa.concat_tables([t1, t2]))


def test_dataset_schema_mismatch_raises(tmp_path):
    t1 = pa.table({"a": pa.array([1, 2], type=pa.int64())})
    t2 = pa.table({"b": pa.array([3, 4], type=pa.int64())})
    t3 = pa.table({"a": pa.array([1.5, 2.5])})
    paths = [str(tmp_path / f"m{i}.str") for i in range(3)]
    for p, t in zip(paths, (t1, t2, t3)):
        ref_write(p, t, options=REF_OPTS)
    for pair in (paths[:2], [paths[0], paths[2]]):
        with pytest.raises(RefOutOfSpecError):
            ref_ds.scan_dataset(pair)
        with pytest.raises(OutOfSpecError):
            scan_dataset(pair, "cpu")


def test_iter_dataset_chunks_covers_all_rows(tmp_path):
    paths, tables = _write_parts(tmp_path, with_strings=False)
    got = [(c.num_rows, int(c["a"].values.sum())) for c in iter_dataset_chunks(paths, 2, "cpu")]
    want = [(c.num_rows, int(np.asarray(c["a"].values).sum()))
            for c in ref_ds.iter_dataset_chunks(paths, chunk_pages=2)]
    assert got == want
    exp = pa.concat_tables(tables)
    assert sum(n for n, _s in got) == exp.num_rows
    assert sum(s for _n, s in got) == int(exp.column("a").to_numpy().sum())
    preds = [Comparison("a", "ge", 10_000), Comparison("a", "lt", 15_000)]
    ref_preds = [RefComparison("a", "ge", 10_000), RefComparison("a", "lt", 15_000)]
    got = [c.num_rows for c in iter_dataset_chunks(paths, 1, "cpu", predicates=preds)]
    assert got == [c.num_rows for c in ref_ds.iter_dataset_chunks(paths, 1, predicates=ref_preds)]


def test_empty_dataset_raises(tmp_path):
    for paths in (str(tmp_path / "nope-*.str"), []):
        with pytest.raises(RefOutOfSpecError):
            ref_ds.scan_dataset(paths)
        with pytest.raises(OutOfSpecError):
            scan_dataset(paths, "cpu")


def test_query_over_dataset_glob(tmp_path):
    _paths, tables = _write_parts(tmp_path, with_strings=True)
    glob = str(tmp_path / "part-*.str")
    res = (Query(glob, device="cpu").filter(col("a") >= 10_000).group_by("s", num_groups=64)
           .agg(total=("sum", "a"), cnt=("count", "a")).run())
    ref = (RefQuery(glob).filter(ref_expr.col("a") >= 10_000).group_by("s", num_groups=64)
           .agg(total=("sum", "a"), cnt=("count", "a")).run())
    n = int(res["n_groups"])
    assert n == int(ref["n_groups"])
    for k in ("key_s", "total", "cnt"):
        np.testing.assert_array_equal(res[k][:n].numpy(), np.asarray(ref[k])[:n], err_msg=k)
    assert list(res["dict_s"]) == ref["dict_s"].to_pylist()
    exp = pa.concat_tables(tables)
    a, s = exp.column("a").to_numpy(), np.asarray(exp.column("s").to_pylist())
    expected = collections.defaultdict(int)
    for sv, av in zip(s[a >= 10_000], a[a >= 10_000]):
        expected[sv.encode()] += int(av)
    assert {res["dict_s"][int(c)]: int(t) for c, t in zip(res["key_s"][:n], res["total"][:n])} \
        == dict(expected)


def test_write_dataset_roundtrip(tmp_path):
    """Part files byte-equal to the JAX ``write_dataset``'s under the
    adaptive options and one ``sample_seed``; each part prunes alone."""
    n = 1000
    rng = np.random.default_rng(4)
    x, x_null = rng.integers(0, 50, n).astype(np.int64), rng.random(n) < 0.1
    t = pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                  "s": pa.array([f"v{i % 7}" for i in range(n)]),
                  "x": pa.array(x, mask=x_null)})
    opts, ref_opts = _adaptive_opts()
    paths = dataset.write_dataset(str(tmp_path / "ds"), t, rows_per_file=256, options=opts)
    ref_paths = ref_ds.write_dataset(str(tmp_path / "ref"), t, rows_per_file=256, options=ref_opts)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in ref_paths] == [
        f"part-{i:05d}.str" for i in range(4)]
    for p, rp in zip(paths, ref_paths):
        assert open(p, "rb").read() == open(rp, "rb").read()
    _same_arrow(scan_dataset(paths, "cpu").to_arrow(), t)
    preds = [Comparison("k", "ge", 512), Comparison("k", "lt", 768)]
    assert [dataset.file_may_match(p, preds) for p in paths] == [False, False, True, False]
    v = scan_dataset(paths, "cpu", predicates=preds)["k"].values.numpy()
    assert v.min() == 512 and v.max() == 767
    # numpy columns write the same parts as their arrow table
    cols = {"k": np.arange(n, dtype=np.int64), "x": np.ma.MaskedArray(x, mask=x_null)}
    np_paths = dataset.write_dataset(str(tmp_path / "np"), cols, 256, options=opts)
    ref_np = ref_ds.write_dataset(str(tmp_path / "ref_np"), t.select(["k", "x"]), 256,
                                  options=ref_opts)
    assert [open(p, "rb").read() for p in np_paths] == [open(p, "rb").read() for p in ref_np]


def test_dataset_concat_decimal_bool_f64(tmp_path):
    t1 = pa.table({"m": pa.array([Decimal("1.23"), Decimal("4.56")], pa.decimal128(10, 2)),
                   "b": pa.array([True, False]), "f": pa.array([1.5, 2.25], pa.float64())})
    t2 = pa.table({"m": pa.array([Decimal("7.89"), None], pa.decimal128(10, 2)),
                   "b": pa.array([None, True]), "f": pa.array([3.125, None], pa.float64())})
    p1, p2 = str(tmp_path / "d1.str"), str(tmp_path / "d2.str")
    ref_write(p1, t1, options=REF_OPTS)
    ref_write(p2, t2, options=REF_OPTS)
    dt = scan_dataset([p1, p2], "cpu")
    _assert_same_table(dt, ref_ds.scan_dataset([p1, p2]))
    _same_arrow(dt.to_arrow(), ref_ds.scan_dataset([p1, p2]).to_arrow())
    _same_arrow(dt.to_arrow(), pa.concat_tables([t1, t2]))


def test_manifest_prunes_without_file_reads(tmp_path):
    paths, tables = _write_parts(tmp_path, with_strings=False)
    man = dataset.dataset_manifest(paths)
    assert man == ref_ds.dataset_manifest(paths)
    assert [e["num_rows"] for e in man["parts"]] == [700, 700, 700]
    mpath = str(tmp_path / "manifest.json")
    dataset.write_manifest(man, mpath)
    ref_ds.write_manifest(man, str(tmp_path / "ref.json"))
    assert open(mpath).read() == open(tmp_path / "ref.json").read()
    man2 = dataset.load_manifest(mpath)
    assert man2 == ref_ds.load_manifest(mpath)
    # parts 0 and 2 renamed away: the manifest prunes them unread
    os.rename(paths[0], paths[0] + ".hidden")
    os.rename(paths[2], paths[2] + ".hidden")
    preds = [Comparison("a", "ge", 10_000), Comparison("a", "lt", 15_000)]
    ref_preds = [RefComparison("a", "ge", 10_000), RefComparison("a", "lt", 15_000)]
    assert [dataset._part_may_match(e, preds) for e in man2["parts"]] == [
        ref_ds._part_may_match(e, ref_preds) for e in man2["parts"]] == [False, True, False]
    dt = dataset.scan_dataset_with_manifest(man2, "cpu", predicates=preds)
    _assert_same_table(dt, ref_ds.scan_dataset_with_manifest(man2, predicates=ref_preds))
    np.testing.assert_array_equal(dt["a"].values.numpy(), tables[1].column("a").to_numpy())


def test_compact_dataset_roundtrip(tmp_path):
    paths, tables = _write_parts(tmp_path, n_files=3, rows=500, with_strings=True)
    opts, ref_opts = _adaptive_opts()
    out = dataset.compact_dataset(paths, str(tmp_path / "c"), 600, "cpu", options=opts)
    ref_out = ref_ds.compact_dataset(paths, str(tmp_path / "rc"), 600, options=ref_opts)
    assert len(out) == len(ref_out) == 3
    for p, rp in zip(out, ref_out):
        assert open(p, "rb").read() == open(rp, "rb").read()
    _same_arrow(scan_dataset(out, "cpu").to_arrow(), pa.concat_tables(tables))
    assert not dataset.file_may_match(out[0], [Comparison("a", "ge", 10**9)])


def test_query_join_against_dataset_glob(tmp_path):
    rng = np.random.default_rng(0)
    n = 600
    fact = pa.table({"fk": pa.array(rng.integers(0, 40, n).astype(np.int64)),
                     "v": pa.array(rng.integers(0, 100, n).astype(np.int64))})
    fpath = str(tmp_path / "fact.str")
    ref_write(fpath, fact, options=REF_OPTS)
    for i, lo in enumerate((0, 20)):
        dim = pa.table({"dk": pa.array(np.arange(lo, lo + 20, dtype=np.int64)),
                        "w": pa.array((np.arange(lo, lo + 20) * 10).astype(np.int64))})
        ref_write(str(tmp_path / f"dim-{i}.str"), dim, options=REF_OPTS)
    glob = str(tmp_path / "dim-*.str")
    res = (Query(fpath, device="cpu").join(glob, on=("fk", "dk")).group_by("w", num_groups=64)
           .agg(total=("sum", "v")).run())
    ref = (RefQuery(fpath).join(glob, on=("fk", "dk")).group_by("w", num_groups=64)
           .agg(total=("sum", "v")).run())
    ng = int(res["n_groups"])
    assert ng == int(ref["n_groups"])
    for k in ("key_w", "total"):
        np.testing.assert_array_equal(res[k][:ng].numpy(), np.asarray(ref[k])[:ng], err_msg=k)
    exp = collections.defaultdict(int)
    for k, val in zip(fact.column("fk").to_numpy(), fact.column("v").to_numpy()):
        exp[int(k) * 10] += int(val)
    assert dict(zip(res["key_w"][:ng].tolist(), res["total"][:ng].tolist())) == dict(exp)
    # the dataset on the probe side too
    res = (Query([glob.replace("*", "1"), glob.replace("*", "0")], device="cpu")
           .join(fpath, on=("dk", "fk"), max_fanout=64).agg(n=("count", "v")).run())
    ref = (RefQuery([glob.replace("*", "1"), glob.replace("*", "0")])
           .join(fpath, on=("dk", "fk"), max_fanout=64).agg(n=("count", "v")).run())
    assert int(res["n"]) == int(ref["n"]) == n


# ---------------------------------------------------------------------------
# the merged dictionary, explicit lists and globs


def _string_parts(tmp_path, vocabs, nulls=()):
    paths = []
    for i, vocab in enumerate(vocabs):
        rows = [vocab[j % len(vocab)] for j in range(40)]
        mask = [i in nulls and j % 5 == 0 for j in range(40)]
        t = pa.table({"s": pa.array(rows, mask=np.array(mask)),
                      "k": pa.array(np.arange(40, dtype=np.int64) + 100 * i)})
        p = str(tmp_path / f"part-{i}.str")
        ref_write(p, t, options=REF_OPTS)
        paths.append(p)
    return paths


def test_merged_dictionary_keeps_first_appearance(tmp_path):
    """Dictionaries that overlap in different orders merge as the JAX
    ``pc.unique`` of the pool does (first appearance, not sorted); codes
    equal on the valid rows, validity equal."""
    paths = _string_parts(tmp_path, [["zz", "mm", "aa"], ["aa", "qq", "zz"], ["bb", "mm"]],
                          nulls=(1,))
    dt = scan_dataset(paths, "cpu")
    ref = ref_ds.scan_dataset(paths)
    _assert_same_table(dt, ref)
    # part 1's nulls put an empty value in its dictionary, in both packages
    assert list(dt["s"].dictionary) == [b"zz", b"mm", b"aa", b"", b"qq", b"bb"]
    gdict, tables = dataset._merge_dictionaries([np.array(v, dtype=object) for v in (
        [b"c", b"a"], ["a", "d"], [])])
    ref_gdict, ref_tables = ref_merge_dictionaries(
        [pa.array([b"c", b"a"]), pa.array(["a", "d"]), pa.array([], pa.binary())])
    assert list(gdict) == ref_gdict.to_pylist() == [b"c", b"a", b"d"]
    assert [t.tolist() for t in tables] == [t.tolist() for t in ref_tables] == [[0, 1], [1, 2], []]
    assert all(t.dtype == np.int32 for t in tables)


def test_merged_dictionary_type_is_the_references(tmp_path):
    """The pool is binary in both packages: ``to_arrow`` casts back to
    utf8, ``Query``'s ``dict_<col>`` holds bytes, and ``compact_dataset``
    of a utf8 column writes the JAX parts."""
    paths = _string_parts(tmp_path, [["é", "b"], ["b", "ü", "é"]])
    dt = scan_dataset(paths, "cpu")
    _same_arrow(dt.to_arrow(), ref_ds.scan_dataset(paths).to_arrow())
    assert dt.to_arrow().column("s").type == pa.string()
    res = Query(paths, device="cpu").group_by("s", num_groups=8).agg(n=("count", "k")).run()
    ref = RefQuery(paths).group_by("s", num_groups=8).agg(n=("count", "k")).run()
    assert ref["dict_s"].type == pa.binary()
    assert list(res["dict_s"]) == ref["dict_s"].to_pylist() == ["é".encode(), b"b", "ü".encode()]
    opts, ref_opts = _adaptive_opts()
    out = dataset.compact_dataset(paths, str(tmp_path / "c"), 50, "cpu", options=opts)
    ref_out = ref_ds.compact_dataset(paths, str(tmp_path / "rc"), 50, options=ref_opts)
    assert [open(p, "rb").read() for p in out] == [open(p, "rb").read() for p in ref_out]


def test_explicit_list_keeps_its_order_and_a_glob_sorts(tmp_path):
    paths = _string_parts(tmp_path, [["a"], ["b"], ["c"]])
    order = [paths[2], paths[0], paths[1]]
    assert dataset.resolve_paths(order) == ref_ds.resolve_paths(order) == order
    dt = scan_dataset(order, "cpu")
    _assert_same_table(dt, ref_ds.scan_dataset(order))
    assert dt["k"].values[:1].tolist() == [200]
    assert list(dt["s"].dictionary) == [b"c", b"a", b"b"]
    assert scan_dataset(str(tmp_path / "part-*.str"), "cpu")["k"].values[:1].tolist() == [0]


def test_list_column_concat_raises_as_in_the_reference(tmp_path):
    t = pa.table({"l": pa.array([[1, 2], [3]])})
    paths = [str(tmp_path / f"l{i}.str") for i in range(2)]
    for p in paths:
        ref_write(p, t, options=REF_OPTS)
    with pytest.raises(NotYetImplementedError, match="list column"):
        scan_dataset(paths, "cpu")
    # one part needs no concat
    one = scan_dataset(paths[:1], "cpu")
    assert len(dataset.concat_device_columns("l", [one["l"]])) == 2
    assert dataset.concat_device_tables([one]).num_rows == 2
    assert dataset.concat_device_tables([]).num_rows == 0


def test_mixed_dictionary_and_plain_parts_raise(tmp_path):
    t1 = pa.table({"s": pa.array(["a", "b"])})
    p1 = str(tmp_path / "s1.str")
    ref_write(p1, t1, options=REF_OPTS)
    part = scan_dataset([p1], "cpu")["s"]
    plain = dataclasses.replace(part, dictionary=None)
    with pytest.raises(OutOfSpecError, match="mixes dictionary and plain"):
        dataset.concat_device_columns("s", [part, plain])


# ---------------------------------------------------------------------------
# load_resident over a dataset (mirrors tests/test_resident.py:520)


def _resident_parts(tmp_path, n=1500, rows_per_file=400):
    rng = np.random.default_rng(6)
    lens = rng.integers(0, 4, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    leaf = rng.integers(-50, 500, int(offs[-1]))
    t = pa.table({
        "v": pa.array(rng.integers(0, 500, n)),
        "g": pa.array(rng.integers(0, 4, n)),
        # the sorted global dictionary spans parts: each part holds a subset
        "s": pa.array([f"w{(i * 7) % 23:02d}" for i in range(n)],
                      mask=rng.random(n) < 0.05),
        "l": pa.ListArray.from_arrays(pa.array(offs.astype(np.int32)), pa.array(leaf),
                                      mask=pa.array(rng.random(n) < 0.1)),
    })
    d = tmp_path / "ds"
    ref_ds.write_dataset(str(d), t, rows_per_file=rows_per_file, options=REF_OPTS)
    return str(d / "part-*.str"), t


def test_load_resident_over_a_glob_and_a_list_equals_jax(tmp_path, interp_pallas):
    glob, t = _resident_parts(tmp_path)
    paths = dataset.resolve_paths(glob)
    for src in (glob, paths, paths[::-1]):
        rt = load_resident(src, "cpu", tile=TILE)
        ref = ref_load(src, tile=TILE)
        _assert_same_planes(rt, ref, names=["v", "g", "s", "l"])
        assert rt.num_rows == t.num_rows
        assert rt["l"].child.kind == ref["l"].child.kind
        np.testing.assert_array_equal(rt.list_sum("l").numpy(), np.asarray(ref.list_sum("l")))
        (sums,), cnt = rt.group_sum("g", ["v"], num_groups=4)
        (rsums,), rcnt = ref.group_sum("g", ["v"], num_groups=4)
        np.testing.assert_array_equal(sums.numpy(), np.asarray(rsums))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
    v, g = t.column("v").to_numpy(), t.column("g").to_numpy()
    assert [int((v * (g == k)).sum()) for k in range(4)] == sums.tolist()
    want = ["s", "nosuch", "v"]
    _assert_same_planes(load_resident(paths, "cpu", columns=want, tile=TILE),
                        ref_load(paths, columns=want, tile=TILE))


def test_load_resident_over_disagreeing_parts_raises(tmp_path):
    p1, p2 = str(tmp_path / "a.str"), str(tmp_path / "b.str")
    ref_write(p1, pa.table({"a": pa.array([1, 2])}), options=REF_OPTS)
    ref_write(p2, pa.table({"a": pa.array(["x", "y"])}), options=REF_OPTS)
    with pytest.raises(OutOfSpecError, match="disagrees"):
        load_resident([p1, p2], "cpu", tile=TILE)


# ---------------------------------------------------------------------------
# device_trace and the example


def test_device_trace_on_the_cpu(tmp_path):
    paths, _ = _write_parts(tmp_path)
    with device_trace(str(tmp_path / "trace"), "cpu") as tr:
        scan_dataset(paths, "cpu")
    assert os.path.exists(tr.path) and os.path.dirname(tr.path) == str(tmp_path / "trace")
    assert 0.0 <= tr.idle_share <= 1.0
    assert 0.0 < tr.busy_s <= tr.window_s
    assert 0.0 <= tr.longest_gap_s <= tr.window_s


def test_trace_busy_counts_launches_whose_kernel_is_missing(tmp_path):
    """A kernel launch inside the span without its kernel record counts in
    ``lost_kernels``; launches outside the span, and copies, do not."""
    from strawboat_tpu_torch.util.obs import _TRACE_SPAN, trace_busy

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    events = [x("user_annotation", _TRACE_SPAN, 100, 100),
              x("cuda_runtime", "cudaLaunchKernel", 50, 2, correlation=1),  # before the span
              x("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=2),
              x("cuda_runtime", "cudaLaunchKernelExC", 120, 2, correlation=3),
              x("cuda_runtime", "cudaMemcpyAsync", 130, 2, correlation=4),
              x("cuda_runtime", "cudaLaunchKernel", 140, 2, correlation=5),
              x("kernel", "k2", 150, 10, correlation=2), x("gpu_memcpy", "Memcpy", 170, 10, correlation=4)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = trace_busy(str(path), "cuda")
    assert tr.lost_kernels == 2  # correlations 3 and 5
    assert abs(tr.busy_s - 20e-6) < 1e-12 and abs(tr.window_s - 100e-6) < 1e-12
    events.append(x("kernel", "k3", 185, 5, correlation=3))
    events.append(x("kernel", "k5", 192, 5, correlation=5))
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace_busy(str(path), "cuda").lost_kernels == 0


def test_trace_device_ranges_match_records_to_their_ranges(tmp_path):
    """Device records go to the host range whose launch made them, by the
    runtime call's correlation id; a record whose launch is outside every
    range, or missing from the trace, goes nowhere and shifts nothing."""
    from strawboat_tpu_torch.util.obs import trace_device_ranges

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    events = [x("user_annotation", "sb_call_0_0", 0, 100), x("user_annotation", "sb_call_0_1", 100, 100),
              x("user_annotation", "other", 200, 100),
              x("cuda_runtime", "cudaLaunchKernel", 10, 5, correlation=1),
              x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=2),
              x("cuda_runtime", "cudaMemcpyAsync", 150, 5, correlation=3),
              x("cuda_runtime", "cudaLaunchKernel", 250, 5, correlation=4),
              # device records, out of order; correlation 5 has no launch in the trace
              x("gpu_memcpy", "Memcpy DtoD", 400, 7, correlation=3),
              x("kernel", "k_b", 320, 3, correlation=2), x("kernel", "k_a", 300, 2, correlation=1),
              x("kernel", "k_c", 500, 9, correlation=4), x("kernel", "k_d", 600, 9, correlation=5)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace_device_ranges(str(path), "sb_call_")
    assert got == {"sb_call_0_0": [("k_a", 2e-6), ("k_b", 3e-6)],
                   "sb_call_0_1": [("Memcpy DtoD", 7e-6)]}


def test_torch_dataset_demo_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setattr(sys, "argv", ["torch_dataset_demo.py", "--device", "cpu", "--rows",
                                      "6000", "--parts", "3", "--dir", str(tmp_path)])
    runpy.run_path(os.path.join(root, "examples", "torch_dataset_demo.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "3 parts" in out and "files kept 1 of 3" in out and "exact" in out
    assert torch.get_default_device().type == "cpu"

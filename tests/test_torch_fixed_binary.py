"""``fixed_size_binary[w]`` columns through the port against the JAX package.

The reference stores a fixed-size binary of 1, 2, 4 or 8 bytes as the
little-endian integer of its width (``strawboat_tpu/columns.py``
``_np_storage_dtype``), and refuses other widths.  The same seeded tables
go through both writers (files equal byte for byte: the writer's default
options, the ``dict`` flags and the adaptive chooser), both readers
(``read_table``, ``iter_batches``), both scans (``scan_file``,
``scan_chunks``, pruned scans, ``Query(path)`` filters, ``scan_dataset``:
values and validity exactly equal), ``stat_simple`` and both resident
loaders (which refuse the type alike).
"""

import importlib
from unittest import mock

import numpy as np
import pyarrow as pa
import pytest
import torch

from test_torch_api import assert_same, options, read_both, write_both
from strawboat_tpu import api as ref_api
from strawboat_tpu_torch import api
from strawboat_tpu_torch.errors import NotYetImplementedError

WIDTHS = [1, 2, 4, 8]
N = 3072
PAGE = 1024  # a multiple of 128: the writer bit-packs whole pages only
FLAGS = {"dict": {"STRAWBOAT_DICT_COMPRESSION": "1", "STRAWBOAT_BITPACK_COMPRESSION": "1"},
         "bitpack": {"STRAWBOAT_BITPACK_COMPRESSION": "1"}}


def fixed_binary(values: np.ndarray, w: int, validity=None) -> pa.Array:
    """Integers of width ``w`` → the ``fixed_size_binary[w]`` array of
    their little-endian bytes."""
    data = pa.py_buffer(np.ascontiguousarray(values.astype(f"<i{w}")).tobytes())
    bitmap = None if validity is None else pa.py_buffer(np.packbits(validity, bitorder="little"))
    return pa.Array.from_buffers(pa.binary(w), len(values), [bitmap, data])


def fixed_table(w: int, case: str, seed: int = 0, n: int = N) -> pa.Table:
    """Four columns of width ``w``: random bytes, 40 distinct values, small
    values and a sorted run.  ``case``: ``required`` (non-nullable
    fields), ``nulls`` (10% nulls) or ``sliced`` (nulls, then a slice at
    an odd offset)."""
    rng = np.random.default_rng(seed + w)
    hi = 1 << (8 * w - 1)
    cols = {
        "rand": rng.integers(-hi, hi, n, dtype=np.int64),
        "few": rng.choice(rng.integers(-hi, hi, 40, dtype=np.int64), n),
        "small": rng.integers(0, min(100, hi), n),
        "sorted": np.sort(rng.integers(-hi, hi, n, dtype=np.int64)),
    }
    validity = None if case == "required" else rng.random(n) >= 0.1
    fields = [pa.field(k, pa.binary(w), nullable=case != "required") for k in cols]
    table = pa.table([fixed_binary(v, w, validity) for v in cols.values()],
                     schema=pa.schema(fields))
    return table.slice(37, n - 100) if case == "sliced" else table


def list_table(n: int = N, seed: int = 5) -> pa.Table:
    """A ``list<fixed_size_binary[2]>`` column beside an int64 one."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 4, n)
    child = fixed_binary(rng.integers(-300, 300, int(lens.sum())), 2)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    null = rng.random(n) < 0.1
    lists = pa.ListArray.from_arrays(pa.array(offsets), child, mask=pa.array(null))
    return pa.table({"l": lists, "k": pa.array(rng.integers(0, 1000, n))})


@pytest.fixture
def interpreted_pallas():
    """The reference's pallas_calls run interpreted, as its CPU tests run
    them."""
    from jax.experimental import pallas as pl

    from strawboat_tpu.kernels import bitunpack_pallas as m

    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        importlib.reload(m)
        yield
    importlib.reload(m)


def _opts(kind: str, monkeypatch, zone_maps=False):
    """(JAX, port) options of a kind: the writer's ``default``, the
    ``dict`` or ``bitpack`` flags, or the ``adaptive`` chooser."""
    for k, v in FLAGS.get(kind, {}).items():
        monkeypatch.setenv(k, v)
    ratio = 1.0 if kind == "adaptive" else None
    codec = "LZ4" if kind == "adaptive" else "NONE"
    return options(codec, ratio, PAGE, seed=7, zone_maps=zone_maps)


# ---------------------------------------------------------------------------
# write and host read


@pytest.mark.parametrize("kind", ["default", "dict", "bitpack", "adaptive"])
@pytest.mark.parametrize("case", ["required", "nulls", "sliced"])
@pytest.mark.parametrize("w", WIDTHS)
def test_file_and_read_equal_the_jax_package(tmp_path, monkeypatch, w, case, kind):
    table = fixed_table(w, case)
    jpath, ppath = write_both(tmp_path, table, *_opts(kind, monkeypatch))
    want = read_both(jpath, ppath, table)
    assert want.schema.field("rand").type == pa.binary(w)
    assert api.read_table(ppath).equals(table.combine_chunks())


def test_numpy_front_takes_integers_and_bytes(tmp_path):
    """``write_file`` of numpy columns under a fixed-size binary field: the
    integers of its width, or a bytes array of its width, give the JAX
    writer's file."""
    from strawboat_tpu_torch.schema import Field

    rng = np.random.default_rng(2)
    ints = rng.integers(-(1 << 31), 1 << 31, N).astype(np.int32)
    table = pa.table({"a": fixed_binary(ints, 4), "b": fixed_binary(ints[::-1], 4)})
    ref = str(tmp_path / "ref.str")
    ref_api.write_file(ref, table, options=options("NONE", None, PAGE)[0])
    path = str(tmp_path / "port.str")
    api.write_file(path, {"a": ints, "b": ints[::-1].copy().view("S4")},
                   schema=[Field("a", "fixed_size_binary[4]"), Field("b", "fixed_size_binary[4]")],
                   options=options("NONE", None, PAGE)[1])
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("w", [3, 16])
def test_other_widths_raise_in_both_packages(tmp_path, w):
    table = pa.table({"a": pa.array([b"x" * w] * 4, pa.binary(w))})
    msg = f"unsupported type fixed_size_binary\\[{w}\\]"
    with pytest.raises(NotImplementedError, match=msg):
        ref_api.write_file(str(tmp_path / "ref.str"), table)
    with pytest.raises(NotImplementedError, match=msg):
        api.write_file(str(tmp_path / "port.str"), table)


@pytest.mark.parametrize("kind", ["default", "dict", "bitpack"])
def test_stat_simple_equals_the_jax_stats(tmp_path, monkeypatch, kind):
    from test_torch_stat import _stats

    _opts(kind, monkeypatch)
    names = ("rand", "few", "small", "sorted")
    table = pa.table({f"{k}{w}": c for w in WIDTHS
                      for k, c in zip(names, fixed_table(w, "nulls").columns)})
    infos = _stats(tmp_path, table, "NONE", None, PAGE)
    kinds = {i.field.name: {p.body.kind for p in i.pages} for i in infos}
    assert len(kinds) == 16 and all(len(i.pages) == 3 for i in infos)
    want = {"default": "common", "dict": "dict", "bitpack": "bitpack"}[kind]
    assert kinds["small4"] == {want}  # 4-byte columns alone bit-pack


# ---------------------------------------------------------------------------
# device scans


def _same_scan(got, want, names=None):
    """A port ``DeviceTable`` equals a JAX one: the same rows, and every
    column's type, values and validity exactly."""
    assert got.num_rows == want.num_rows
    for name in names or want.columns:
        g, r = got[name], want[name]
        assert str(g.dtype) == str(r.dtype), name
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(r.values), err_msg=name)
        assert (g.validity is None) == (r.validity is None), name
        if r.validity is not None:
            np.testing.assert_array_equal(g.validity.numpy(), np.asarray(r.validity), err_msg=name)


@pytest.mark.parametrize("kind", ["dict", "bitpack"])
@pytest.mark.parametrize("w", WIDTHS)
def test_scans_equal_the_jax_scan(tmp_path, monkeypatch, w, kind):
    """``scan_file`` (whole, pruned), ``scan_chunks``, ``Query(path)``
    filters over the column and ``scan_dataset`` of a file written under
    the ``dict`` or ``bitpack`` flags with zone maps: the integers of
    width ``w``, as the JAX scan gives them (a 4-byte column's DICT
    indices and bit-packed pages take K3's route)."""
    from strawboat_tpu.exec import Query as RefQuery, col as ref_col, pruning as ref_pruning
    from strawboat_tpu.exec.dataset import scan_dataset as ref_scan_dataset
    from strawboat_tpu.exec.scan import scan_chunks as ref_chunks, scan_file as ref_scan
    from strawboat_tpu_torch.exec import Query, col, pruning, scan_dataset, scan_file
    from strawboat_tpu_torch.exec.scan import scan_chunks

    table = fixed_table(w, "nulls")
    jpath, ppath = write_both(tmp_path, table, *_opts(kind, monkeypatch, zone_maps=True))
    got, want = scan_file(ppath, "cpu"), ref_scan(jpath)
    _same_scan(got, want)
    assert got["rand"].values.dtype == {1: torch.int8, 2: torch.int16, 4: torch.int32,
                                        8: torch.int64}[w]
    assert_same(got.to_arrow(), want.to_arrow())
    for x, y in zip(scan_chunks(ppath, 2, "cpu"), ref_chunks(jpath, 2)):
        _same_scan(x, y)
    sv = np.sort(np.asarray(want["sorted"].values))
    cut = int(sv[len(sv) // 3])
    pruned = scan_file(ppath, "cpu", predicates=[pruning.Comparison("sorted", "lt", cut)])
    ref_pruned = ref_scan(jpath, predicates=[ref_pruning.Comparison("sorted", "lt", cut)])
    assert pruned.num_rows < table.num_rows
    _same_scan(pruned, ref_pruned)
    (q, mask), (rq, ref_mask) = (
        Query(ppath, device="cpu").filter((col("sorted") >= cut) & (col("few") != 0)).run(),
        RefQuery(jpath).filter((ref_col("sorted") >= cut) & (ref_col("few") != 0)).run())
    _same_scan(q, rq)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert_same(q.to_arrow(mask), rq.to_arrow(ref_mask))
    agg = Query(ppath, device="cpu").filter(col("sorted") < cut).agg(
        s=("sum", "small"), c=("count", "rand")).run()
    ref_agg = RefQuery(jpath).filter(ref_col("sorted") < cut).agg(
        s=("sum", "small"), c=("count", "rand")).run()
    assert (int(agg["s"]), int(agg["c"])) == (int(ref_agg["s"]), int(ref_agg["c"]))
    _same_scan(scan_dataset([ppath, ppath], "cpu"), ref_scan_dataset([jpath, jpath]))


@pytest.mark.parametrize("kind", ["default", "dict"])
def test_list_of_fixed_binary_scans_and_reads_as_the_jax_package(tmp_path, monkeypatch, kind):
    from strawboat_tpu.exec.scan import scan_file as ref_scan
    from strawboat_tpu_torch.exec import scan_file

    table = list_table()
    jpath, ppath = write_both(tmp_path, table, *_opts(kind, monkeypatch))
    read_both(jpath, ppath, table)
    got, want = scan_file(ppath, "cpu"), ref_scan(jpath)
    leaf, ref_leaf = got["l"], want["l"]
    assert leaf.values.dtype == torch.int16
    np.testing.assert_array_equal(leaf.values.numpy(), np.asarray(ref_leaf.values))
    np.testing.assert_array_equal(leaf.offsets.numpy(), np.asarray(ref_leaf.offsets))
    assert_same(got.to_arrow(), want.to_arrow())


def test_load_resident_raises_as_the_jax_one(tmp_path, interpreted_pallas):
    """Both loaders refuse the type, flat or under a list, with one message;
    a scanned table's integers load in both (``make_resident`` of a
    ``DeviceTable``) and answer alike."""
    from strawboat_tpu.exec import Query as RefQuery
    from strawboat_tpu.exec.resident import load_resident as ref_load, make_resident as ref_make
    from strawboat_tpu.exec.scan import scan_file as ref_scan
    from strawboat_tpu_torch.exec import Query, load_resident, make_resident, scan_file

    table = fixed_table(4, "nulls", n=1000)
    jpath, ppath = write_both(tmp_path, table, *options("NONE", None, PAGE))
    msg = "resident load of column 'rand' type fixed_size_binary\\[4\\]"
    for load in (lambda: load_resident(ppath, "cpu"), lambda: make_resident(table, "cpu")):
        with pytest.raises(NotYetImplementedError, match=msg):
            load()
    for load in (lambda: ref_load(jpath), lambda: ref_make(table)):
        with pytest.raises(Exception, match=msg):
            load()
    ljpath, lppath = write_both(tmp_path, list_table(500), *options("NONE", None, PAGE), name="l")
    msg = "resident load of column 'l.item' type fixed_size_binary\\[2\\]"
    with pytest.raises(NotYetImplementedError, match=msg):
        load_resident(lppath, "cpu", columns=["l"])
    with pytest.raises(Exception, match=msg):
        ref_load(ljpath, columns=["l"])
    # the reference's device-direct packers are cached by bit width alone
    # (exec/resident.py _DEV_PACK_CACHE), each for the tile it was first
    # built with: use the tile the other reference tests use, then drop them
    from strawboat_tpu.exec import resident as ref_resident

    try:
        ref_rt = ref_make(ref_scan(jpath), tile=512)
    finally:
        ref_resident._DEV_PACK_CACHE.clear()
    rt = make_resident(scan_file(ppath, "cpu"), "cpu", tile=512)
    got = Query(rt).agg(s=("sum", "small"), c=("count", "few")).run()
    want = RefQuery(ref_rt).agg(s=("sum", "small"), c=("count", "few")).run()
    assert (int(got["s"]), int(got["c"])) == (int(want["s"]), int(want["c"]))


def test_cuda_scan_needs_a_card(tmp_path):
    from strawboat_tpu_torch.exec import scan_file

    _, ppath = write_both(tmp_path, fixed_table(4, "nulls", n=500), *options("NONE", None, PAGE))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception, match="(?i)cuda"):
        scan_file(ppath, "cuda", columns=["rand"])

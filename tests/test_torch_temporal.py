"""The temporal flat types of the torch port (timestamp with its unit and
time zone, date64, time32 / time64, duration) against the JAX package:
schema bytes, files byte for byte, scans, chunked and pruned scans, the
query path, the resident loaders and ``to_arrow``.  They are integers
everywhere: arrow's int32 / int64 storage of counts of their unit."""

import numpy as np
import pyarrow as pa
import pytest

from strawboat_tpu import schema as ref_schema
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.exec import scan_file as ref_scan
from strawboat_tpu_torch import schema as port_schema
from strawboat_tpu_torch.codecs import WriteOptions
from strawboat_tpu_torch.exec import Query, col, load_resident, make_resident, scan_file
from strawboat_tpu_torch.exec.pruning import Comparison
from strawboat_tpu_torch.exec.scan import host_values, scan_chunks
from strawboat_tpu_torch.schema import Field
from strawboat_tpu_torch.write import write_file

TILE = 512
FLAGS = ("STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION")

TEMPORAL = {
    "timestamp[s]": pa.timestamp("s"), "timestamp[ms]": pa.timestamp("ms"),
    "timestamp[us]": pa.timestamp("us"), "timestamp[ns]": pa.timestamp("ns"),
    "timestamp[ms, tz=UTC]": pa.timestamp("ms", tz="UTC"),
    "timestamp[us, tz=Europe/Paris]": pa.timestamp("us", tz="Europe/Paris"),
    "date64": pa.date64(), "time32[s]": pa.time32("s"), "time32[ms]": pa.time32("ms"),
    "time64[us]": pa.time64("us"), "time64[ns]": pa.time64("ns"),
    "duration[s]": pa.duration("s"), "duration[ms]": pa.duration("ms"),
    "duration[us]": pa.duration("us"), "duration[ns]": pa.duration("ns"),
}


@pytest.fixture
def flags(monkeypatch):
    def set_flags(names):
        for k in FLAGS:
            monkeypatch.delenv(k, raising=False)
        for k in names:
            monkeypatch.setenv(k, "1")

    set_flags(())
    return set_flags


def _storage(alias, n, seed=0):
    rng = np.random.default_rng(seed)
    if alias.startswith("time32"):
        return rng.integers(0, 86_400, n).astype(np.int32)
    if alias.startswith("time64"):
        return rng.integers(0, 86_400_000_000, n)
    # sorted, so that zone maps prune
    return np.sort(rng.integers(0, 10**12, n))


@pytest.mark.parametrize("alias", sorted(TEMPORAL))
@pytest.mark.parametrize("nullable", [True, False])
def test_schema_bytes_of_temporal_types(alias, nullable):
    schema = pa.schema([pa.field("t", TEMPORAL[alias], nullable), pa.field("k", pa.int32())])
    fields = [Field("t", alias, nullable), Field("k", "int32")]
    want = ref_schema.schema_to_bytes(schema)
    assert port_schema.schema_to_bytes(fields) == want
    assert port_schema.deserialize_schema(want) == fields
    assert fields[0].is_flat_int
    assert port_schema.int_storage(alias) == ("<i4" if alias.startswith("time32") else "<i8")


@pytest.mark.parametrize("flag_set", [(), FLAGS[:1], FLAGS])
@pytest.mark.parametrize("alias", sorted(TEMPORAL))
def test_port_file_equals_jax_file(tmp_path, flags, alias, flag_set):
    flags(flag_set)
    n = 1000
    vals = _storage(alias, n)
    null = np.random.default_rng(1).random(n) < 0.1
    table = pa.table({"t": pa.array(vals, mask=null).cast(TEMPORAL[alias]),
                      "k": pa.array(np.arange(n, dtype=np.int64))})
    a, b = str(tmp_path / "jax.str"), str(tmp_path / "port.str")
    for zone_maps in (False, True):
        ref_write(a, table, options=RefOptions(max_page_size=256, zone_maps=zone_maps))
        write_file(b, {"t": np.ma.MaskedArray(vals, mask=null), "k": np.arange(n, dtype=np.int64)},
                   schema=[Field("t", alias), Field("k", "int64")],
                   options=WriteOptions(max_page_size=256, zone_maps=zone_maps))
        assert open(a, "rb").read() == open(b, "rb").read(), zone_maps
    got = scan_file(b, "cpu")
    want = ref_scan(a)
    assert got["t"].dtype == alias
    assert np.array_equal(got["t"].validity.numpy(), ~null)
    assert host_values(got["t"])[~null].tolist() == np.asarray(want["t"].values)[~null].tolist()
    assert got.to_arrow().column("t").combine_chunks().equals(table.column("t").combine_chunks())


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
def test_numpy_datetimes_and_timedeltas_write_as_arrow_does(tmp_path, unit):
    """``datetime64[unit]`` → timestamp[unit], ``timedelta64[unit]`` →
    duration[unit], as ``pa.array`` types them; a Field of another unit
    converts the values."""
    rng = np.random.default_rng(5)
    ts = rng.integers(0, 10**9, 400).astype(f"datetime64[{unit}]")
    td = rng.integers(-10**6, 10**6, 400).astype(f"timedelta64[{unit}]")
    a, b = str(tmp_path / "jax.str"), str(tmp_path / "port.str")
    ref_write(a, pa.table({"ts": pa.array(ts), "td": pa.array(td)}), options=RefOptions())
    write_file(b, {"ts": ts, "td": td})
    assert open(a, "rb").read() == open(b, "rb").read()
    c = str(tmp_path / "ms.str")
    write_file(c, {"ts": ts.astype("datetime64[s]"), "d": ts.astype("datetime64[s]")},
               schema=[Field("ts", "timestamp[ms]"), Field("d", "date64")])
    got = scan_file(c, "cpu")
    want = ts.astype("datetime64[s]").astype("datetime64[ms]").view(np.int64)
    assert host_values(got["ts"]).tolist() == want.tolist()
    assert host_values(got["d"]).tolist() == want.tolist()


def test_temporal_columns_through_the_scan_query_and_resident_paths(tmp_path, flags):
    flags(FLAGS)
    n = 5000
    rng = np.random.default_rng(9)
    ts = np.sort(rng.integers(0, 10**15, n))
    t32 = rng.integers(0, 86_400_000, n).astype(np.int32)
    du = rng.integers(0, 10**9, n)
    table = pa.table({"ts": pa.array(ts).cast(pa.timestamp("us")),
                      "t32": pa.array(t32).cast(pa.time32("ms")),
                      "t64": pa.array(ts % 86_400_000_000).cast(pa.time64("us")),
                      "du": pa.array(du).cast(pa.duration("s")),
                      "d64": pa.array(ts // 1000).cast(pa.date64()),
                      "v": pa.array(np.arange(n, dtype=np.int64))})
    path = str(tmp_path / "t.str")
    ref_write(path, table, options=RefOptions(max_page_size=512, zone_maps=True))
    full = scan_file(path, "cpu")
    for name in ("ts", "t32", "du", "d64"):
        assert full.to_arrow().column(name).combine_chunks().equals(table.column(name).combine_chunks())
    cut = int(ts[3000])
    pruned = scan_file(path, "cpu", predicates=[Comparison("ts", "ge", cut)])
    assert pruned.num_rows < n and host_values(pruned["ts"]).min() <= cut
    kept = host_values(pruned["ts"])
    assert kept.tolist() == ts[n - len(kept):].tolist()
    chunks = list(scan_chunks(path, 3, "cpu"))
    assert np.concatenate([host_values(c["du"]) for c in chunks]).tolist() == du.tolist()
    res = (Query(path, device="cpu").filter(col("ts") >= cut)
           .agg(n=("count", "v"), s=("sum", "du")).run())
    sel = ts >= cut
    assert int(res["n"]) == int(sel.sum()) and int(res["s"]) == int(du[sel].sum())
    from strawboat_tpu.exec.resident import load_resident as ref_load
    from strawboat_tpu.exec.resident import make_resident as ref_make

    rt = load_resident(path, "cpu", tile=TILE)
    assert rt.to_arrow().equals(table)
    ref = ref_load(path, columns=["ts", "v"], tile=TILE)  # it refuses time, duration, date64
    for name in ("ts", "v"):
        mine, theirs = rt[name], ref.columns[name]
        assert [b for _w, b in mine.planes] == [b for _w, b in theirs.planes]
        for (w, _b), (rw, _rb) in zip(mine.planes, theirs.planes):
            assert np.array_equal(w.numpy().view(np.uint32), np.asarray(rw))
        assert (mine.wide, mine.offset, mine.is_dict) == (bool(theirs.wide), theirs.offset,
                                                          theirs.dictionary_host is not None)
    assert rt.decode_natural("du").tolist() == du.tolist()  # wide: int64
    dev_rt = make_resident(full, "cpu", tile=TILE)
    ref_dev = ref_make(ref_scan(path, columns=["ts", "t32", "t64", "v"]), tile=TILE)
    for name in ("ts", "t32", "t64", "v"):
        assert np.array_equal(dev_rt[name].planes[0][0].numpy().view(np.uint32),
                              np.asarray(ref_dev.columns[name].planes[0][0]))
    assert dev_rt.to_arrow().equals(table)
    np_rt = make_resident({"ts": ts.astype("datetime64[us]")}, "cpu", tile=TILE)
    assert np_rt["ts"].arrow_type == "timestamp[us]" and np_rt.decode_natural("ts").tolist() == ts.tolist()

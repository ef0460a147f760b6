"""The torch port imports neither JAX, nor pyarrow, nor the JAX package.

Runs in a subprocess: this test process already has JAX loaded (conftest).
The child imports every module of the port, runs Q6 and Q1 over a small
resident table built from numpy columns on the CPU, writes the ten
lineitem columns (three utf8) with zone maps through the port's writer
and scans them back (dictionary and bit-packed pages, string codes),
scans Q6 pruned by the zone maps and in chunks, runs Q1 and a grouped
``Query`` over the file, the Q3-shaped join of it with an orders file and
``load_resident`` of it, writes and scans a column of each float, bool and
decimal type (DICT pages, then PATAS) and loads them resident, writes,
scans and sums a list<struct<int64, utf8>> column beside a timestamp
column (``list_segment_sum``, ``list_sum``, ``load_resident``), writes the
lineitem columns through the adaptive chooser with LZ4 and rewrites their
scan with ``write_device_table`` (both scanned back), writes them as a
dataset of parts and scans, queries, streams, plans and loads it, runs
the multi-device dry run on a 4-shard CPU mesh and Q6 over the dataset's
resident table sharded over it, and checks
``sys.modules`` afterwards: no
``jax``, no ``pyarrow``, no ``strawboat_tpu`` or ``strawboat_tpu.*``.  A
source check holds every port file and ``chip_smoke.py`` to the same.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "strawboat_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)
# the port's examples and scripts (``torch_*.py``)
CONFIG_SCRIPTS = sorted(str(p.relative_to(ROOT)) for d in ("examples", "scripts")
                 for p in (ROOT / d).glob("torch_*.py"))

CHILD = """
import importlib, json, os, sys, tempfile
import numpy as np
for m in {modules!r}:
    importlib.import_module(m)
from strawboat_tpu_torch.benchsuite import tpch
from strawboat_tpu_torch.exec import Query, col, load_resident, make_resident, scan_file
from strawboat_tpu_torch.exec.scan import host_values, scan_chunks
cols = tpch.generate_lineitem(1.0, rows=5000)
rt = make_resident({{k: cols[k] for k in tpch.Q1_Q6_COLUMNS}}, "cpu", tile=512)
assert int(tpch.q6(rt)) == tpch.q6_numpy_reference(cols)
assert tpch.q1_rows(tpch.q1(rt)) == tpch.q1_numpy_reference(cols)
os.environ["STRAWBOAT_DICT_COMPRESSION"] = "1"
os.environ["STRAWBOAT_BITPACK_COMPRESSION"] = "1"
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "lineitem.str")
    tpch.write_lineitem(path, cols, max_page_size=1024, zone_maps=True)
    table = scan_file(path, "cpu")
    for k in tpch.INT_COLUMNS:
        assert np.array_equal(host_values(table[k]), cols[k]), k
    for k in ("l_returnflag", "l_linestatus", "l_shipmode"):
        words = np.array([v.decode() for v in table[k].dictionary])
        assert np.array_equal(words[host_values(table[k])], cols[k]), k
    assert int(tpch.q6(table)) == tpch.q6_numpy_reference(cols)
    pruned = scan_file(path, "cpu", predicates=tpch.q6_pruning_predicates())
    assert pruned.num_rows < 5000 and int(tpch.q6(pruned)) == tpch.q6_numpy_reference(cols)
    chunks = list(scan_chunks(path, 2, "cpu", predicates=tpch.q6_pruning_predicates()))
    assert sum(c.num_rows for c in chunks) == pruned.num_rows
    assert tpch.q1_rows(tpch.q1_query(path, "cpu")) == tpch.q1_numpy_reference(cols)
    res = (Query(path, device="cpu").filter(col("l_shipdate") <= 2467)
           .group_by("l_suppkey", num_groups=8).agg(n=("count", "l_tax")).run())
    assert int(res["n"].sum()) == int((cols["l_shipdate"] <= 2467).sum())
    orders = tpch.generate_orders(1.0, rows=1250)
    opath = os.path.join(d, "orders.str")
    tpch.write_orders(opath, orders, max_page_size=1024)
    got = tpch.q3_query(path, opath, "cpu")
    assert tpch.q3_rows(got["key_o_orderpriority"], got["n_groups"], got["revenue"]) == \
        tpch.q3_numpy_reference(cols, orders)
    rt2 = load_resident(path, "cpu", tile=512)
    assert int(tpch.q6(rt2)) == tpch.q6_numpy_reference(cols)
    from strawboat_tpu_torch.schema import Field
    from strawboat_tpu_torch.write import write_file
    rng = np.random.default_rng(0)
    typed = {{"f16": rng.integers(0, 9, 3000).astype(np.float16),
             "f32": rng.random(3000).astype(np.float32),
             "f64": np.ma.MaskedArray(rng.random(3000), mask=rng.random(3000) < 0.1),
             "b": rng.random(3000) < 0.5,
             "d128": rng.integers(-10**9, 10**9, 3000),
             "d256": rng.integers(0, 7, 3000)}}
    fields = [Field("f16", "float16"), Field("f32", "float32"), Field("f64", "float64"),
              Field("b", "bool"), Field("d128", "decimal128(15, 2)"), Field("d256", "decimal256(18, 4)")]
    for flags in ((), ("STRAWBOAT_PATAS_COMPRESSION",)):
        for f in flags:
            os.environ[f] = "1"
        tpath = os.path.join(d, "typed.str")
        names = [k for k in typed if not (flags and k == "f16")]
        write_file(tpath, {{k: typed[k] for k in names}}, schema=[f for f in fields if f.name in names])
        got = scan_file(tpath, "cpu")
        for k in names:  # null slots of DICT pages repeat the previous value
            ok = ~np.ma.getmaskarray(typed[k])
            want = np.ma.getdata(typed[k])[ok]
            assert got[k].values.numpy()[ok].tobytes() == want.tobytes(), k
        assert np.array_equal(~got["f64"].validity.numpy(), np.ma.getmaskarray(typed["f64"]))
        rt3 = load_resident(tpath, "cpu", columns=["f32", "f64", "b", "d128", "d256"], tile=512)
        assert np.array_equal(rt3.decode_natural("d128").numpy(), typed["d128"])
        for f in flags:
            del os.environ[f]
    from strawboat_tpu_torch import columns as cm
    from strawboat_tpu_torch.exec.aggregate import list_segment_sum
    from strawboat_tpu_torch.schema import list_of
    items = cm.StructColumn("struct", None, [
        cm.PrimitiveColumn("int64", None, np.array([1, 2, 3, 4, 5])),
        cm.BinaryColumn("string", None, np.arange(6), np.frombuffer(b"abcde", np.uint8))], 5)
    npath = os.path.join(d, "nested.str")
    write_file(npath, {{"l": cm.ListColumn("list", None, np.array([0, 2, 2, 5]), items),
                        "t": np.array([1, 2, 3], "datetime64[us]")}},
               schema=[list_of("l", Field("item", "struct", True, (Field("a", "int64"),
                                                                   Field("s", "string")))),
                       Field("t", "timestamp[us]")])
    nt = scan_file(npath, "cpu")
    assert nt["l.a"].offsets.tolist() == [0, 2, 2, 5] and host_values(nt["t"]).tolist() == [1, 2, 3]
    assert [nt["l.s"].dictionary[c] for c in nt["l.s"].values.tolist()] == [b"a", b"b", b"c", b"d", b"e"]
    assert list_segment_sum(nt["l.a"].values, nt["l.a"].offsets, 3).tolist() == [3, 0, 12]
    assert make_resident(nt, "cpu", tile=512).list_sum("l.a").tolist() == [3, 0, 12]
    rtn = load_resident(npath, "cpu", tile=512)
    assert rtn["l"].child.kind == "struct" and rtn.decode_natural("t").tolist() == [1, 2, 3]
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.write.device import write_device_table
    for f in ("STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION"):
        del os.environ[f]
    opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                        max_page_size=1024, sample_seed=3, zone_maps=True)
    apath, dpath = os.path.join(d, "adaptive.str"), os.path.join(d, "device.str")
    tpch.write_lineitem(apath, cols, options=opts)
    write_device_table(dpath, scan_file(apath, "cpu"), opts)
    for p in (apath, dpath):
        t = scan_file(p, "cpu")
        for k in tpch.INT_COLUMNS:
            assert np.array_equal(host_values(t[k]), cols[k]), (p, k)
        words = np.array([v.decode() for v in t["l_shipmode"].dictionary])
        assert np.array_equal(words[host_values(t["l_shipmode"])], cols["l_shipmode"]), p
    from strawboat_tpu_torch.exec import dataset, iter_dataset_chunks, scan_dataset
    parts = dataset.write_dataset(os.path.join(d, "ds"), {{k: cols[k] for k in tpch.LINEITEM_COLUMNS}},
                                  2000, options=opts)
    glob = os.path.join(d, "ds", "part-*.str")
    ds = scan_dataset(glob, "cpu")
    for k in tpch.INT_COLUMNS:
        assert np.array_equal(host_values(ds[k]), cols[k]), k
    pruned = scan_dataset(parts, "cpu", predicates=tpch.q6_pruning_predicates())
    assert int(tpch.q6(pruned)) == tpch.q6_numpy_reference(cols)
    assert tpch.q1_rows(tpch.q1_query(glob, "cpu")) == tpch.q1_numpy_reference(cols)
    assert sum(c.num_rows for c in iter_dataset_chunks(glob, 1, "cpu")) == 5000
    assert dataset.scan_dataset_with_manifest(dataset.dataset_manifest(glob), "cpu").num_rows == 5000
    rtd = load_resident(glob, "cpu", columns=tpch.Q1_Q6_COLUMNS, tile=512)
    assert int(tpch.q6(rtd)) == tpch.q6_numpy_reference(cols)
    from strawboat_tpu_torch.parallel import make_mesh, sharded_filter_sum, shard_resident
    from strawboat_tpu_torch.parallel.dryrun import dryrun_multidevice
    assert dryrun_multidevice(4, "cpu")["q1_groups"] == 6
    srt = shard_resident(rtd, make_mesh(4, "cpu"), "shards")
    assert int(sharded_filter_sum(srt, {{"l_shipdate": (731, 1096), "l_discount": (5, 8),
                                        "l_quantity": (None, 24)}}, "l_extendedprice",
                                  "l_discount")) == tpch.q6_numpy_reference(cols)
ref = sorted(m for m in sys.modules if m == "strawboat_tpu" or m.startswith("strawboat_tpu."))
print(json.dumps({{"jax": "jax" in sys.modules, "pyarrow": "pyarrow" in sys.modules,
                  "strawboat_tpu": ref}}))
"""


def test_port_modules_listed():
    assert "strawboat_tpu_torch.exec.resident" in MODULES
    assert "strawboat_tpu_torch.kernels.bitunpack" in MODULES
    assert "strawboat_tpu_torch.exec.scan" in MODULES
    assert "strawboat_tpu_torch.write.writer" in MODULES
    assert "strawboat_tpu_torch.schema" in MODULES
    assert "strawboat_tpu_torch.codecs.binary" in MODULES
    assert "strawboat_tpu_torch.exec.pruning" in MODULES
    assert "strawboat_tpu_torch.exec.dataset" in MODULES
    assert "strawboat_tpu_torch.parallel.dist_resident" in MODULES


def test_port_runs_without_jax_or_pyarrow():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(modules=MODULES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == (
        '{"jax": false, "pyarrow": false, "strawboat_tpu": []}'
    )


# an import statement that names the JAX package (not strawboat_tpu_torch)
_REF_IMPORT = re.compile(r"^\s*(from|import)\s+strawboat_tpu(\.|\s|$)")


def test_config_scripts_listed():
    for name in ("examples/torch_tpch_bench.py", "examples/torch_resident_query.py",
                 "examples/torch_bench_write.py", "scripts/torch_tpch_sf10.py",
                 "scripts/torch_resident_q1.py", "scripts/torch_dist_sf1_stream.py",
                 "scripts/torch_scaling_proxy.py", "examples/torch_dist_bench.py"):
        assert name in CONFIG_SCRIPTS, name


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"] + CONFIG_SCRIPTS,
)
def test_no_import_of_the_jax_package(path):
    for n, line in enumerate((ROOT / path).read_text().splitlines(), 1):
        assert not _REF_IMPORT.match(line), f"{path}:{n}: {line}"
    assert not _REF_IMPORT.match("from strawboat_tpu_torch import native")
    assert _REF_IMPORT.match("    from strawboat_tpu.util.bits import pack_blocks")


def test_native_library_path_lies_under_the_port():
    from strawboat_tpu_torch import native

    for snappy in (False, True):
        path = pathlib.Path(native.library_path(snappy)).resolve()
        assert path.parent == (PORT / "native" / "build").resolve()
    assert pathlib.Path(native.BUILD).resolve() == (PORT / "native" / "build").resolve()


@pytest.mark.parametrize("path", CONFIG_SCRIPTS)
def test_no_jax_import_in_config_scripts(path):
    for line in (ROOT / path).read_text().splitlines():
        assert not re.match(r"^\s*(import|from)\s+jax(\.|\s|$)", line), f"{path}: {line}"


@pytest.mark.parametrize("needle", ["import jax", "from jax", "import pyarrow"])
def test_no_eager_jax_or_pyarrow_import_in_port(needle):
    """No module of the port imports JAX at all, and pyarrow only inside
    functions (indented)."""
    for p in PORT.rglob("*.py"):
        for line in p.read_text().splitlines():
            if needle.startswith("import pyarrow"):
                assert not line.startswith(needle), f"{p}: {line}"
            else:
                assert needle not in line, f"{p}: {line}"

"""The port's CUDA kernels, resident path, file scan and streamed feed on
the card.

Marked ``cuda``: every test skips where no CUDA device is usable.  Run on a
machine with an H100 (``--noconftest``: the repo's conftest imports JAX,
which the port does not need): ``python -m pytest --noconftest
tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from strawboat_tpu_torch.kernels import bitunpack as bu
from strawboat_tpu_torch.util import obs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("seed", [0, 0xA5A500FF])
def test_k1_matches_plain_on_card(cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed & 0xFFFF)
    for b in range(1, 33):
        w = torch.randint(-(2**31), 2**31 - 1, (3, b, 16384), dtype=torch.int32,
                          device=cuda, generator=g)
        before = obs.counter("k1.launches")
        got = bu.bitunpack_tiled(w, seed, b)
        torch.cuda.synchronize()
        assert obs.counter("k1.launches") == before + 1
        assert torch.equal(got, bu.bitunpack_tiled_plain(w, seed, b)), b


def test_resident_q1_q6_on_card(cuda):
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import make_resident

    cols = tpch.generate_lineitem(1.0, rows=200_000)
    rt = make_resident({k: cols[k] for k in tpch.Q1_Q6_COLUMNS}, cuda)
    before = obs.counter("k1.launches")
    assert int(tpch.q6(rt)) == tpch.q6_numpy_reference(cols)
    k6 = (obs.counter("k6.launches"), obs.counter("k6.torch_aggs"))
    got = tpch.q1_rows(tpch.q1(rt))
    # every integer sum, average and count of Q1 in one K6 launch
    assert (obs.counter("k6.launches"), obs.counter("k6.torch_aggs")) == (k6[0] + 1, k6[1])
    want = tpch.q1_numpy_reference(cols)
    assert list(got) == list(want)
    for key, aggs in want.items():
        for name, w in aggs.items():
            if name.startswith("avg_"):
                np.testing.assert_allclose(got[key][name], w, rtol=1e-12)
            else:
                assert got[key][name] == w, (key, name)
    assert obs.counter("k1.launches") > before


@pytest.mark.parametrize("cap", [1, 6, 20, 64, 4096])
def test_k6_matches_plain_on_card(cuda, cap):
    """K6 against its plain version at each cap and launch plan: a thread's
    own sums (bounds 8 and 32, outputs split over launches past 8), a
    block's (split past 96 KB), int32 and int64 keys and values with wrapping
    sums, masks and validities, repeated outputs, a row count that is not a
    multiple of a step's rows, and bases off 16 bytes (the scalar loads)."""
    from strawboat_tpu_torch.kernels import group_agg as ga

    rng = np.random.default_rng(cap)
    n = 1_000_003
    inner = 2 if cap % 2 == 0 else 1

    def ints(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, n + 1, dtype=np.int64))

    edge = ints(2**63 - 2**40, 2**63 - 1)
    full = {"k0": ints(-1, cap // inner + 1).int(), "k1": ints(0, inner),
            "v0": ints(-(2**31), 2**31 - 1).int(),
            "v1": torch.where(torch.from_numpy(rng.random(n + 1) < 0.5), edge, -edge),
            "v2": ints(0, 10**6)}
    full.update({k: torch.from_numpy(rng.random(n + 1) < p)
                 for k, p in (("m", 0.9), ("b0", 0.5), ("b1", 0.3))})
    on_card = {k: t.to(cuda) for k, t in full.items()}

    def calls(t):
        v, b = [t["v0"], t["v1"], t["v2"]], [t["b0"], t["b1"]]
        keys = [(t["k0"], inner), (t["k1"], 1)]
        return [(keys, [(v[0], None), (v[1], None), (None, None), (v[2], b[0]), (None, b[0]),
                        (v[1], b[1])]),
                (keys[1:] if inner > 1 else keys, [(v[1], None)]),
                (keys, [(v[i % 3], b[i % 2] if i % 4 else None) for i in range(10)]
                 + [(None, None), (v[1], None)])]

    for off in (0, 1):  # 1: every base 4 or 8 bytes past a 16-byte boundary
        host = {k: x[off:n + off] for k, x in full.items()}
        card = {k: x[off:n + off] for k, x in on_card.items()}
        for (keys, outputs), (ckeys, coutputs) in zip(calls(host), calls(card)):
            distinct = len({(id(a), id(b)) for a, b in outputs})
            before = obs.counter("k6.launches")
            got = ga.group_agg(ckeys, cap, card["m"], coutputs)
            torch.cuda.synchronize()
            assert obs.counter("k6.launches") - before == len(ga.plan_launches(cap, distinct))
            assert torch.equal(got.cpu(), ga.group_agg_plain(keys, cap, host["m"], outputs)), (
                cap, off, len(outputs))
    # a CUDA tensor never takes the plain version: past the bound it raises
    with pytest.raises(ValueError, match="cap"):
        ga.group_agg([(on_card["k0"], 1)], ga.K6_MAX_GROUPS + 1, None, [(None, None)])


@pytest.mark.parametrize("seed", [0, 0xA5A500FF])
def test_k3_matches_plain_on_card(cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed & 0xFFFF)
    cta = bu.NATURAL_CTA_BLOCKS
    for b in range(0, 33):
        for n_blocks in (1, 7, cta - 1, cta, cta + 1, 777, 2000):
            w = torch.randint(-(2**31), 2**31 - 1, (n_blocks, 4 * b), dtype=torch.int32,
                              device=cuda, generator=g)
            before = obs.counter("k3.launches")
            got = bu.bitunpack_natural(w, seed, b)
            torch.cuda.synchronize()
            assert obs.counter("k3.launches") == before + (b > 0)  # b == 0: no launch
            assert torch.equal(got, bu.bitunpack_natural_plain(w, seed, b)), (b, n_blocks)
    # a start 4 bytes past a 16-byte boundary is refused before any launch
    flat = torch.zeros(4 * 6 * 100 + 1, dtype=torch.int32, device=cuda)
    misaligned = flat[1:].view(100, 4 * 6)
    before = obs.counter("k3.launches")
    with pytest.raises(ValueError, match="16-byte"):
        bu.bitunpack_natural(misaligned, seed, 6)
    with pytest.raises(ValueError, match="contiguous"):
        bu.bitunpack_natural(flat[: 4 * 6 * 100].view(4 * 6, 100).t(), seed, 6)
    assert obs.counter("k3.launches") == before


def test_k2_k0_match_plain_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    for b in range(1, 33):
        w = torch.randint(-(2**31), 2**31 - 1, (2, b, 16384), dtype=torch.int32,
                          device=cuda, generator=g)
        assert torch.equal(bu.bitunpack_tiled_unseeded(w, b), bu.bitunpack_tiled_unseeded_plain(w, b))
        wt = w[0, :, :1536].contiguous()
        assert torch.equal(bu.bitunpack_tmajor(wt, b), bu.bitunpack_tmajor_plain(wt, b))
    torch.cuda.synchronize()


@pytest.mark.parametrize("flags", [("STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION"),
                                   ("STRAWBOAT_BITPACK_COMPRESSION",)])
def test_scan_on_card(cuda, tmp_path, monkeypatch, flags):
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import scan_file
    from strawboat_tpu_torch.exec.scan import host_values

    for f in flags:
        monkeypatch.setenv(f, "1")
    cols = tpch.generate_lineitem(1.0, rows=300_000)
    path = str(tmp_path / "lineitem.str")
    tpch.write_lineitem(path, cols)
    before = obs.counter("k3.launches")
    table = scan_file(path, device=cuda)
    torch.cuda.synchronize()
    assert obs.counter("k3.launches") > before
    for k in tpch.INT_COLUMNS:
        assert table[k].values.device.type == "cuda"
        np.testing.assert_array_equal(host_values(table[k]), cols[k], err_msg=k)
    assert int(tpch.q6(table)) == tpch.q6_numpy_reference(cols)


def test_q3_general_path_on_card(cuda, tmp_path, monkeypatch):
    """The general path at a small size on the card: the Q3-shaped join
    through the Query API and through ``q3_like`` over scans (K3), a
    group-by on a non-dictionary key that grows its capacity, and
    ``load_resident`` + Q6 (K1)."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import Query, col, load_resident, scan_file

    monkeypatch.setenv("STRAWBOAT_DICT_COMPRESSION", "1")
    monkeypatch.setenv("STRAWBOAT_BITPACK_COMPRESSION", "1")
    cols = tpch.generate_lineitem(1.0, rows=200_000)
    orders = tpch.generate_orders(1.0, rows=50_000)
    lp, op = str(tmp_path / "li.str"), str(tmp_path / "o.str")
    tpch.write_lineitem(lp, cols)
    tpch.write_orders(op, orders)
    want = tpch.q3_numpy_reference(cols, orders)
    before = obs.counter("k3.launches")
    res = tpch.q3_query(lp, op, cuda)
    assert res["revenue"].device.type == "cuda"
    assert obs.counter("k3.launches") > before
    assert tpch.q3_rows(res["key_o_orderpriority"], res["n_groups"], res["revenue"]) == want
    got = tpch.q3_like(scan_file(lp, cuda), scan_file(op, cuda))
    assert tpch.q3_rows(*got) == want
    m = cols["l_shipdate"] <= 2467
    g = Query(lp, device=cuda).filter(col("l_shipdate") <= 2467).group_by(
        "l_suppkey", num_groups=1024).agg(n=("count", "l_tax"), mx=("max", "l_quantity")).run()
    n = int(g["n_groups"])
    assert n == len(np.unique(cols["l_suppkey"][m])) and g["keys"].shape[0] == 16384
    keys = g["key_l_suppkey"][:n].cpu().numpy()
    np.testing.assert_array_equal(g["n"][:n].cpu().numpy(),
                                  np.bincount(cols["l_suppkey"][m], minlength=10000)[keys])
    before = obs.counter("k1.launches")
    rt = load_resident(lp, cuda)
    assert int(tpch.q6(rt)) == tpch.q6_numpy_reference(cols)
    assert obs.counter("k1.launches") > before


def test_k3_on_string_index_pages_matches_plain_on_card(cuda, tmp_path, monkeypatch):
    """The string columns' DICT index pages (widths 1-3) through K3 on the
    card equal the plain version, and the scan of the file on the card
    equals the scan on the CPU: codes, dictionary order, validity."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import scan_file
    from strawboat_tpu_torch.exec.scan import k3_launch_groups

    monkeypatch.setenv("STRAWBOAT_DICT_COMPRESSION", "1")
    monkeypatch.setenv("STRAWBOAT_BITPACK_COMPRESSION", "1")
    cols = tpch.generate_lineitem(1.0, rows=300_000)
    path = str(tmp_path / "lineitem.str")
    tpch.write_lineitem(path, cols, max_page_size=8192, zone_maps=True)
    strings = ["l_returnflag", "l_linestatus", "l_shipmode"]
    groups = k3_launch_groups(path, strings)
    assert {b for _c, (_k, b), _p, _w in groups} >= {2, 3}
    for _col, (codec, b), _pages, words in groups:
        assert codec == Compression.DICT
        w = torch.from_numpy(words.view(np.int32)).to(cuda)
        before = obs.counter("k3.launches")
        got = bu.bitunpack_natural(w, 0, b)
        torch.cuda.synchronize()
        assert obs.counter("k3.launches") == before + 1
        assert torch.equal(got.cpu(), bu.bitunpack_natural_plain(w.cpu(), 0, b)), b
    before = obs.counter("k3.launches")
    on_card = scan_file(path, cuda, columns=strings)
    torch.cuda.synchronize()
    assert obs.counter("k3.launches") == before + len(groups)
    on_cpu = scan_file(path, "cpu", columns=strings)
    for k in strings:
        assert on_card[k].values.device.type == "cuda"
        assert torch.equal(on_card[k].values.cpu(), on_cpu[k].values), k
        assert list(on_card[k].dictionary) == list(on_cpu[k].dictionary), k
        d = np.array([v.decode() for v in on_card[k].dictionary])
        np.testing.assert_array_equal(d[on_card[k].values.cpu().numpy()], cols[k], err_msg=k)


def test_k3_on_typed_dict_index_pages_matches_plain_on_card(cuda, tmp_path, monkeypatch):
    """f32, f64 and decimal DICT pages whose codes pack at one width go
    through K3 on the card, equal to its plain version, and the scan on the
    card equals the scan on the CPU bit for bit."""
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import scan_file
    from strawboat_tpu_torch.exec.scan import k3_launch_groups
    from strawboat_tpu_torch.schema import Field
    from strawboat_tpu_torch.write import write_file

    monkeypatch.setenv("STRAWBOAT_DICT_COMPRESSION", "1")
    monkeypatch.setenv("STRAWBOAT_BITPACK_COMPRESSION", "1")
    rng = np.random.default_rng(6)
    n = 300_000
    cols = {"f32": (rng.integers(0, 60, n) * 0.5).astype(np.float32),
            "f64": np.where(rng.random(n) < 0.01, -0.0, rng.integers(0, 11, n) * 0.01),
            "d": rng.integers(0, 9, n) * 125}
    path = str(tmp_path / "typed.str")
    write_file(path, cols, schema=[Field("f32", "float32"), Field("f64", "float64"),
                                   Field("d", "decimal128(15, 2)")],
               options=WriteOptions(max_page_size=65536))
    groups = k3_launch_groups(path)
    assert {c for c, _g, _p, _w in groups} == set(cols)
    for _col, (codec, b), _pages, words in groups:
        assert codec == Compression.DICT
        w = torch.from_numpy(words.view(np.int32)).to(cuda)
        before = obs.counter("k3.launches")
        got = bu.bitunpack_natural(w, 0, b)
        torch.cuda.synchronize()
        assert obs.counter("k3.launches") == before + 1
        assert torch.equal(got.cpu(), bu.bitunpack_natural_plain(w.cpu(), 0, b)), b
    before = obs.counter("k3.launches")
    on_card = scan_file(path, cuda)
    torch.cuda.synchronize()
    assert obs.counter("k3.launches") == before + len(groups)
    on_cpu = scan_file(path, "cpu")
    for k, v in cols.items():
        assert on_card[k].values.device.type == "cuda"
        assert on_card[k].values.cpu().numpy().tobytes() == on_cpu[k].values.numpy().tobytes() == v.tobytes(), k


@pytest.mark.parametrize("chunk", [None, 1 << 16])
def test_streamed_feed_on_card_equals_pageable_route(cuda, tmp_path, monkeypatch, chunk):
    """Raw integer and float pages stream through page-locked buffers:
    back-to-back scans (the pool's buffers reused while copies may still
    run; at 64 KB chunks, hundreds of them) equal the page route with
    pageable copies, bit for bit."""
    from strawboat_tpu_torch.exec import arena, scan_file
    from strawboat_tpu_torch.exec import scan as port_scan
    from strawboat_tpu_torch.write import write_file

    rng = np.random.default_rng(7)
    n = 2_000_000
    cols = {"i64": rng.integers(-(2**62), 2**62, n), "f64": rng.normal(size=n),
            "f32": rng.random(n).astype(np.float32), "u16": rng.integers(0, 1 << 16, n).astype(np.uint16)}
    path = str(tmp_path / "raw.str")
    write_file(path, cols)
    if chunk is not None:
        monkeypatch.setattr(port_scan, "_UPLOAD_CHUNK", chunk)
    arena.clear()
    scans = [scan_file(path, cuda) for _ in range(3)]
    torch.cuda.synchronize()
    assert 0 < arena.pooled_bytes() <= arena.MAX_POOLED * max(chunk or 0, 16 << 20)
    monkeypatch.setattr(port_scan, "_decode_raw_column_streamed", lambda *a: None)
    pageable = scan_file(path, cuda)
    for k, v in cols.items():
        want = pageable[k].values.cpu().numpy()
        assert want.tobytes() == v.tobytes(), k
        for s in scans:
            assert s[k].values.cpu().numpy().tobytes() == want.tobytes(), k


def _nested_orders_file(tmp_path, n_orders=5000, page=1000, fixed=None):
    """Orders with their lineitems nested (list<struct<...>> and a list of
    int64) under the dict flags.  With 1–7 lineitems an order, a page's
    leaf count is rarely a multiple of 128, so its DICT index subpage is
    raw (the writer bit-packs whole 128-value blocks only); ``fixed``
    lineitems an order over pages of 96 orders make every page's leaf
    count a multiple of 128 (bit-packed indices) but the last."""
    import os

    from strawboat_tpu_torch import columns as cm
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.schema import Field, list_of
    from strawboat_tpu_torch.write import write_file
    from strawboat_tpu_torch.write.writer import _binary_column

    rng = np.random.default_rng(3)
    lens = rng.integers(1, 8, n_orders) if fixed is None else np.full(n_orders, fixed)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    m = int(offsets[-1])
    qty, price = rng.integers(1, 51, m), rng.integers(90_000, 5_500_000, m)
    ship = rng.integers(0, 2557, m).astype(np.int32)
    flag = _binary_column(np.array(["A", "N", "R"])[rng.integers(0, 3, m)], None)
    items = cm.StructColumn("struct", None, [
        cm.PrimitiveColumn("int64", None, qty), cm.PrimitiveColumn("int64", None, price),
        cm.PrimitiveColumn("date32", None, ship),
        cm.BinaryColumn("string", None, flag.offsets, flag.values)], m)
    fields = [list_of("o_lineitems", Field("item", "struct", True, (
        Field("l_quantity", "int64"), Field("l_extendedprice", "int64"),
        Field("l_shipdate", "date32"), Field("l_returnflag", "string")))),
        list_of("o_lineprices", Field("item", "int64"))]
    path = str(tmp_path / "orders_nested.str")
    os.environ["STRAWBOAT_DICT_COMPRESSION"] = "1"
    os.environ["STRAWBOAT_BITPACK_COMPRESSION"] = "1"
    try:
        write_file(path, {"o_lineitems": cm.ListColumn("list", None, offsets, items),
                          "o_lineprices": cm.ListColumn("list", None, offsets,
                                                        cm.PrimitiveColumn("int64", None, price))},
                   schema=fields, options=WriteOptions(max_page_size=page))
    finally:
        del os.environ["STRAWBOAT_DICT_COMPRESSION"], os.environ["STRAWBOAT_BITPACK_COMPRESSION"]
    return path, offsets, price


def test_nested_leaf_pages_through_k3_on_card(cuda, tmp_path):
    """The bit-packed DICT index pages of nested leaves go through K3 on
    the card, equal to its plain version; the last page (32 leaves, not a
    multiple of 128) takes the raw-index route; the scan on the card
    equals the scan on the CPU, offsets int64."""
    from strawboat_tpu_torch.exec.scan import k3_launch_groups, scan_file

    path, offsets, price = _nested_orders_file(tmp_path, page=96, fixed=4)
    groups = k3_launch_groups(path)
    assert {g[0] for g in groups} >= {"o_lineitems.l_quantity", "o_lineitems.l_returnflag"}
    for _col, (_codec, b), _pages, words in groups:
        w = torch.from_numpy(words.view(np.int32)).to(cuda)
        assert torch.equal(bu.bitunpack_natural(w, 0, b).cpu(), bu.bitunpack_natural_plain(w.cpu(), 0, b))
    before = obs.counter("k3.launches")
    on_card = scan_file(path, cuda)
    torch.cuda.synchronize()
    assert obs.counter("k3.launches") == before + len(groups)
    on_cpu = scan_file(path, "cpu")
    for k, c in on_cpu.columns.items():
        g = on_card[k]
        assert g.offsets.dtype == torch.int64 and g.offsets.device.type == "cuda"
        assert torch.equal(g.offsets.cpu(), c.offsets) and torch.equal(g.values.cpu(), c.values), k
    assert on_card["o_lineprices"].values.cpu().numpy().tolist() == price.tolist()


def test_list_sum_on_card_equals_cpu(cuda, tmp_path):
    """load_resident of the nested file on the card: list_sum through K1
    equals the CPU table's and numpy's."""
    from strawboat_tpu_torch.exec import load_resident

    path, offsets, price = _nested_orders_file(tmp_path)
    rt = load_resident(path, cuda)
    before = obs.counter("k1.launches")
    got = rt.list_sum("o_lineprices")
    torch.cuda.synchronize()
    assert obs.counter("k1.launches") > before
    want = np.add.reduceat(price, offsets[:-1])
    assert got.cpu().tolist() == want.tolist()
    assert got.cpu().tolist() == load_resident(path, "cpu").list_sum("o_lineprices").tolist()


@pytest.mark.parametrize("dtype,unsigned", [(np.int64, False), (np.uint32, True), (np.uint64, True),
                                            (np.float32, False), (np.float64, False)])
def test_paged_stats_on_card_equal_cpu(cuda, dtype, unsigned):
    """The device writer's page stats on the card equal them on the CPU,
    ``unique_est`` included (exact on the CPU against the JAX package)."""
    from strawboat_tpu_torch.kernels import encode

    rng = np.random.default_rng(2)
    n = 100_003
    vals = rng.integers(0, 1 << 20, n).astype(dtype)
    if unsigned:
        vals = vals + np.array(np.iinfo(dtype).max // 2, dtype=dtype)
        vals = vals.view(f"<i{vals.itemsize}")
    valid = rng.random(n) > 0.2
    host = torch.from_numpy(vals)
    cpu = encode.paged_stats_device(host, torch.from_numpy(valid), 4096, unsigned=unsigned)
    dev = encode.paged_stats_device(host.to(cuda), torch.from_numpy(valid).to(cuda), 4096,
                                    unsigned=unsigned)
    for k in cpu:
        assert torch.equal(dev[k].cpu(), cpu[k]), k
    packed_c, st_c = encode.paged_bool_stats_device(torch.from_numpy(valid), None, 4096)
    packed_d, st_d = encode.paged_bool_stats_device(torch.from_numpy(valid).to(cuda), None, 4096)
    assert torch.equal(packed_d.cpu(), packed_c)
    for k in st_c:
        assert torch.equal(st_d[k].cpu(), st_c[k]), k


def test_write_device_table_on_card_equals_cpu(cuda, tmp_path):
    """``write_device_table`` of a table scanned onto the card writes the
    bytes of the same table scanned onto the CPU, under the adaptive
    options with zone maps."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.exec import scan_file
    from strawboat_tpu_torch.write.device import write_device_table

    cols = tpch.generate_lineitem(1.0, seed=0, rows=50_000)
    opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                        max_page_size=8192, sample_seed=3, zone_maps=True)
    path = str(tmp_path / "li.str")
    tpch.write_lineitem(path, cols, options=opts)
    out = {}
    for name, dev in (("cpu", "cpu"), ("cuda", cuda)):
        out[name] = str(tmp_path / f"{name}.str")
        write_device_table(out[name], scan_file(path, dev), opts)
    assert open(out["cuda"], "rb").read() == open(out["cpu"], "rb").read()


def test_sharded_k1_on_card_equals_plain(cuda):
    """A resident table sharded over 4 shards on the card: each shard's
    planes through K1 equal the plain version on the same blocks, and the
    sharded Q6 / grouped sums equal the single-device table's."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import make_resident
    from strawboat_tpu_torch.parallel import make_mesh, shard_resident, sharded_group_sum

    cols = tpch.generate_lineitem(1.0, seed=0, rows=3_000_000)
    rt = make_resident({k: cols[k] for k in tpch.Q1_Q6_COLUMNS}, cuda)
    srt = shard_resident(rt, make_mesh(4, cuda), "shards")
    planes = [p for c in srt.columns.values() for local in c.local for p in local.planes]
    before = (obs.counter("k1.launches"), obs.counter("k1.planes"))
    got = bu.bitunpack_tiled_many(planes)
    torch.cuda.synchronize()
    # every shard's planes in one launch
    assert (obs.counter("k1.launches"), obs.counter("k1.planes")) == (
        before[0] + 1, before[1] + len(planes))
    for (w, b), g in zip(planes, got):
        assert torch.equal(g, bu.bitunpack_tiled_plain(w, 0, b)), b
    (sums,), cnt = sharded_group_sum(srt, "l_returnflag", ["l_quantity"], 3)
    (want,), want_cnt = rt.group_sum("l_returnflag", ["l_quantity"], 3)
    assert torch.equal(sums, want) and torch.equal(cnt, want_cnt)


@pytest.mark.parametrize("seed", [0, 0xA5A500FF])
def test_k1_many_matches_plain_on_card(cuda, seed):
    """One launch over up to 64 planes of mixed widths and tiles, at each
    split; two launches past the cap."""
    g = torch.Generator(device=cuda).manual_seed(seed & 0xFFFF)

    def plane(n, b, tile):
        return (torch.randint(-(2**31), 2**31 - 1, (n, b, tile), dtype=torch.int32, device=cuda,
                              generator=g), b)

    planes = [plane(2, b, tile) for tile in (16384, 512) for b in range(1, 33)]
    for many in (planes, planes[:5], planes + planes[:6]):
        before = (obs.counter("k1.launches"), obs.counter("k1.planes"))
        got = bu.bitunpack_tiled_many(many, seed)
        torch.cuda.synchronize()
        launches = 1 if len(many) <= bu.K1_MAX_PLANES else 2
        assert (obs.counter("k1.launches"), obs.counter("k1.planes")) == (
            before[0] + launches, before[1] + len(many))
        for (w, b), o in zip(many, got):
            assert torch.equal(o, bu.bitunpack_tiled_plain(w, seed, b)), (b, tuple(w.shape))


def test_k1_odd_tile_and_misaligned_base_on_card(cuda):
    """A tile that is not a multiple of 4 and a base 4 bytes past 16 take
    the kernel's scalar path and equal the plain version; a non-contiguous
    plane raises before any launch."""
    g = torch.Generator(device=cuda).manual_seed(3)
    odd = torch.randint(-(2**31), 2**31 - 1, (3, 9, 1001), dtype=torch.int32, device=cuda,
                        generator=g)
    flat = torch.randint(-(2**31), 2**31 - 1, (1 + 2 * 13 * 512,), dtype=torch.int32,
                         device=cuda, generator=g)
    shifted = flat[1:].view(2, 13, 512)
    assert shifted.data_ptr() % 16 == 4
    for w, b in ((odd, 9), (shifted, 13)):
        assert torch.equal(bu.bitunpack_tiled(w, 7, b), bu.bitunpack_tiled_plain(w, 7, b))
    for w, o in zip((odd, shifted), bu.bitunpack_tiled_many([(odd, 9), (shifted, 13)], 7)):
        assert torch.equal(o, bu.bitunpack_tiled_plain(w, 7, w.shape[1]))
    before = obs.counter("k1.launches")
    with pytest.raises(ValueError, match="contiguous"):
        bu.bitunpack_tiled_many([(odd, 9), (flat[: 2 * 13 * 512].view(2, 512, 13).transpose(1, 2), 13)])
    assert obs.counter("k1.launches") == before


def test_sharded_and_resident_q6_launch_k1_once_on_card(cuda):
    """Resident Q6 and Q1 and the sharded Q6 over 4 shards on one card each
    make exactly one K1 launch, with the numpy answers."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import make_resident
    from strawboat_tpu_torch.parallel import make_mesh, shard_resident, sharded_filter_sum

    cols = tpch.generate_lineitem(1.0, seed=0, rows=2_000_000)
    rt = make_resident({k: cols[k] for k in tpch.Q1_Q6_COLUMNS}, cuda)
    srt = shard_resident(rt, make_mesh(4, cuda), "shards")
    q6 = ({"l_shipdate": (731, 1096), "l_discount": (5, 8), "l_quantity": (None, 24)},
          "l_extendedprice", "l_discount")
    for run, planes in ((lambda: tpch.q6(rt), 4), (lambda: tpch.q1(rt), 7),
                        (lambda: sharded_filter_sum(srt, *q6), 16)):
        before = (obs.counter("k1.launches"), obs.counter("k1.planes"))
        run()
        torch.cuda.synchronize()
        assert (obs.counter("k1.launches"), obs.counter("k1.planes")) == (
            before[0] + 1, before[1] + planes)
    assert int(sharded_filter_sum(srt, *q6)) == int(tpch.q6(rt)) == tpch.q6_numpy_reference(cols)


def test_all_to_all_and_psum_on_card(cuda):
    """The collectives on a 4-shard mesh on the card equal them on the CPU."""
    from strawboat_tpu_torch.parallel import all_to_all, make_mesh, psum

    rng = np.random.default_rng(5)
    bins = [torch.from_numpy(rng.integers(-(2**62), 2**62, (4, 1000))) for _ in range(4)]
    cpu = make_mesh(4, "cpu").axis_devices("shards")
    card = make_mesh(4, cuda).axis_devices("shards")
    got = all_to_all([b.to(cuda) for b in bins], card)
    for g, w in zip(got, all_to_all(bins, cpu)):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    sums = psum([b.to(cuda) for b in bins], card)
    assert all(torch.equal(s.cpu(), psum(bins, cpu)[0]) for s in sums)


def test_gloo_world_of_two_on_card_sharded_q6(cuda, tmp_path):
    """Two ranks on the one card under gloo (NCCL refuses two ranks on one
    card), an 8-shard mesh of 4 shards a rank: the sharded Q6 and grouped
    sums equal the single-process mesh's on the card, each rank's Q6 one
    K1 launch over its 16 planes."""
    from _torch_world import N, run_case, run_world
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.parallel import make_mesh
    from strawboat_tpu_torch.write import write_file

    rng = np.random.default_rng(17)
    cols = {nm: rng.integers(0, hi, 40960).astype(np.int32)
            for nm, hi in (("sd", 2557), ("qty", 51), ("disc", 11), ("ep", 60000), ("grp", 6))}
    path = str(tmp_path / "res.str")
    write_file(path, cols, options=WriteOptions(default_compression=Compression.LZ4,
                                                max_page_size=4096))
    inp = {"resident_path": path,
           "q6_preds": {"sd": (731, 1096), "disc": (5, 8), "qty": (None, 24)}}
    got = run_world(2, inp, ["resident"], str(tmp_path / "world"), device="cuda:0",
                    backend="gloo")["resident"]
    want = run_case("resident", make_mesh(N, "cuda:0"), inp)
    m = ((cols["sd"] >= 731) & (cols["sd"] < 1096) & (cols["disc"] >= 5) & (cols["disc"] < 8)
         & (cols["qty"] < 24))
    assert int(got["q6"]) == int(want["q6"]) == int(
        (cols["ep"][m].astype(np.int64) * cols["disc"][m]).sum())
    for g, w in zip(got["group"][0] + (got["group"][1],), want["group"][0] + (want["group"][1],)):
        assert torch.equal(g, w)
    assert got["q6_k1_launches"] == [1, 1]
    assert got["k1_calls"] == [([16], [12])] * 2


def test_nccl_world_of_one_collectives_on_card(cuda, tmp_path):
    """A world of one process under NCCL: ``all_to_all`` and ``psum`` on a
    4-shard mesh equal the device-copy versions of the same mesh without a
    world, and the psum's ``all_reduce`` is a process-group call."""
    import torch.distributed as dist

    from strawboat_tpu_torch.parallel import all_to_all, distributed_init, make_mesh, psum
    from strawboat_tpu_torch.parallel.collectives import exchange_summary, record_exchanges

    rng = np.random.default_rng(6)
    bins = [torch.from_numpy(rng.integers(-(2**62), 2**62, (4, 1000))).to(cuda) for _ in range(4)]
    devs = make_mesh(4, cuda).axis_devices("shards")
    want_a2a, want_sum = all_to_all(bins, devs), psum(bins, devs)
    distributed_init(f"file://{tmp_path / 'store'}", 1, 0, cuda, timeout=120)
    try:
        assert dist.get_backend() == "nccl"
        world_devs = make_mesh(4, cuda).axis_devices("shards")
        with record_exchanges() as recs:
            got_a2a, got_sum = all_to_all(bins, world_devs), psum(bins, world_devs)
        ops = [r["op"] for r in exchange_summary(recs)]
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(g, w) for g, w in zip(got_a2a, want_a2a))
    assert all(torch.equal(g, w) for g, w in zip(got_sum, want_sum))
    assert ops == ["all_to_all", "all_reduce", "psum"]


def test_nccl_world_of_four_cards(cuda, tmp_path):
    """Four ranks under NCCL, one card each, an 8-shard mesh of 2 shards a
    rank: every case of ``tests/_torch_world.py`` gives the single-process
    mesh's shards on one card, each rank's sharded Q6 one K1 launch.
    Needs four cards on one host; skips with fewer."""
    from _torch_world import CASES, N, assert_same, make_inputs, run_case, run_world
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression
    from strawboat_tpu_torch.parallel import make_mesh
    from strawboat_tpu_torch.write import write_file

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")

    def write(path, table, page, **opts):
        write_file(str(path), table, options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=page, **opts))
        return str(path)

    inp = make_inputs(tmp_path, write)
    names = [n for n in CASES if n != "refusals"]
    got = run_world(4, inp, names + ["refusals"], str(tmp_path / "world"), device="cuda")
    single = make_mesh(N, cuda)
    for name in names:
        assert_same(got[name], run_case(name, single, inp))
    assert got["resident"]["q6_k1_launches"] == [1] * 4
    assert got["refusals"]["first_shard"] == [0, 2, 4, 6]


@pytest.mark.parametrize("flags", [("STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION"),
                                   ("STRAWBOAT_BITPACK_COMPRESSION",)])
def test_fixed_binary_scan_on_card_equals_plain_scan(cuda, tmp_path, monkeypatch, flags):
    """fixed_size_binary[1|2|4|8] columns scan on the card (the 4-byte
    column's pages through K3) to the integers the CPU scan gives, which
    are the generated ones."""
    import pyarrow as pa

    from strawboat_tpu_torch.api import write_file
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.exec import Query, col, scan_file

    for f in flags:
        monkeypatch.setenv(f, "1")
    rng = np.random.default_rng(4)
    n = 4 * 65536  # whole pages of 65536 rows: the writer bit-packs multiples of 128
    ints = {w: rng.integers(0, 1 << min(8 * w - 1, 20), n).astype(f"<i{w}") for w in (1, 2, 4, 8)}
    table = pa.table({f"w{w}": pa.Array.from_buffers(pa.binary(w), n, [None, pa.py_buffer(v)])
                      for w, v in ints.items()})
    path = str(tmp_path / "fixed.str")
    write_file(path, table, options=WriteOptions(max_page_size=65536))
    before = obs.counter("k3.launches")
    got = scan_file(path, cuda)
    torch.cuda.synchronize()
    assert obs.counter("k3.launches") > before
    plain = scan_file(path, "cpu")
    for w, v in ints.items():
        c = got[f"w{w}"]
        assert c.values.device.type == "cuda" and c.values.element_size() == w
        assert torch.equal(c.values.cpu(), plain[f"w{w}"].values)
        np.testing.assert_array_equal(c.values.cpu().numpy(), v)
    res = Query(path, device=cuda).filter(col("w4") < 1000).agg(c=("count", "w8")).run()
    assert int(res["c"]) == int((ints[4] < 1000).sum())


def test_q1_dense_on_card_equals_cpu(cuda, tmp_path):
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import scan_file

    cols = tpch.generate_lineitem(1.0, rows=300_000)
    path = str(tmp_path / "lineitem.str")
    tpch.write_lineitem(path, cols)
    got = tpch.q1_dense(scan_file(path, cuda))
    assert got.equals(tpch.q1_dense(scan_file(path, "cpu")))
    assert tpch.q1_table_rows(got) == tpch.q1_numpy_reference(cols)


def test_query_phase_events_resolve_on_card(cuda):
    """Recorded resident Q6 and Q1 on the card: each query root's
    ``decode`` and ``aggregate`` spans carry CUDA events that resolve to
    device milliseconds, and the answers are those of the unrecorded
    queries."""
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import make_resident

    cols = tpch.generate_lineitem(1.0, seed=0, rows=2_000_000)
    rt = make_resident({k: cols[k] for k in tpch.Q1_Q6_COLUMNS}, cuda)
    q6, q1 = int(tpch.q6(rt)), tpch.q1_rows(tpch.q1(rt))
    with obs.recording() as rec:
        assert int(tpch.q6(rt)) == q6
        assert tpch.q1_rows(tpch.q1(rt)) == q1
    roots = [r for r in rec.roots if r.name == "strawboat.query"]
    assert [r.attrs["path"] for r in roots] == ["filter_sum", "fused"]
    for r in roots:
        for phase in ("decode", "aggregate"):
            (sp,) = [s for s in r.children if s.name == f"strawboat.query.{phase}"]
            assert 0 < sp.device_ms < 1000
        decode = next(s for s in r.children if s.name == "strawboat.query.decode")
        assert decode.counts["k1.launches"] == 1

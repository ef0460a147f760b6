"""The scan's streamed raw-page feed (``exec/scan.py``,
``_decode_raw_column_streamed``) and its staging pool (``exec/arena.py``).

An integer or float column whose pages are all raw-mode streams: pages
decompress in chunks cut at page edges (one native call per run of one
codec), on a card into pooled page-locked buffers copied asynchronously.
On the CPU the chunks decompress straight into the column.  Columns with
another page among their raw ones keep the page route.  Every scan equals
the JAX scan of the same file bit for bit.  The staging pool hands a
buffer out again only after the copies that read from it are done.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import strawboat_tpu.kernels  # noqa: F401  (JAX x64 on)
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.exec.scan import scan_file as ref_scan
from strawboat_tpu_torch import native
from strawboat_tpu_torch.exec import arena, scan_file
from strawboat_tpu_torch.exec import scan as port_scan

pytestmark = pytest.mark.skipif(not native.available(), reason="the native library does not build here")


def _ref_write(path, table, **kw):
    kw.setdefault("max_page_size", 1000)
    ref_write(str(path), table, options=RefOptions(**kw))
    return str(path)


def _table(n=7000, seed=0):
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.1
    return pa.table({
        "i64": pa.array(rng.integers(-(2**62), 2**62, n)),
        "u16": pa.array(rng.integers(0, 1 << 16, n).astype(np.uint16), mask=null),
        "f64": pa.array(rng.normal(0, 1e6, n)),
        "f32": pa.array(rng.random(n).astype(np.float32)),
    })


def _assert_equal(got, want, names):
    for k in names:
        w = want[k]
        wv = np.asarray(w.host_exact if w.host_exact is not None else w.values)
        assert port_scan.host_values(got[k]).tobytes() == wv.tobytes(), k
        if w.validity is not None:
            np.testing.assert_array_equal(got[k].validity.numpy(), np.asarray(w.validity))


@pytest.fixture
def spy(monkeypatch):
    """Records each native call of the feed: (codec, [(offset, length)],
    size of the target buffer)."""
    calls = []
    inner = native.decompress_batch_into

    def record(codec, inputs, out, offsets, lens):
        calls.append((codec, list(zip(np.asarray(offsets).tolist(), np.asarray(lens).tolist())),
                      out.size))
        return inner(codec, inputs, out, offsets, lens)

    monkeypatch.setattr(native, "decompress_batch_into", record)
    return calls


@pytest.mark.parametrize("codec", [RefCompression.NONE, RefCompression.LZ4, RefCompression.ZSTD])
def test_raw_columns_stream_and_equal_jax(tmp_path, spy, codec):
    table = _table()
    path = _ref_write(tmp_path / "r.str", table, default_compression=codec)
    got = scan_file(path, "cpu")
    _assert_equal(got, ref_scan(path), table.column_names)
    # one call per column at the default chunk size (every column fits one)
    assert [c[0] for c in spy] == [int(codec)] * 4
    assert [sum(n for _o, n in c[1]) for c in spy] == [7000 * 8, 7000 * 2, 7000 * 8, 7000 * 4]


def test_chunks_cut_at_page_edges(tmp_path, spy, monkeypatch):
    """Under a 20 000-byte chunk, 1000-row pages of 8 bytes a value go two
    to a chunk, of 4 bytes five, of 2 bytes all seven; a page larger than
    the chunk is a chunk of its own; each chunk's pages fill its buffer
    from offset 0 back to back."""
    assert port_scan.chunk_cuts([8000] * 7, 20_000) == [(0, 2), (2, 4), (4, 6), (6, 7)]
    assert port_scan.chunk_cuts([2000] * 7, 20_000) == [(0, 7)]
    assert port_scan.chunk_cuts([5000, 5000, 30_000, 1, 1], 10_000) == [(0, 2), (2, 3), (3, 5)]
    assert port_scan.chunk_cuts([], 10) == []
    monkeypatch.setattr(port_scan, "_UPLOAD_CHUNK", 20_000)
    table = _table()
    path = _ref_write(tmp_path / "r.str", table, default_compression=RefCompression.LZ4)
    got = scan_file(path, "cpu")
    _assert_equal(got, ref_scan(path), table.column_names)
    per_col = [4, 1, 4, 2]  # i64, u16, f64, f32
    assert len(spy) == sum(per_col)
    for _codec, slices, size in spy:
        offs = [o for o, _n in slices]
        lens = [n for _o, n in slices]
        assert offs[0] == 0 and offs == list(np.cumsum([0] + lens[:-1]))
        assert sum(lens) <= max(20_000, lens[0]) and size >= sum(lens)


def test_mixed_codec_column_keeps_the_page_route(tmp_path, spy, monkeypatch):
    """The chooser mixes raw and structured pages in a column: that column
    decodes page by page (no feed), the others stream; both equal JAX."""
    rng = np.random.default_rng(3)
    n = 6000
    mixed = np.concatenate([rng.integers(0, 4, 3000), rng.integers(0, 1 << 40, 3000)])
    table = pa.table({"mixed": pa.array(mixed), "raw": pa.array(rng.normal(size=n))})
    path = _ref_write(tmp_path / "m.str", table, default_compression=RefCompression.LZ4,
                      default_compress_ratio=1.0, sample_seed=0)
    routes = []
    inner = port_scan._decode_raw_column_streamed
    monkeypatch.setattr(port_scan, "_decode_raw_column_streamed",
                        lambda plans, dt, dev: routes.append(r := inner(plans, dt, dev)) or r)
    got = scan_file(path, "cpu")
    _assert_equal(got, ref_scan(path), ["mixed", "raw"])
    assert routes[0] is None and routes[1] is not None


def test_feed_without_the_native_library_takes_the_page_route(tmp_path, monkeypatch):
    table = _table(n=3000)
    path = _ref_write(tmp_path / "n.str", table, default_compression=RefCompression.NONE)
    monkeypatch.setattr(native, "available", lambda: False)
    _assert_equal(scan_file(path, "cpu"), ref_scan(path), table.column_names)


class _Event:
    """A stand-in for a CUDA event: done once ``fire`` is called; counts
    ``synchronize`` calls (each waits for the copy)."""

    def __init__(self):
        self.done = False
        self.waits = 0

    def fire(self):
        self.done = True

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True


@pytest.fixture
def pool():
    arena.clear()
    yield arena
    arena.clear()


def test_arena_reuses_a_buffer_only_after_its_copies(pool):
    a = pool.acquire(3000, pin=False)
    assert a.numel() == 3000 and a.dtype == torch.uint8
    b = pool.acquire(3000, pin=False)
    assert a.data_ptr() != b.data_ptr()  # a is out: never handed out twice
    ev_a = _Event()
    pool.release(a, [ev_a])
    # a's copy is in flight and the pool has room: a new buffer, no wait
    c = pool.acquire(3000, pin=False)
    assert c.data_ptr() not in (a.data_ptr(), b.data_ptr()) and ev_a.waits == 0
    ev_a.fire()
    d = pool.acquire(2000, pin=False)  # a's copy is done: a comes back
    assert d.data_ptr() == a.data_ptr() and ev_a.waits == 0
    assert pool.pooled_bytes() == 0
    # a full pool of busy buffers: acquire waits on the smallest that fits
    events = [_Event() for _ in range(pool.MAX_POOLED)]
    bufs = [pool.acquire((i + 1) << 20, pin=False) for i in range(pool.MAX_POOLED)]
    for buf, ev in zip(bufs, events):
        pool.release(buf, [ev])
    got = pool.acquire(3 << 19, pin=False)
    assert got.data_ptr() == bufs[1].data_ptr()
    assert [e.waits for e in events] == [0, 1, 0, 0]
    # a release past the bound drops the smallest buffer
    pool.release(got, [])
    pool.release(torch.empty(8 << 20, dtype=torch.uint8), [])
    assert pool.pooled_bytes() == (2 + 3 + 4 + 8) << 20


def test_arena_never_hands_one_buffer_to_two_holders(pool):
    """Threads acquire and release at once, with the interpreter switching
    threads often: no buffer is ever held by two of them."""
    import sys
    import threading

    held, lock, clashes = set(), threading.Lock(), []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            buf = pool.acquire(int(rng.integers(1, 3 << 20)), pin=False)
            with lock:
                if buf.data_ptr() in held:
                    clashes.append(buf.data_ptr())
                held.add(buf.data_ptr())
            with lock:
                held.discard(buf.data_ptr())
            pool.release(buf, [])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert clashes == []
    assert pool.pooled_bytes() <= pool.MAX_POOLED * (3 << 20)

"""K1 (tiled bit-plane unpack) in the torch port against the reference's
Pallas kernel, run in interpret mode, for every width 1..32.

On the CPU the port's wrapper runs its plain torch version; the CUDA kernel
itself is compared with that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Exact equality
everywhere: this is integer bit manipulation.
"""

import importlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strawboat_tpu_torch.kernels import bitunpack as port
from strawboat_tpu_torch.util import obs

SEEDS = (0, 0xA5A500FF)


@pytest.fixture(scope="module")
def ref():
    """The reference Pallas module with every pallas_call interpreted."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    from strawboat_tpu.kernels import bitunpack_pallas as m

    with mock.patch.object(pl, "pallas_call", patched):
        importlib.reload(m)
        yield m
    importlib.reload(m)


def _words(b, n_tiles=2, tile=512, seed=0):
    rng = np.random.default_rng(1000 + b + seed)
    return rng.integers(0, 1 << 32, (n_tiles, b, tile), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("b", range(1, 33))
def test_unpack_matches_reference(ref, b):
    from strawboat_tpu.exec.resident import _rows_to_t_major

    w = _words(b)
    for seed in SEEDS:
        out3 = ref.bitunpack_pallas_tiled_seeded(jnp.asarray(w), jnp.uint32(seed), b)
        want = np.asarray(_rows_to_t_major(out3, b))
        got = port.bitunpack_tiled(torch.from_numpy(w.view(np.int32)), seed, b)
        assert got.dtype == torch.int32 and tuple(got.shape) == (2, 32, 512)
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32), want, err_msg=f"b={b} seed={seed:#x}"
        )


def test_host_helpers_match_reference(ref):
    assert (port.LANE_TILE, port.TILE3D) == (ref.LANE_TILE, ref.TILE3D)
    rng = np.random.default_rng(5)
    for b in range(1, 33):
        np.testing.assert_array_equal(port.tiled_rows_to_t(b), ref.tiled_rows_to_t(b))
        for n_blocks, tile in ((3, 512), (200, 512), (130, 1024)):
            words = rng.integers(0, 1 << 32, n_blocks * 4 * b, dtype=np.uint64).astype(
                np.uint32
            )
            np.testing.assert_array_equal(
                port.transpose_words_host(words, b), ref.transpose_words_host(words, b)
            )
            np.testing.assert_array_equal(
                port.transpose_words_host_tiled(words, b, tile),
                ref.transpose_words_host_tiled(words, b, tile),
            )


def test_wrapper_rejects_bad_input():
    w = torch.zeros((2, 5, 512), dtype=torch.int32)
    with pytest.raises(TypeError):
        port.bitunpack_tiled(w.to(torch.int64), 0, 5)
    with pytest.raises(ValueError):
        port.bitunpack_tiled(w, 0, 6)  # plane count disagrees with bits
    with pytest.raises(ValueError):
        port.bitunpack_tiled(torch.zeros((2, 33, 512), dtype=torch.int32), 0, 33)
    with pytest.raises(ValueError):
        port.bitunpack_tiled(w[0], 0, 5)


def test_cpu_tensor_runs_plain_and_counts_no_launch():
    """A CPU tensor takes the plain version; the launch count only moves
    where the CUDA kernel launches."""
    before = obs.counter("k1.launches")
    w = torch.from_numpy(_words(7).view(np.int32))
    got = port.bitunpack_tiled(w, 3, 7)
    assert torch.equal(got, port.bitunpack_tiled_plain(w, 3, 7))
    assert obs.counter("k1.launches") == before


# ---------------------------------------------------------------------------
# K2 (the unseeded tiled kernel) and K0 (the 2-D stripe kernel): the K1
# kernel at seed 0, against their own interpreted Pallas kernels


@pytest.mark.parametrize("b", range(1, 33))
def test_k2_matches_reference(ref, b):
    w = _words(b)
    out3 = ref.bitunpack_pallas_tiled(jnp.asarray(w), b)
    inv = np.argsort(ref.tiled_rows_to_t(b))  # row of value t
    got = port.bitunpack_tiled_unseeded(torch.from_numpy(w.view(np.int32)), b)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32), np.asarray(out3)[:, inv], err_msg=f"b={b}"
    )
    # the flat natural order, restored by reshapes over t order
    np.testing.assert_array_equal(
        port.bitunpack_tiled_to_flat(got).numpy().view(np.uint32),
        np.asarray(ref.bitunpack_tiled_to_flat(out3, b)),
        err_msg=f"flat b={b}",
    )


@pytest.mark.parametrize("b", range(1, 33))
def test_k0_matches_reference(ref, b):
    rng = np.random.default_rng(2000 + b)
    wt = rng.integers(0, 1 << 32, (b, 1024), dtype=np.uint64).astype(np.uint32)
    got = port.bitunpack_tmajor(torch.from_numpy(wt.view(np.int32)), b)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.asarray(ref.bitunpack_pallas_tmajor(jnp.asarray(wt), b)),
        err_msg=f"b={b}",
    )
    np.testing.assert_array_equal(
        port.bitunpack_tmajor_natural(torch.from_numpy(wt.view(np.int32)), b)
        .numpy()
        .view(np.uint32),
        np.asarray(ref.bitunpack_pallas(jnp.asarray(wt), b)),
        err_msg=f"natural b={b}",
    )


def test_k2_k0_plain_versions_and_counts():
    """On the CPU the wrappers run their plain versions and count no
    launch; the plain versions are K1's at seed 0."""
    w = torch.from_numpy(_words(9).view(np.int32))
    counts = (obs.counter("k2.launches"), obs.counter("k0.launches"))
    assert torch.equal(port.bitunpack_tiled_unseeded(w, 9), port.bitunpack_tiled_plain(w, 0, 9))
    wt = w[0]
    assert torch.equal(port.bitunpack_tmajor(wt, 9), port.bitunpack_tiled_plain(w[:1], 0, 9)[0])
    assert counts == (obs.counter("k2.launches"), obs.counter("k0.launches"))
    with pytest.raises(ValueError):
        port.bitunpack_tmajor(torch.zeros((9, 500), dtype=torch.int32), 9)  # lanes % 512
    with pytest.raises(ValueError):
        port.bitunpack_tmajor(w, 9)  # not 2-D


# ---------------------------------------------------------------------------
# K1 over many planes: one launch over a list of planes, and its launches


def _plane_list(specs, seed=0):
    """[(int32 words, bits)] of ``specs`` [(n_tiles, bits, tile)], seeded."""
    out = []
    for i, (n, b, tile) in enumerate(specs):
        w = _words(b, n_tiles=n, tile=tile, seed=seed + 7 * i)
        out.append((torch.from_numpy(w.view(np.int32)), b))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_many_matches_reference(ref, seed):
    """Mixed widths and tiles in one call equal the reference's seeded
    kernel plane by plane, after ``_rows_to_t_major``."""
    from strawboat_tpu.exec.resident import _rows_to_t_major

    specs = [(2, b, tile) for b, tile in ((1, 512), (5, 1024), (12, 512), (23, 1024), (32, 512),
                                          (2, 1024), (7, 512))]
    planes = _plane_list(specs, seed & 0xFF)
    got = port.bitunpack_tiled_many(planes, seed)
    assert len(got) == len(planes)
    for (w, b), g in zip(planes, got):
        out3 = ref.bitunpack_pallas_tiled_seeded(jnp.asarray(w.numpy().view(np.uint32)),
                                                 jnp.uint32(seed), b)
        want = np.asarray(_rows_to_t_major(out3, b))
        assert tuple(g.shape) == (w.shape[0], 32, w.shape[2])
        np.testing.assert_array_equal(g.numpy().view(np.uint32), want, err_msg=f"b={b}")


def test_many_odd_tiles_and_long_lists_equal_plain():
    """Tiles that are not a multiple of 4 and lists past one launch's cap
    give each plane's plain unpack."""
    specs = [(1 + i % 3, 1 + i % 32, (1001, 512, 3, 16384)[i % 4]) for i in range(70)]
    planes = _plane_list(specs)
    got = port.bitunpack_tiled_many(planes, 0xA5A500FF)
    for (w, b), g in zip(planes, got):
        assert torch.equal(g, port.bitunpack_tiled_plain(w, 0xA5A500FF, b))
    assert port.bitunpack_tiled_many([]) == []


@pytest.mark.parametrize("n_planes", [0, 1, 64, 70, 129])
def test_plan_splits_past_the_cap(n_planes):
    """Every plane in exactly one launch, in order, at most
    ``K1_MAX_PLANES`` a launch, in as few launches as that allows."""
    plan = port.plan_tiled_launch(n_planes)
    assert [i for lo, hi in plan for i in range(lo, hi)] == list(range(n_planes))
    assert all(0 < hi - lo <= port.K1_MAX_PLANES for lo, hi in plan)
    assert len(plan) == -(-n_planes // port.K1_MAX_PLANES)


def test_descriptors_pack_each_plane():
    """A plane's descriptor: its words and out, shape, seed and width; the
    C entry lays out the CTAs, so ``cta_begin`` goes as 0."""
    planes = _plane_list([(2, 3, 512), (1, 5, 1024)])
    descs = port.tiled_descriptors(planes, [4096, 8192], 0x1A5A500FF)
    assert len(descs) == 2 * port._PLANE.size == 80
    assert port._PLANE.unpack(descs[:40]) == (planes[0][0].data_ptr(), 4096, 512, 2, 0, 0xA5A500FF, 3)
    assert port._PLANE.unpack(descs[40:]) == (planes[1][0].data_ptr(), 8192, 1024, 1, 0, 0xA5A500FF, 5)


def test_many_cpu_counts_no_launch_and_rejects_bad_lists():
    before = (obs.counter("k1.launches"), obs.counter("k1.planes"))
    planes = _plane_list([(1, 3, 512), (2, 8, 512)])
    got = port.bitunpack_tiled_many(planes, 3)
    assert all(torch.equal(g, port.bitunpack_tiled_plain(w, 3, b)) for (w, b), g in zip(planes, got))
    assert (obs.counter("k1.launches"), obs.counter("k1.planes")) == before
    meta = torch.empty((1, 3, 512), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        port.bitunpack_tiled_many([planes[0], (meta, 3)])
    w8 = torch.zeros((2, 8, 1024), dtype=torch.int32)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        port.bitunpack_tiled_many([planes[0], (w8, 8)])
    with pytest.raises(ValueError):
        port.bitunpack_tiled_many([(planes[0][0], 4)])  # plane count disagrees with bits

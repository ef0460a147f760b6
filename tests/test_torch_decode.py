"""The scan's device decoders in the torch port against the JAX package.

K3 (``bitunpack_natural``) runs its plain torch version here and is held
against the reference's XLA ``bitunpack_device`` for every width 0..32 and
against its interpreted Pallas kernel for the widths that kernel takes;
the other decoders of ``strawboat_tpu.kernels.decode`` against their torch
counterparts.  Exact equality everywhere: integer bit manipulation.
"""

import importlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strawboat_tpu.kernels import decode as jref
from strawboat_tpu.util.bits import pack_blocks
from strawboat_tpu_torch.kernels import bitunpack as bu
from strawboat_tpu_torch.kernels import decode as port
from strawboat_tpu_torch.util import obs

SEEDS = (0, 0xA5A500FF)


@pytest.fixture(scope="module")
def pallas():
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


def _block_words(b, n_blocks=37, seed=0):
    rng = np.random.default_rng(100 + b + seed)
    return rng.integers(0, 1 << 32, (n_blocks, 4 * b), dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("b", range(0, 33))
def test_k3_matches_bitunpack_device(b):
    words = _block_words(b)
    for seed in SEEDS:
        want = np.asarray(jref.bitunpack_device(jnp.asarray(words ^ np.uint32(seed)), b))
        got = bu.bitunpack_natural(_t(words), seed, b)
        assert got.dtype == torch.int32 and tuple(got.shape) == (37 * 128,)
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32), want.reshape(-1), err_msg=f"b={b} seed={seed:#x}"
        )


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
def test_k3_matches_interpreted_pallas_kernel(pallas, b):
    """The TPU path: relayout into (n_tiles, b, 512) tiles, then the
    natural-order kernel; flat, cut to the block count."""
    n_blocks = 300
    words = _block_words(b, n_blocks)
    wt3 = pallas.transpose_words_host_tiled(words.reshape(-1), b, 512)
    for seed in SEEDS:
        want = np.asarray(
            pallas.bitunpack_pallas_tiled_natural(jnp.asarray(wt3), jnp.uint32(seed), b)
        ).reshape(-1)[: n_blocks * 128]
        got = bu.bitunpack_natural(_t(words), seed, b)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want, err_msg=f"b={b}")


def test_k3_round_trips_packed_values():
    rng = np.random.default_rng(7)
    for b in (3, 7, 12, 31):
        vals = rng.integers(0, 1 << b, (20, 128), dtype=np.uint64).astype(np.uint32)
        got = port.bitunpack_natural_device(_t(pack_blocks(vals, b)), b)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), vals.reshape(-1))


def test_k3_cpu_runs_plain_and_rejects_bad_input():
    before = obs.counter("k3.launches")
    w = _t(_block_words(5))
    assert torch.equal(bu.bitunpack_natural(w, 9, 5), bu.bitunpack_natural_plain(w, 9, 5))
    assert obs.counter("k3.launches") == before
    with pytest.raises(ValueError):
        bu.bitunpack_natural(w, 0, 6)  # 4*bits disagrees with the words
    with pytest.raises(TypeError):
        bu.bitunpack_natural(w.long(), 0, 5)
    with pytest.raises(ValueError):
        bu.bitunpack_natural(w, 0, 33)


@pytest.mark.parametrize("b", [1, 6, 13, 32])
def test_delta_bitunpack_matches_reference(b):
    words = _block_words(b, 9)
    want = np.asarray(jref.delta_bitunpack_device(jnp.asarray(words), b))
    got = port.delta_bitunpack_device(_t(words), b)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_prefix_sum_wraps_mod_2_32():
    x = np.array([0xFFFFFFFF, 2, 0x80000000, 0x80000000, 5], dtype=np.uint32)
    got = port.low32(port.prefix_sum_u32(_t(x)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.cumsum(x, dtype=np.uint32))


def test_varwidth_matches_reference():
    rng = np.random.default_rng(11)
    widths = np.array([0, 1, 5, 13, 32, 7, 0, 20, 31, 16], dtype=np.int32)
    bmax = int(widths.max())
    words = np.zeros((len(widths), bmax * 4), dtype=np.uint32)
    for i, w in enumerate(widths):
        words[i, : 4 * w] = rng.integers(0, 1 << 32, 4 * w, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jref.bitunpack_varwidth_device(jnp.asarray(words), jnp.asarray(widths), bmax))
    got = port.bitunpack_varwidth_device(_t(words), torch.from_numpy(widths), bmax)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    zero = port.bitunpack_varwidth_device(torch.zeros((3, 0), dtype=torch.int32), torch.zeros(3), 0)
    assert tuple(zero.shape) == (3, 128) and not zero.any()


@pytest.mark.parametrize(
    "counts,total",
    [
        ([3, 0, 2, 5], 10),  # a zero-count run in the middle
        ([0, 0, 4, 4], 6),  # leading empty runs; the last run is cut
        ([2, 3], 9),  # positions past the runs repeat the last run
        ([0, 0], 3),  # no non-empty run: run 0
    ],
)
def test_rle_expand_matches_reference(counts, total):
    values = np.array([-7, 11, 2**40, -1], dtype=np.int64)[: len(counts)]
    c = np.asarray(counts, dtype=np.int32)
    want = np.asarray(jref.rle_expand_device(jnp.asarray(c), jnp.asarray(values), total))
    got = port.rle_expand_device(torch.from_numpy(c), torch.from_numpy(values), total)
    np.testing.assert_array_equal(got.numpy(), want)


def test_one_value_freq_and_validity_match_reference():
    v = np.int64(-123456789012)
    np.testing.assert_array_equal(
        port.one_value_device(torch.tensor(v), 5).numpy(),
        np.asarray(jref.one_value_device(jnp.asarray(v), 5)),
    )
    top = np.int32(300)
    pos = np.array([0, 4, 9, 12, 99], dtype=np.int32)  # 12 and 99 fall outside
    exc = np.array([1, -2, 3, 4, 5], dtype=np.int32)
    np.testing.assert_array_equal(
        port.freq_scatter_device(
            torch.tensor(top), torch.from_numpy(pos), torch.from_numpy(exc), 10
        ).numpy(),
        np.asarray(jref.freq_scatter_device(jnp.asarray(top), jnp.asarray(pos), jnp.asarray(exc), 10)),
    )
    packed = np.array([0b10110001, 0xFF, 0x00], dtype=np.uint8)
    np.testing.assert_array_equal(
        port.unpack_validity_device(torch.from_numpy(packed), 20).numpy(),
        np.asarray(jref.unpack_validity_device(jnp.asarray(packed), 20)),
    )


def test_dict_gather_matches_reference():
    d = np.array([5, -3, 2**33, 0], dtype=np.int64)
    idx = np.array([3, 0, 2, 2, 1], dtype=np.int32)
    np.testing.assert_array_equal(
        port.dict_gather_device(torch.from_numpy(idx), torch.from_numpy(d)).numpy(),
        np.asarray(jref.dict_gather_device(jnp.asarray(idx), jnp.asarray(d))),
    )

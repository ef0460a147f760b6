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
    before = port.bitunpack_tiled.launches
    w = torch.from_numpy(_words(7).view(np.int32))
    got = port.bitunpack_tiled(w, 3, 7)
    assert torch.equal(got, port.bitunpack_tiled_plain(w, 3, 7))
    assert port.bitunpack_tiled.launches == before


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
    counts = (port.bitunpack_tiled_unseeded.launches, port.bitunpack_tmajor.launches)
    assert torch.equal(port.bitunpack_tiled_unseeded(w, 9), port.bitunpack_tiled_plain(w, 0, 9))
    wt = w[0]
    assert torch.equal(port.bitunpack_tmajor(wt, 9), port.bitunpack_tiled_plain(w[:1], 0, 9)[0])
    assert counts == (port.bitunpack_tiled_unseeded.launches, port.bitunpack_tmajor.launches)
    with pytest.raises(ValueError):
        port.bitunpack_tmajor(torch.zeros((9, 500), dtype=torch.int32), 9)  # lanes % 512
    with pytest.raises(ValueError):
        port.bitunpack_tmajor(w, 9)  # not 2-D

"""The bit-unpack kernels K0–K3 and their host layout helpers.

Counterpart of ``strawboat_tpu/kernels/bitunpack_pallas.py``.  Planes are
``(n_tiles, b, tile)`` words: lane column ``lane`` of tile ``ti`` packs 32
values of ``b`` bits LSB-first into its ``b`` words.  Words travel as
``int32`` views of the u32 bits.

- K1 ``bitunpack_tiled`` returns ``(n_tiles, 32, tile)`` with row ``t``
  holding value ``t`` of each column, for every ``b`` — the reference
  kernel's output after ``_rows_to_t_major``.
- K2 ``bitunpack_tiled_unseeded`` and K0 ``bitunpack_tmajor`` are the K1
  kernel at seed 0, on tiles and on one ``(b, n_lanes)`` stripe.
- K3 ``bitunpack_natural`` unpacks a page's BitPacker4x block words
  straight into natural row order (``csrc/bitunpack_natural.cu``).

On a CUDA tensor each wrapper launches its hand-written kernel and counts
the launch; on a CPU tensor it runs the plain torch version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import shr_u32, u32_to_i32
from . import _build

LANE_TILE = 512  # lanes per program == 128 blocks
TILE3D = 16384


def transpose_words_host(words: np.ndarray, b: int) -> np.ndarray:
    """(n_blocks * 4b,) packed words → (b, n_lanes) transposed, lane-padded."""
    n_blocks = words.size // (4 * b)
    w = words.reshape(n_blocks, b, 4)  # [block, word, lane]
    wt = np.ascontiguousarray(w.transpose(1, 0, 2).reshape(b, n_blocks * 4))
    n_lanes = wt.shape[1]
    pad = (-n_lanes) % LANE_TILE
    if pad:
        wt = np.pad(wt, ((0, 0), (0, pad)))
    return wt


def transpose_words_host_tiled(
    words: np.ndarray, b: int, tile: int = TILE3D
) -> np.ndarray:
    """(n_blocks * 4b,) packed words → (n_tiles, b, tile) contiguous tiles."""
    wt = transpose_words_host(words, b)  # (b, n_lanes) lane-padded to 512
    n_lanes = wt.shape[1]
    pad = (-n_lanes) % tile
    if pad:
        wt = np.pad(wt, ((0, 0), (0, pad)))
    n_tiles = wt.shape[1] // tile
    return np.ascontiguousarray(wt.reshape(b, n_tiles, tile).transpose(1, 0, 2))


def tiled_rows_to_t(b: int) -> np.ndarray:
    """row → value-index t of the TPU kernel's 32 output rows (plane order
    p*b + j for widths dividing 32).  ``bitunpack_tiled`` always emits t
    order; this states the reference's order for comparisons."""
    if 32 % b == 0:
        P = 32 // b
        rows = np.arange(32)
        return (rows % b) * P + rows // b
    return np.arange(32)


def _check(words: torch.Tensor, bits: int) -> None:
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in 1..32, got {bits}")
    if words.dtype != torch.int32:
        raise TypeError(f"words must be an int32 view of u32, got {words.dtype}")
    if words.dim() != 3 or words.shape[1] != bits:
        raise ValueError(
            f"words must be (n_tiles, {bits}, tile), got {tuple(words.shape)}"
        )


def bitunpack_tiled_plain(words: torch.Tensor, seed: int, bits: int) -> torch.Tensor:
    """Plain torch version of K1 (same inputs, same output)."""
    _check(words, bits)
    b = bits
    w = words ^ u32_to_i32(seed)
    n_tiles, _, tile = words.shape
    out = torch.empty((n_tiles, 32, tile), dtype=torch.int32, device=words.device)
    mask = u32_to_i32((1 << b) - 1)
    for t in range(32):
        w0, sh = divmod(t * b, 32)
        v = shr_u32(w[:, w0], sh)
        if sh + b > 32:
            v = v | (w[:, w0 + 1] << (32 - sh))
        out[:, t] = v & mask
    return out


@functools.cache
def _kernel(name: str, symbol: str, argtypes: tuple):
    """A compiled kernel's C entry point (built at first use)."""
    fn = getattr(_build.load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_TILED_ARGS = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
)
_NATURAL_ARGS = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p,
)


def _require_cuda(words: torch.Tensor, align: int = 4) -> None:
    """A kernel's input: on a CUDA device, contiguous, and ``data_ptr()``
    a multiple of ``align`` bytes."""
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words.data_ptr() % align:
        raise ValueError(f"words must start on a {align}-byte boundary, got {words.data_ptr():#x}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _launch_tiled(words: torch.Tensor, seed: int, bits: int) -> torch.Tensor:
    """Launch the K1 kernel on CUDA ``words`` (checked by the caller)."""
    _require_cuda(words)
    n_tiles, _, tile = words.shape
    if not 1 <= n_tiles <= 65535:
        raise ValueError(f"n_tiles must be in 1..65535, got {n_tiles}")
    out = torch.empty((n_tiles, 32, tile), dtype=torch.int32, device=words.device)
    fn = _kernel("bitunpack", "sb_bitunpack_tiled", _TILED_ARGS)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = fn(
            words.data_ptr(), out.data_ptr(), seed & 0xFFFFFFFF, bits,
            n_tiles, tile, stream,
        )
    _raise_on(err, "bitunpack")
    return out


def bitunpack_tiled(words: torch.Tensor, seed: int, bits: int) -> torch.Tensor:
    """K1: ``(n_tiles, bits, tile)`` int32 words ^ seed → ``(n_tiles, 32,
    tile)`` int32 values in t order.  CUDA tensors launch the kernel; CPU
    tensors run :func:`bitunpack_tiled_plain`."""
    _check(words, bits)
    if words.device.type == "cpu":
        return bitunpack_tiled_plain(words, seed, bits)
    out = _launch_tiled(words, seed, bits)
    bitunpack_tiled.launches += 1
    return out


bitunpack_tiled.launches = 0  # K1 launches since the last reset


# ---------------------------------------------------------------------------
# K2: the unseeded tiled unpack (reference ``bitunpack_pallas_tiled`` :174)


def bitunpack_tiled_unseeded_plain(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain torch version of K2."""
    return bitunpack_tiled_plain(words, 0, bits)


def bitunpack_tiled_unseeded(words: torch.Tensor, bits: int) -> torch.Tensor:
    """K2: ``(n_tiles, bits, tile)`` → ``(n_tiles, 32, tile)`` values in t
    order.  The K1 kernel at seed 0; the reference kernel emits plane order
    for widths dividing 32 (``tiled_rows_to_t`` states that map)."""
    _check(words, bits)
    if words.device.type == "cpu":
        return bitunpack_tiled_unseeded_plain(words, bits)
    out = _launch_tiled(words, 0, bits)
    bitunpack_tiled_unseeded.launches += 1
    return out


bitunpack_tiled_unseeded.launches = 0  # K2 launches since the last reset


def bitunpack_tiled_to_flat(out3: torch.Tensor) -> torch.Tensor:
    """K2 output ``(n_tiles, 32, tile)`` in t order → flat natural value
    order (padded length).  Lane ``4*blk + l`` runs tile-major across the
    last axis; value ``128*blk + 4*t + l``.  Counterpart of the reference's
    ``bitunpack_tiled_to_flat`` (:327), which also undid the plane order."""
    n_tiles, _, tile = out3.shape
    n_lanes = n_tiles * tile
    tm = out3.transpose(0, 1).reshape(32, n_lanes)
    return tm.reshape(32, n_lanes // 4, 4).transpose(0, 1).reshape(-1)


# ---------------------------------------------------------------------------
# K0: the 2-D stripe unpack (reference ``bitunpack_pallas_tmajor`` :41)


def _check_tmajor(wt: torch.Tensor, bits: int) -> None:
    if wt.dim() != 2:
        raise ValueError(f"wt must be (bits, n_lanes), got {tuple(wt.shape)}")
    if wt.shape[1] % LANE_TILE:
        raise ValueError(f"n_lanes must be a multiple of {LANE_TILE}, got {wt.shape[1]}")
    _check(wt.unsqueeze(0), bits)


def bitunpack_tmajor_plain(wt: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain torch version of K0."""
    _check_tmajor(wt, bits)
    return bitunpack_tiled_plain(wt.unsqueeze(0), 0, bits)[0]


def bitunpack_tmajor(wt: torch.Tensor, bits: int) -> torch.Tensor:
    """K0: ``(bits, n_lanes)`` transposed words → ``(32, n_lanes)`` values,
    row t holding value t of each lane column: the K1 kernel on one
    ``(1, bits, n_lanes)`` tile at seed 0."""
    _check_tmajor(wt, bits)
    if wt.device.type == "cpu":
        return bitunpack_tmajor_plain(wt, bits)
    out = _launch_tiled(wt.unsqueeze(0), 0, bits)[0]
    bitunpack_tmajor.launches += 1
    return out


bitunpack_tmajor.launches = 0  # K0 launches since the last reset


def bitunpack_tmajor_natural(wt: torch.Tensor, bits: int) -> torch.Tensor:
    """``(bits, n_lanes)`` → ``(n_lanes * 8,)`` values in natural order:
    K0, then ``tm[t, 4*blk + l] → out[128*blk + 4*t + l]`` (the reference's
    ``bitunpack_pallas`` :67)."""
    tm = bitunpack_tmajor(wt, bits)
    n_blocks = tm.shape[1] // 4
    return tm.reshape(32, n_blocks, 4).transpose(0, 1).reshape(-1)


# ---------------------------------------------------------------------------
# K3: natural-order unpack straight from the page's block words
# (reference ``bitunpack_pallas_tiled_natural`` :298)

# blocks one CTA of the K3 kernel unpacks (``kBlocksPerCta`` in
# ``csrc/bitunpack_natural.cu``); the tests check tails around it
NATURAL_CTA_BLOCKS = 32


def _check_natural(words: torch.Tensor, bits: int) -> None:
    if not 0 <= bits <= 32:
        raise ValueError(f"bits must be in 0..32, got {bits}")
    if words.dtype != torch.int32:
        raise TypeError(f"words must be an int32 view of u32, got {words.dtype}")
    if words.dim() != 2 or words.shape[1] != 4 * bits:
        raise ValueError(
            f"words must be (n_blocks, {4 * bits}), got {tuple(words.shape)}"
        )


def bitunpack_natural_plain(words: torch.Tensor, seed: int, bits: int) -> torch.Tensor:
    """Plain torch version of K3 (same inputs, same output)."""
    _check_natural(words, bits)
    n_blocks = words.shape[0]
    b = bits
    if b == 0:
        return torch.zeros(n_blocks * 128, dtype=torch.int32, device=words.device)
    lanes = (words ^ u32_to_i32(seed)).view(n_blocks, b, 4)
    out = torch.empty((n_blocks, 32, 4), dtype=torch.int32, device=words.device)
    mask = u32_to_i32((1 << b) - 1)
    for t in range(32):
        w0, sh = divmod(t * b, 32)
        v = shr_u32(lanes[:, w0], sh)
        if sh + b > 32:
            v = v | (lanes[:, w0 + 1] << (32 - sh))
        out[:, t] = v & mask
    return out.reshape(-1)


def bitunpack_natural(words: torch.Tensor, seed: int, bits: int) -> torch.Tensor:
    """K3: ``(n_blocks, 4*bits)`` int32 block words ^ seed → ``(n_blocks *
    128,)`` int32 values in natural order; value ``128*blk + 4*t + l`` is
    bits ``[t*bits, (t+1)*bits)`` of lane ``l``'s stream, lane ``l`` word
    ``k`` being ``words[blk, 4*k + l]``.  ``bits == 0`` gives zeros with no
    launch.  CUDA tensors launch the kernel (``csrc/bitunpack_natural.cu``)
    and must be contiguous with a 16-byte aligned ``data_ptr()``, else it
    raises; CPU tensors run :func:`bitunpack_natural_plain`."""
    _check_natural(words, bits)
    if words.device.type == "cpu" or bits == 0:
        return bitunpack_natural_plain(words, seed, bits)
    # the kernel moves 16-byte vectors: a block's row is 16*bits bytes, so
    # an aligned start aligns every row
    _require_cuda(words, align=16)
    n_blocks = words.shape[0]
    out = torch.empty(n_blocks * 128, dtype=torch.int32, device=words.device)
    if n_blocks == 0:
        return out
    fn = _kernel("bitunpack_natural", "sb_bitunpack_natural", _NATURAL_ARGS)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = fn(words.data_ptr(), out.data_ptr(), seed & 0xFFFFFFFF, bits,
                 n_blocks, stream)
    _raise_on(err, "bitunpack_natural")
    bitunpack_natural.launches += 1
    return out


bitunpack_natural.launches = 0  # K3 launches since the last reset

"""Device decoders of the scan and the resident path.

Counterpart of ``strawboat_tpu/kernels/decode.py``, whose functions are
jitted XLA (no Pallas) except the natural-order unpack.  Here they are
torch ops, except :func:`bitunpack_natural_device`, which launches kernel
K3 on a CUDA tensor (``kernels/bitunpack.py``).  The reference routes
lookups through a one-hot matmul (``kernels/gather.py``) because gathers
are slow on the TPU; on the GPU a lookup is plain indexing.

Layout of bit-packed blocks (BitPacker4x, ``strawboat_tpu/util/bits.py``):
128 values a block as 4 interleaved lanes; lane ``l`` of block word ``k``
is ``words[k*4 + l]``; value ``t`` of a lane takes bits ``[t*b, (t+1)*b)``
of the lane's 32-value stream.  Words and decoded u32 values travel as
``int32`` views of their bits.
"""

from __future__ import annotations

import torch

from ..device import U32_MASK
from .bitunpack import bitunpack_natural

BLOCK_LEN = 128


def dict_gather_device(indices: torch.Tensor, dictionary: torch.Tensor) -> torch.Tensor:
    """``dictionary[indices]`` (indices in range; int32 or int64)."""
    return dictionary[indices.long()]


def bitunpack_natural_device(words: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Uniform-width blocks ``(n_blocks, num_bits*4)`` int32 → flat
    ``(n_blocks*128,)`` int32 values in natural order.  On CUDA this is
    kernel K3's direct variant (``csrc/bitunpack_natural.cu``: a thread
    unpacks one value of all four lanes with 16-byte loads and stores, a
    warp one block); the words must be contiguous and 16-byte aligned."""
    return bitunpack_natural(words, 0, num_bits)


def low32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value (or any int64) → the int32 with its low
    32 bits (the integral conversion wraps)."""
    return (x & U32_MASK).to(torch.int32)


def prefix_sum_u32(deltas: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum mod 2^32 of int32-viewed u32 values, as int64
    in 0 .. 2^32-1 (an int64 cumsum of values below 2^32 cannot overflow
    below 2^31 of them)."""
    return torch.cumsum(deltas.to(torch.int64) & U32_MASK, 0) & U32_MASK


def delta_bitunpack_device(words: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Delta-bitpacked blocks → values: a prefix sum mod 2^32 over the
    whole input (one page).  int32 bits out."""
    deltas = bitunpack_natural_device(words, num_bits)
    return low32(prefix_sum_u32(deltas))


def bitunpack_varwidth_device(
    words: torch.Tensor, widths: torch.Tensor, bmax: int
) -> torch.Tensor:
    """Blocks whose bit width varies per block (the width is data).

    ``words``: ``(n_blocks, bmax*4)`` int32, each block's body zero-padded
    to the group's widest block; ``widths``: ``(n_blocks,)`` integers.
    Returns ``(n_blocks, 128)`` int32.  A later hand kernel (K5) takes this
    place; here each of the 32 value steps gathers its word per block.
    """
    n_blocks = words.shape[0]
    if bmax == 0:
        return torch.zeros((n_blocks, BLOCK_LEN), dtype=torch.int32, device=words.device)
    lanes = words.view(n_blocks, bmax, 4).to(torch.int64) & U32_MASK
    b = widths.to(device=words.device, dtype=torch.int64).view(n_blocks, 1)
    mask = (torch.ones_like(b) << b) - 1  # int64: b == 32 gives 2^32 - 1
    out = torch.empty((n_blocks, 32, 4), dtype=torch.int32, device=words.device)
    for t in range(32):
        s = t * b
        w0 = s >> 5
        sh = s & 31
        lo = torch.gather(lanes, 1, w0.expand(n_blocks, 4).unsqueeze(1))[:, 0]
        w1 = torch.clamp(w0 + 1, max=bmax - 1)
        hi = torch.gather(lanes, 1, w1.expand(n_blocks, 4).unsqueeze(1))[:, 0]
        # when the value fits word w0 (sh + b <= 32), hi lands at bit
        # 32 - sh >= b and the mask drops it: no select needed
        out[:, t] = low32(((lo >> sh) | (hi << (32 - sh))) & mask)
    return out.view(n_blocks, BLOCK_LEN)


def rle_expand_device(counts: torch.Tensor, values: torch.Tensor, total: int) -> torch.Tensor:
    """Expand RLE runs: ``out[i] = values[j]`` where run ``j`` covers ``i``.

    Runs of count 0 cover nothing.  As in the reference, positions past the
    last run repeat the last non-empty run (run 0 if every count is 0), and
    runs past ``total`` are cut."""
    counts = counts.to(torch.int64)
    run_ids = torch.arange(len(counts), device=counts.device)
    ids = torch.repeat_interleave(run_ids, counts)[:total]
    if len(ids) < total:
        nonempty = torch.nonzero(counts > 0)
        last = nonempty[-1] if len(nonempty) else torch.zeros(1, dtype=torch.int64)
        fill = last.to(ids.device).expand(total - len(ids))
        ids = torch.cat([ids, fill])
    return values[ids]


def one_value_device(value: torch.Tensor, total: int) -> torch.Tensor:
    """A ``total``-long column of one value (a 0-d or 1-element tensor)."""
    return value.reshape(1).expand(total).contiguous()


def freq_scatter_device(
    top: torch.Tensor, positions: torch.Tensor, exceptions: torch.Tensor, total: int
) -> torch.Tensor:
    """Fill with the top value, then write the exceptions at their
    positions; out-of-range positions are dropped."""
    out = top.to(device=exceptions.device, dtype=exceptions.dtype).reshape(1).repeat(total)
    keep = (positions >= 0) & (positions < total)
    out[positions[keep].long()] = exceptions[keep]
    return out


def unpack_validity_device(packed: torch.Tensor, total: int) -> torch.Tensor:
    """LSB-first bitmap bytes (uint8) → a bool tensor of ``total``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.view(-1, 1) >> shifts) & 1
    return bits.reshape(-1)[:total].to(torch.bool)

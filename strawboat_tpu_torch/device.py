"""Device parsing and unsigned-word helpers.

torch has no ``>>``, ``<<``, ``+``, ``<`` or ``index_add_`` for
``uint32``/``uint64``, so the port keeps the reference's unsigned words in
signed views: 32-bit plane words travel as ``int32`` and 64-bit payloads as
``int64``.  A logical right shift is an arithmetic shift plus a mask, and
arithmetic ``mod 2^64`` is int64's two's-complement wrap.
"""

from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF


def as_device(device) -> torch.device:
    """``"cuda"``, ``"cuda:0"``, ``"cpu"`` or a ``torch.device`` → device.

    A bare ``"cuda"`` resolves to the current CUDA device index so that two
    spellings of one card compare equal."""
    if device is None:
        raise ValueError("device is required (e.g. 'cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def require_cuda() -> None:
    """Raise unless a CUDA device is usable."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required and none is available")


def u32_to_i32(x: int) -> int:
    """Unsigned 32-bit integer → the int32 with the same bits."""
    x &= U32_MASK
    return x - (1 << 32) if x >= (1 << 31) else x


def u64_to_i64(x: int) -> int:
    """Unsigned 64-bit integer → the int64 with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= (1 << 63) else x


def words_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 word view → int64 holding the unsigned value (0 .. 2^32-1)."""
    return x.to(torch.int64) & U32_MASK


def shr_u32(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32-viewed u32 words (0 <= n < 32)."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (32 - n)) - 1)


SIGN64 = -(1 << 63)  # the int64 with only bit 63 set


def widen_i64(x: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
    """Integer (or bool) values → int64 bits: signed types sign-extend; an
    unsigned 16/32-bit view (``unsigned``) zero-extends; 64-bit values keep
    their bits."""
    if unsigned and x.element_size() < 8:
        return x.to(torch.int64) & ((1 << (8 * x.element_size())) - 1)
    return x.to(torch.int64)

"""Codec-forcing environment flags.

Counterpart of ``strawboat_tpu/util/env.py`` (the reference's
src/util/env.rs:20-83): the same ``STRAWBOAT_*`` variables, set to "1",
force a codec in ``choose_compressor``.
"""

from __future__ import annotations

import os

DICT_ENV = "STRAWBOAT_DICT_COMPRESSION"
RLE_ENV = "STRAWBOAT_RLE_COMPRESSION"
FREQ_ENV = "STRAWBOAT_FREQ_COMPRESSION"
BITPACK_ENV = "STRAWBOAT_BITPACK_COMPRESSION"
PATAS_ENV = "STRAWBOAT_PATAS_COMPRESSION"


def check_env(name: str) -> bool:
    return os.environ.get(name) == "1"


def check_dict_env() -> bool:
    return check_env(DICT_ENV)


def check_rle_env() -> bool:
    return check_env(RLE_ENV)


def check_freq_env() -> bool:
    return check_env(FREQ_ENV)


def check_bitpack_env() -> bool:
    return check_env(BITPACK_ENV)


def check_patas_env() -> bool:
    return check_env(PATAS_ENV)

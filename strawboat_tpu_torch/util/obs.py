"""Codec-choice logging.

Counterpart of ``log_codec_choice`` / ``log_compress_ratio`` in
``strawboat_tpu/util/obs.py`` (the reference's ``log`` statements at its
codec-choice and ratio points, integer/mod.rs:44-47, 65-68, 288-293), on
the ``"strawboat_tpu_torch"`` logger: a handler at INFO sees one record per
page, ``"choose <family> compression : <codec>"`` with the family and the
codec's name as its arguments.
"""

from __future__ import annotations

import logging

log = logging.getLogger("strawboat_tpu_torch")


def log_codec_choice(family: str, codec) -> None:
    if log.isEnabledFor(logging.INFO):
        log.info("choose %s compression : %s", family, getattr(codec, "name", codec))


def log_compress_ratio(family: str, total_bytes: int, compressed: int) -> None:
    if log.isEnabledFor(logging.DEBUG) and compressed:
        log.debug("%s compress ratio %s", family, total_bytes / compressed)

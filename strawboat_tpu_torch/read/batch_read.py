"""Batch reads: every page of a column in one call.

Counterpart of ``strawboat_tpu/read/batch_read.py`` (the reference's
src/read/batch_read.rs, ``batch_read_array``): a flat column decodes every
page and concatenates the values once; a nested column assembles each page
and concatenates the pages' arrays.  The result is ``columns.py``'s model.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import columns as cm
from ..schema import FLAT_FLOAT_TYPES, NULL_TYPE, Field, decimal_params, int_storage
from .deserialize import decode_leaf_values, read_page_column
from .levels import field_inits, leaf_fields, read_validity
from .reader import NativeReader


def batch_read_column(readers: List[NativeReader], field: Field) -> cm.Column:
    """Every page of one column, flat or nested (batch_read.rs:190-209)."""
    if not field.is_nested:
        return _read_simple(readers[0], field)
    inits, leaves = field_inits(field), leaf_fields(field)
    pages = []
    while all(r.has_next() for r in readers):
        pages.append(read_page_column(readers, field, inits, leaves))
    if len(pages) == 1:
        return pages[0]
    import pyarrow as pa

    if not pages:
        return cm.from_arrow(pa.array([], type=cm.pa_type(field)))
    return cm.from_arrow(pa.concat_arrays([cm.to_arrow(c, field) for c in pages]))


def _read_simple(reader: NativeReader, field: Field) -> cm.Column:
    """A flat column: each page's validity (all valid where a page has
    none) and values, concatenated; string offsets rebased page by page."""
    nullable = field.nullable and field.dtype != NULL_TYPE
    validities, parts, total = [], [], 0
    for num_values, buf in reader:
        num_values = int(num_values)
        pos = 0
        if nullable:
            v, pos = read_validity(buf, pos, num_values)
            validities.append(np.ones(num_values, dtype=bool) if v is None else v)
        parts.append(decode_leaf_values(field, buf, pos, num_values)[0])
        total += num_values
    if not parts:
        return _empty_column(field)
    validity = np.concatenate(validities) if validities else None
    first = parts[0]
    if isinstance(first, cm.NullColumn):
        return cm.NullColumn(field.dtype, None, total)
    if isinstance(first, cm.BinaryColumn):
        offsets, base = [first.offsets], int(first.offsets[-1])
        for c in parts[1:]:
            offsets.append(c.offsets[1:] + base)
            base += int(c.offsets[-1])
        return cm.BinaryColumn(field.dtype, validity, np.concatenate(offsets),
                               np.concatenate([c.values for c in parts]))
    kind = type(first)
    return kind(field.dtype, validity, np.concatenate([c.values for c in parts]))


def _empty_column(field: Field) -> cm.Column:
    """A flat column of no pages (batch_read.rs: an empty array)."""
    t = field.dtype
    if t == NULL_TYPE:
        return cm.NullColumn(t, None, 0)
    if field.is_flat_bool:
        return cm.BooleanColumn(t, None, np.empty(0, dtype=bool))
    if field.is_flat_string:
        return cm.BinaryColumn(t, None, np.zeros(1, dtype=np.int64), np.empty(0, np.uint8))
    dec = decimal_params(t)
    if dec is not None:
        return cm.PrimitiveColumn(t, None, np.empty((0, dec[0] // 8), dtype=np.uint8))
    storage = int_storage(t) or FLAT_FLOAT_TYPES[t]
    return cm.PrimitiveColumn(t, None, np.empty(0, dtype=storage))

"""Pages → the host column model, page by page.

Counterpart of ``strawboat_tpu/read/deserialize.py`` (the reference's
src/read/deserialize.rs and the typed page decoders of
src/read/array/*.rs).  A page is its prelude (a flat field's validity, or
a nested leaf's repetition and definition levels, ``read/levels.py``) and
then its leaf codec body, which decodes on the host (``decompress_*`` of
``codecs/``).  A nested column assembles from its leaves' levels: a list
or map level wraps its child in offsets, a struct zips its children
(list.rs / map.rs / struct_.rs).  Columns are ``columns.py``'s model;
``columns.to_arrow`` makes them arrow arrays.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import columns as cm
from ..codecs.binary import decode_binary_page
from ..codecs.boolean import decompress_boolean
from ..codecs.decimal import decompress_decimal
from ..codecs.double import decompress_double
from ..codecs.integer import decompress_integer
from ..errors import NotYetImplementedError
from ..schema import FLAT_FLOAT_TYPES, NULL_TYPE, Field, decimal_params, fixed_size, int_storage
from .levels import (
    InitNested, NestedLevel, field_inits, leaf_fields, read_validity, read_validity_nested,
)
from .reader import NativeReader


def decode_leaf_values(field: Field, buf, pos: int, length: int) -> Tuple[cm.Column, int]:
    """A leaf codec body of ``field``'s type → (a column without validity,
    end position).  A null column has no body."""
    t = field.dtype
    if t == NULL_TYPE:
        return cm.NullColumn(t, None, length), pos
    if field.is_flat_bool:
        values, pos = decompress_boolean(buf, pos, length)
        return cm.BooleanColumn(t, None, values), pos
    if field.is_flat_string:
        offsets, values, pos = decode_binary_page(buf, pos, length, t.startswith("large_"))
        return cm.BinaryColumn(t, None, offsets, values), pos
    dec = decimal_params(t) if field.is_flat_decimal else None
    if dec is not None:
        values, pos = decompress_decimal(buf, pos, length, dec[0] // 8)
        return cm.PrimitiveColumn(t, None, values), pos
    if field.is_flat_float:
        values, pos = decompress_double(buf, pos, length, np.dtype(FLAT_FLOAT_TYPES[t]))
        return cm.PrimitiveColumn(t, None, values), pos
    if field.is_flat_int:
        values, pos = decompress_integer(buf, pos, length, np.dtype(int_storage(t)))
        return cm.PrimitiveColumn(t, None, values), pos
    raise NotYetImplementedError(f"reading column {field.name!r} of type {t}")


def decode_simple_page(field: Field, num_values: int, buf) -> cm.Column:
    """One page of a flat column (array/integer.rs:68-89)."""
    pos, validity = 0, None
    if field.nullable and field.dtype != NULL_TYPE:
        validity, pos = read_validity(buf, pos, num_values)
    col, _ = decode_leaf_values(field, buf, pos, num_values)
    col.validity = validity
    return col


def decode_nested_leaf_page(leaf: Field, init: List[InitNested], num_values: int,
                            buf) -> Tuple[List[NestedLevel], cm.Column]:
    """One page of a nested leaf → (its levels, the leaf's values with
    their validity) (array/integer.rs:158-182)."""
    state, leaf_validity, _rows, pos = read_validity_nested(buf, 0, num_values, init)
    col, _ = decode_leaf_values(leaf, buf, pos, state.levels[-1].length)
    col.validity = leaf_validity
    return state.levels, col


# ---------------------------------------------------------------------------
# nested assembly


def _validity(level: NestedLevel) -> Optional[np.ndarray]:
    if not level.nullable or level.validity is None:
        return None
    return np.asarray(level.validity, dtype=bool)


def _insert_null_slots(child: cm.Column, item: Field, validity: np.ndarray, size: int) -> cm.Column:
    """A fixed-size list's child with ``size`` null slots put back for each
    null row (the writer drops them): valid runs sliced, null runs
    between, concatenated in arrow (a take with null indices would break
    map-typed children)."""
    import pyarrow as pa

    arr = cm.to_arrow(child, item)
    null_run = pa.nulls(size, type=arr.type)
    parts, src, prev = [], 0, 0
    for row in np.flatnonzero(~validity):
        if row > prev:
            parts.append(arr.slice(src, (row - prev) * size))
            src += (row - prev) * size
        parts.append(null_run)
        prev = row + 1
    if len(validity) > prev:
        parts.append(arr.slice(src, (len(validity) - prev) * size))
    return cm.from_arrow(pa.concat_arrays(parts) if len(parts) > 1 else parts[0])


def assemble_column(field: Field, leaves: List[Tuple[List[NestedLevel], cm.Column]],
                    depth: int = 0) -> cm.Column:
    """A field's column from its leaves' (levels, values), level by level
    from ``depth``."""
    t = field.dtype
    if not field.is_nested:
        return leaves[0][1]
    level = leaves[0][0][depth]
    validity = _validity(level)
    if t == "struct":
        children, i = [], 0
        for child in field.children:
            children.append(assemble_column(child, leaves[i : i + child.n_leaves], depth + 1))
            i += child.n_leaves
        return cm.StructColumn(t, validity, children, level.length)
    if t.startswith("map"):
        key, value = field.children[0].children
        n_keys = key.n_leaves
        keys = assemble_column(key, leaves[:n_keys], depth + 2)
        items = assemble_column(value, leaves[n_keys:], depth + 2)
        return cm.MapColumn(t, validity, level.offsets.astype(np.int32), keys, items)
    child = assemble_column(field.children[0], leaves, depth + 1)
    size = fixed_size(t)
    if size is None:
        odt = np.int64 if t == "large_list" else np.int32
        return cm.ListColumn(t, validity, level.offsets.astype(odt), child)
    if validity is not None and not validity.all():
        child = _insert_null_slots(child, field.children[0], validity, size)
    return cm.FixedSizeListColumn(t, validity, size, child, level.length)


# ---------------------------------------------------------------------------
# per-page column iterator (column_iter_to_arrays)


def read_page_column(readers: List[NativeReader], field: Field, inits=None, leaves=None) -> cm.Column:
    """The next page of every leaf reader → one assembled column."""
    if not field.is_nested:
        num_values, buf = next(readers[0])
        return decode_simple_page(field, int(num_values), buf)
    inits = inits if inits is not None else field_inits(field)
    leaves = leaves if leaves is not None else leaf_fields(field)
    pages = []
    for r, init, leaf in zip(readers, inits, leaves):
        num_values, buf = next(r)
        pages.append(decode_nested_leaf_page(leaf, init, int(num_values), buf))
    return assemble_column(field, pages)


def column_iter_to_arrays(readers: List[NativeReader], field: Field) -> Iterator[cm.Column]:
    """One assembled column per page (deserialize.rs:237-253)."""
    inits, leaves = field_inits(field), leaf_fields(field)
    while all(r.has_next() for r in readers):
        yield read_page_column(readers, field, inits, leaves)

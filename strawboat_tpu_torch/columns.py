"""The host column model: numpy buffers with arrow's semantics.

Counterpart of ``strawboat_tpu/columns.py``.  A column is one of
:class:`PrimitiveColumn` (integers, temporal types as their int storage,
floats, decimals as unscaled int64 or an ``(n, W)`` uint8 matrix),
:class:`BooleanColumn`, :class:`BinaryColumn` (int64 offsets into a uint8
buffer), :class:`NullColumn`, :class:`ListColumn` (int32 or int64 offsets),
:class:`FixedSizeListColumn`, :class:`MapColumn` and :class:`StructColumn`.
``dtype`` is the arrow alias of ``schema.Field`` (``"int64"``,
``"timestamp[us]"``, ``"list"``, ``"struct"`` …) and ``validity`` a numpy
bool array (True = valid) or None.  A nested column is written under a
nested ``Field`` that names its children (``write.write_file``).

pyarrow is imported only by :func:`to_arrow`, :func:`from_arrow` and the
type conversions beside them, for tests and the ``pa.Table`` front of
``make_resident``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .errors import NotYetImplementedError
from .schema import Field, decimal_params, fixed_size, int_storage

__all__ = [
    "Column", "NullColumn", "PrimitiveColumn", "BooleanColumn", "BinaryColumn",
    "ListColumn", "FixedSizeListColumn", "StructColumn", "MapColumn",
    "to_arrow", "from_arrow", "arrow_type", "pa_type", "field_from_arrow",
]


@dataclass
class Column:
    dtype: str
    validity: Optional[np.ndarray]  # bool, True = valid; None = all valid

    def _validity(self, sel) -> Optional[np.ndarray]:
        return None if self.validity is None else self.validity[sel]


@dataclass
class NullColumn(Column):
    length: int = 0

    def __len__(self) -> int:
        return self.length

    def slice(self, offset: int, length: int) -> "NullColumn":
        return NullColumn(self.dtype, None, length)

    def take(self, idx: np.ndarray) -> "NullColumn":
        return NullColumn(self.dtype, None, len(idx))


@dataclass
class PrimitiveColumn(Column):
    values: np.ndarray = field(default_factory=lambda: np.empty(0))

    def __len__(self) -> int:
        return len(self.values)

    def slice(self, offset: int, length: int) -> "PrimitiveColumn":
        sel = slice(offset, offset + length)
        return PrimitiveColumn(self.dtype, self._validity(sel), self.values[sel])

    def take(self, idx: np.ndarray) -> "PrimitiveColumn":
        return PrimitiveColumn(self.dtype, self._validity(idx), self.values[idx])


@dataclass
class BooleanColumn(Column):
    values: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=bool))

    def __len__(self) -> int:
        return len(self.values)

    def slice(self, offset: int, length: int) -> "BooleanColumn":
        sel = slice(offset, offset + length)
        return BooleanColumn(self.dtype, self._validity(sel), self.values[sel])

    def take(self, idx: np.ndarray) -> "BooleanColumn":
        return BooleanColumn(self.dtype, self._validity(idx), self.values[idx])


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenated index ranges [starts[i], starts[i] + lens[i])."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    first = np.repeat(np.asarray(starts, dtype=np.int64) - np.cumsum(lens) + lens, lens)
    return first + np.arange(total, dtype=np.int64)


@dataclass
class BinaryColumn(Column):
    """utf8 / binary: slice ``i`` is ``values[offsets[i]:offsets[i + 1]]``."""

    offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, dtype=np.int64))
    values: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.uint8))

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def slice(self, offset: int, length: int) -> "BinaryColumn":
        return BinaryColumn(self.dtype, self._validity(slice(offset, offset + length)),
                            self.offsets[offset : offset + length + 1], self.values)

    def take(self, idx: np.ndarray) -> "BinaryColumn":
        starts, lens = self.offsets[idx], self.offsets[idx + 1] - self.offsets[idx]
        offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        return BinaryColumn(self.dtype, self._validity(idx), offsets,
                            self.values[_ranges(starts, lens)])


@dataclass
class ListColumn(Column):
    """list / large_list: row ``i`` is ``child[offsets[i]:offsets[i + 1]]``."""

    offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, dtype=np.int32))
    child: Optional[Column] = None

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def slice(self, offset: int, length: int) -> "ListColumn":
        return ListColumn(self.dtype, self._validity(slice(offset, offset + length)),
                          self.offsets[offset : offset + length + 1], self.child)

    def take(self, idx: np.ndarray) -> "ListColumn":
        starts = self.offsets[idx].astype(np.int64)
        lens = self.offsets[idx + 1].astype(np.int64) - starts
        offsets = np.zeros(len(idx) + 1, dtype=self.offsets.dtype)
        np.cumsum(lens, out=offsets[1:])
        return ListColumn(self.dtype, self._validity(idx), offsets,
                          self.child.take(_ranges(starts, lens)))


@dataclass
class FixedSizeListColumn(Column):
    size: int = 0
    child: Optional[Column] = None
    length: int = 0

    def __len__(self) -> int:
        return self.length

    def slice(self, offset: int, length: int) -> "FixedSizeListColumn":
        return FixedSizeListColumn(
            self.dtype, self._validity(slice(offset, offset + length)), self.size,
            self.child.slice(offset * self.size, length * self.size), length)

    def take(self, idx: np.ndarray) -> "FixedSizeListColumn":
        slots = _ranges(np.asarray(idx, np.int64) * self.size, np.full(len(idx), self.size))
        return FixedSizeListColumn(self.dtype, self._validity(idx), self.size,
                                   self.child.take(slots), len(idx))


@dataclass
class StructColumn(Column):
    children: List[Column] = field(default_factory=list)
    length: int = 0

    def __len__(self) -> int:
        return self.length

    def slice(self, offset: int, length: int) -> "StructColumn":
        return StructColumn(self.dtype, self._validity(slice(offset, offset + length)),
                            [c.slice(offset, length) for c in self.children], length)

    def take(self, idx: np.ndarray) -> "StructColumn":
        return StructColumn(self.dtype, self._validity(idx),
                            [c.take(idx) for c in self.children], len(idx))


@dataclass
class MapColumn(Column):
    """map: row ``i`` is the entries ``[offsets[i], offsets[i + 1])`` of
    ``keys`` and ``items``."""

    offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, dtype=np.int32))
    keys: Optional[Column] = None
    items: Optional[Column] = None

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def slice(self, offset: int, length: int) -> "MapColumn":
        return MapColumn(self.dtype, self._validity(slice(offset, offset + length)),
                         self.offsets[offset : offset + length + 1], self.keys, self.items)

    def take(self, idx: np.ndarray) -> "MapColumn":
        starts = self.offsets[idx].astype(np.int64)
        lens = self.offsets[idx + 1].astype(np.int64) - starts
        offsets = np.zeros(len(idx) + 1, dtype=self.offsets.dtype)
        np.cumsum(lens, out=offsets[1:])
        slots = _ranges(starts, lens)
        return MapColumn(self.dtype, self._validity(idx), offsets,
                         self.keys.take(slots), self.items.take(slots))


# ---------------------------------------------------------------------------
# arrow interop (lazy pyarrow)

_PA_NAMES = {"double": "float64", "float": "float32", "halffloat": "float16",
             "date32[day]": "date32", "date64[ms]": "date64"}
_UNIT_NAMES = {"s": "s", "ms": "ms", "us": "us", "ns": "ns"}


def arrow_type(t):
    """A flat alias string → ``pa.DataType`` (a ``pa.DataType`` and None
    stay as they are)."""
    import pyarrow as pa

    if not isinstance(t, str):
        return t
    dec = decimal_params(t)
    if dec is not None:
        return (pa.decimal128 if dec[0] == 128 else pa.decimal256)(dec[1], dec[2])
    if t.startswith("timestamp[") and ", tz=" in t:
        unit, tz = t[len("timestamp[") : -1].split(", tz=")
        return pa.timestamp(unit, tz=tz)
    return pa.type_for_alias(t)


def pa_type(f: Field):
    """A port ``Field`` → its ``pa.DataType``."""
    import pyarrow as pa

    if f.dtype in ("list", "large_list"):
        make = pa.list_ if f.dtype == "list" else pa.large_list
        return make(pa_field(f.children[0]))
    if fixed_size(f.dtype) is not None:
        return pa.list_(pa_field(f.children[0]), fixed_size(f.dtype))
    if f.dtype.startswith("map"):
        key, value = f.children[0].children
        return pa.map_(pa_field(key), pa_field(value), keys_sorted=f.dtype == "map[keys_sorted]")
    if f.dtype == "struct":
        return pa.struct([pa_field(c) for c in f.children])
    return arrow_type(f.dtype)


def pa_field(f: Field):
    import pyarrow as pa

    return pa.field(f.name, pa_type(f), nullable=f.nullable)


def _alias(t) -> str:
    import pyarrow as pa

    if pa.types.is_fixed_size_list(t):
        return f"fixed_size_list[{t.list_size}]"
    if pa.types.is_map(t):
        return "map[keys_sorted]" if t.keys_sorted else "map"
    for name, pred in (("list", pa.types.is_list), ("large_list", pa.types.is_large_list),
                       ("struct", pa.types.is_struct)):
        if pred(t):
            return name
    s = str(t)
    return _PA_NAMES.get(s, s)


def field_from_arrow(f) -> Field:
    """A ``pa.Field`` → the port's ``Field``."""
    import pyarrow as pa

    t = f.type
    if pa.types.is_map(t):
        entries = Field("entries", "struct", False,
                        (field_from_arrow(t.key_field), field_from_arrow(t.item_field)))
        children = (entries,)
    elif pa.types.is_struct(t):
        children = tuple(field_from_arrow(t.field(i)) for i in range(t.num_fields))
    elif pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_fixed_size_list(t):
        children = (field_from_arrow(t.value_field),)
    else:
        children = ()
    return Field(f.name, _alias(t), bool(f.nullable), children)


def _bitmap(validity):
    import pyarrow as pa

    return None if validity is None else pa.py_buffer(np.packbits(validity, bitorder="little"))


def _values_from(arr, itemsize: int) -> np.ndarray:
    raw = np.frombuffer(arr.buffers()[1], dtype=np.uint8) if arr.buffers()[1] is not None \
        else np.zeros(0, np.uint8)
    out = raw[arr.offset * itemsize : (arr.offset + len(arr)) * itemsize]
    if len(out) < len(arr) * itemsize:  # an all-null array may carry no values
        out = np.zeros(len(arr) * itemsize, np.uint8)
    return out


def _arrow_validity(arr) -> Optional[np.ndarray]:
    if arr.null_count == 0:
        return None
    return ~np.asarray(arr.is_null())


def from_arrow(arr) -> Column:
    """A (possibly sliced) ``pa.Array`` → the column model; offsets start
    at 0."""
    import pyarrow as pa

    t = arr.type
    dtype = _alias(t)
    validity = _arrow_validity(arr)
    if pa.types.is_null(t):
        return NullColumn("null", None, len(arr))
    if pa.types.is_boolean(t):
        bits = np.unpackbits(np.frombuffer(arr.buffers()[1], np.uint8), bitorder="little")
        return BooleanColumn(dtype, validity, bits[arr.offset : arr.offset + len(arr)].astype(bool))
    if pa.types.is_string(t) or pa.types.is_binary(t) or pa.types.is_large_string(t) \
            or pa.types.is_large_binary(t):
        large = pa.types.is_large_string(t) or pa.types.is_large_binary(t)
        offs = np.frombuffer(arr.buffers()[1], np.int64 if large else np.int32)[
            arr.offset : arr.offset + len(arr) + 1].astype(np.int64)
        data = arr.buffers()[2]
        vals = np.frombuffer(data, np.uint8) if data is not None else np.zeros(0, np.uint8)
        return BinaryColumn(dtype, validity, offs - offs[0], vals[offs[0] : offs[-1]])
    if pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_map(t):
        odt = np.int64 if pa.types.is_large_list(t) else np.int32
        offs = np.frombuffer(arr.buffers()[1], odt)[arr.offset : arr.offset + len(arr) + 1]
        base, end = int(offs[0]), int(offs[-1])
        offs = (offs - base).astype(odt)
        if pa.types.is_map(t):
            return MapColumn(dtype, validity, offs, from_arrow(arr.keys.slice(base, end - base)),
                             from_arrow(arr.items.slice(base, end - base)))
        return ListColumn(dtype, validity, offs, from_arrow(arr.values.slice(base, end - base)))
    if pa.types.is_fixed_size_list(t):
        size = t.list_size
        child = from_arrow(arr.values.slice(arr.offset * size, len(arr) * size))
        return FixedSizeListColumn(dtype, validity, size, child, len(arr))
    if pa.types.is_struct(t):
        children = [from_arrow(arr.field(i)) for i in range(t.num_fields)]
        return StructColumn(dtype, validity, children, len(arr))
    if pa.types.is_decimal(t):
        width = t.bit_width // 8
        return PrimitiveColumn(dtype, validity, _values_from(arr, width).reshape(len(arr), width))
    storage = int_storage(dtype)
    npdt = np.dtype(storage if storage is not None else t.to_pandas_dtype())
    return PrimitiveColumn(dtype, validity, _values_from(arr, npdt.itemsize).view(npdt))


def to_arrow(col: Column, f: Field):
    """The column model → a ``pa.Array`` of ``f``'s type."""
    import pyarrow as pa

    t = pa_type(f)
    n = len(col)
    bm = _bitmap(col.validity)
    if isinstance(col, NullColumn):
        return pa.nulls(n)
    if isinstance(col, BooleanColumn):
        return pa.Array.from_buffers(t, n, [bm, _bitmap(col.values)])
    if isinstance(col, BinaryColumn):
        large = f.dtype.startswith("large_")
        offs = col.offsets.astype(np.int64 if large else np.int32)
        return pa.Array.from_buffers(t, n, [bm, pa.py_buffer(offs - offs[0]),
                                            pa.py_buffer(col.values[col.offsets[0]:].tobytes())])
    if isinstance(col, PrimitiveColumn):
        vals = col.values
        dec = decimal_params(f.dtype)
        if dec is not None and vals.ndim == 1:
            from .codecs.decimal import from_int64

            vals = from_int64(vals.astype(np.int64), dec[0] // 8)
        return pa.Array.from_buffers(t, n, [bm, pa.py_buffer(np.ascontiguousarray(vals).tobytes())])
    if isinstance(col, (ListColumn, MapColumn)):
        offs = col.offsets
        base, end = int(offs[0]), int(offs[-1])
        offs = (offs - base).astype(np.int64 if f.dtype == "large_list" else np.int32)
        if isinstance(col, MapColumn):
            key_f, value_f = f.children[0].children
            entries = pa.StructArray.from_arrays(
                [to_arrow(col.keys.slice(base, end - base), key_f),
                 to_arrow(col.items.slice(base, end - base), value_f)],
                fields=[pa_field(key_f), pa_field(value_f)])
            return pa.Array.from_buffers(t, n, [bm, pa.py_buffer(offs)], children=[entries])
        child = to_arrow(col.child.slice(base, end - base), f.children[0])
        return pa.Array.from_buffers(t, n, [bm, pa.py_buffer(offs)], children=[child])
    if isinstance(col, FixedSizeListColumn):
        return pa.Array.from_buffers(t, n, [bm], children=[to_arrow(col.child, f.children[0])])
    if isinstance(col, StructColumn):
        return pa.Array.from_buffers(
            t, n, [bm], children=[to_arrow(c, cf) for c, cf in zip(col.children, f.children)])
    raise NotYetImplementedError(f"to_arrow of {type(col).__name__}")

"""Arrow IPC schema bytes without pyarrow.

Counterpart of ``strawboat_tpu/schema.py``, which serializes a
``pa.Schema``.  A file's schema is the bare flatbuffers ``Message`` whose
header is a ``Schema`` (Arrow's ``Message.fbs`` / ``Schema.fbs``), the form
arrow2 writes; :func:`deserialize_schema` also takes the
continuation-prefixed form pyarrow emits.

A field is ``Field(name, dtype, nullable, children)``, with ``dtype`` the
arrow alias string ``DeviceColumn.dtype`` uses (``"int64"``, ``"date32"``,
``"string"``, ``"float64"``, ``"bool"``, ``"decimal128(15, 2)"``, the
temporal aliases ``"timestamp[us]"``, ``"timestamp[ms, tz=UTC]"``,
``"date64"``, ``"time32[ms]"``, ``"time64[ns]"``, ``"duration[s]"``).  A
nested field is ``"list"``, ``"large_list"``, ``"fixed_size_list[N]"``,
``"map"`` (``"map[keys_sorted]"``) or ``"struct"`` over its children,
named as pyarrow names them: a list's child ``item``, a map's child the
non-nullable struct ``entries`` of a non-nullable ``key`` and a ``value``
(:func:`list_of`, :func:`map_of`).  Every type parses;
:func:`schema_to_bytes` writes these types with the bytes pyarrow writes
for the same fields.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .constants import CONTINUATION_MARKER
from .errors import NotYetImplementedError, OutOfSpecError

# alias → numpy storage dtype of the flat integer types the port reads and
# writes (date32 stores days since the epoch as int32; the other temporal
# types are their int32 / int64 counts of their unit, as arrow stores them)
_UNITS = ("s", "ms", "us", "ns")
FLAT_INT_TYPES = {
    "int8": "<i1", "int16": "<i2", "int32": "<i4", "int64": "<i8",
    "uint8": "<u1", "uint16": "<u2", "uint32": "<u4", "uint64": "<u8",
    "date32": "<i4", "date64": "<i8",
    **{f"timestamp[{u}]": "<i8" for u in _UNITS},
    "time32[s]": "<i4", "time32[ms]": "<i4", "time64[us]": "<i8", "time64[ns]": "<i8",
    **{f"duration[{u}]": "<i8" for u in _UNITS},
}
_TIMESTAMP = re.compile(r"^timestamp\[(s|ms|us|ns)(?:, tz=(.+))?\]$")
# utf8 and binary, with 32- or 64-bit offsets: the arrow aliases
STRING_TYPES = ("string", "binary", "large_string", "large_binary")
# alias → numpy dtype of the flat float types
FLAT_FLOAT_TYPES = {"float16": "<f2", "float32": "<f4", "float64": "<f8"}
BOOL_TYPE = "bool"
NULL_TYPE = "null"  # a column of nulls only: no values, empty pages
# the exact types writable by name; a decimal is writable at any
# precision and scale (:func:`decimal_params`)
WRITABLE_TYPES = (*FLAT_INT_TYPES, *STRING_TYPES, *FLAT_FLOAT_TYPES, BOOL_TYPE, NULL_TYPE)

_DECIMAL = re.compile(r"^decimal(128|256)\((\d+), (-?\d+)\)$")
NESTED_TYPES = ("list", "large_list", "map", "struct")  # and fixed_size_list[N]
_FIXED_SIZE_LIST = re.compile(r"^fixed_size_list\[(\d+)\]$")


def int_storage(dtype) -> Optional[str]:
    """The numpy storage dtype of a flat integer or temporal alias
    (a timestamp with any time zone included), else None."""
    dtype = str(dtype)
    got = FLAT_INT_TYPES.get(dtype)
    if got is None and _TIMESTAMP.match(dtype):
        return "<i8"
    return got


def fixed_size(dtype) -> Optional[int]:
    """The list size of a ``"fixed_size_list[N]"`` alias, else None."""
    m = _FIXED_SIZE_LIST.match(str(dtype))
    return None if m is None else int(m.group(1))


def is_nested_type(dtype) -> bool:
    return dtype in NESTED_TYPES or dtype == "map[keys_sorted]" or fixed_size(dtype) is not None


def decimal_params(dtype) -> Optional[Tuple[int, int, int]]:
    """(bit width, precision, scale) of a decimal alias such as
    ``"decimal128(15, 2)"`` (pyarrow's spelling), else None."""
    m = _DECIMAL.match(str(dtype))
    return None if m is None else (int(m.group(1)), int(m.group(2)), int(m.group(3)))


def decimal_alias(bit_width: int, precision: int, scale: int) -> str:
    return f"decimal{bit_width}({precision}, {scale})"

_METADATA_V5 = 4  # MetadataVersion.V5
_HEADER_SCHEMA = 1  # MessageHeader.Schema
# Type union ids (Schema.fbs) of the types read in detail; the rest by name
# (enough to refuse them and to count their leaves)
_T_INT, _T_FLOAT, _T_BOOL, _T_DECIMAL, _T_DATE = 2, 3, 6, 7, 8
_T_TIME, _T_TIMESTAMP, _T_LIST, _T_STRUCT, _T_FSL, _T_MAP, _T_DURATION, _T_LARGE_LIST = (
    9, 10, 12, 13, 16, 17, 18, 21)
_PRECISIONS = ("float16", "float32", "float64")  # FloatingPoint.precision
_TYPE_NAMES = {
    1: "null", 4: "binary", 5: "string", 6: "bool",
    9: "time", 10: "timestamp", 11: "interval", 12: "list", 13: "struct",
    14: "union", 15: "fixed_size_binary", 16: "fixed_size_list", 17: "map",
    18: "duration", 19: "large_binary", 20: "large_string", 21: "large_list",
    22: "run_end_encoded", 23: "binary_view", 24: "string_view",
    25: "list_view", 26: "large_list_view",
}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str
    nullable: bool = True
    children: Tuple["Field", ...] = ()
    dictionary_encoded: bool = False

    @property
    def is_flat_int(self) -> bool:
        return (
            int_storage(self.dtype) is not None
            and not self.children
            and not self.dictionary_encoded
        )

    @property
    def is_flat_string(self) -> bool:
        return (
            self.dtype in STRING_TYPES
            and not self.children
            and not self.dictionary_encoded
        )

    @property
    def is_flat_float(self) -> bool:
        return (
            self.dtype in FLAT_FLOAT_TYPES
            and not self.children
            and not self.dictionary_encoded
        )

    @property
    def is_flat_bool(self) -> bool:
        return self.dtype == BOOL_TYPE and not self.children and not self.dictionary_encoded

    @property
    def is_flat_decimal(self) -> bool:
        return (
            decimal_params(self.dtype) is not None
            and not self.children
            and not self.dictionary_encoded
        )

    @property
    def is_nested(self) -> bool:
        return is_nested_type(self.dtype)

    @property
    def n_leaves(self) -> int:
        """Leaf columns the field decomposes into (arrow2 ``n_columns``):
        a struct sums its children, a list or map counts its child's."""
        if not self.children:
            return 1
        return sum(c.n_leaves for c in self.children)


# ---------------------------------------------------------------------------
# reading


class _Reader:
    """Bounds-checked reads of a flatbuffer."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def _unpack(self, fmt: str, pos: int):
        try:
            return struct.unpack_from(fmt, self.buf, pos)[0]
        except struct.error as e:
            raise OutOfSpecError(f"invalid schema bytes: read past the end ({e})") from e

    def slot(self, table: int, i: int) -> int:
        """Offset of field ``i`` inside ``table`` (0 when absent)."""
        vtable = table - self._unpack("<i", table)
        vt_size = self._unpack("<H", vtable)
        if 4 + 2 * i >= vt_size:
            return 0
        return self._unpack("<H", vtable + 4 + 2 * i)

    def scalar(self, table: int, i: int, fmt: str, default):
        off = self.slot(table, i)
        return self._unpack(fmt, table + off) if off else default

    def ref(self, table: int, i: int) -> Optional[int]:
        """Position of the table, vector or string field ``i`` points at."""
        off = self.slot(table, i)
        if not off:
            return None
        pos = table + off
        return pos + self._unpack("<I", pos)

    def tables(self, vec: Optional[int]) -> List[int]:
        if vec is None:
            return []
        n = self._unpack("<I", vec)
        return [vec + 4 + 4 * j + self._unpack("<I", vec + 4 + 4 * j) for j in range(n)]

    def string(self, pos: Optional[int]) -> str:
        if pos is None:
            return ""
        n = self._unpack("<I", pos)
        if pos + 4 + n > len(self.buf):
            raise OutOfSpecError("invalid schema bytes: string past the end")
        return bytes(self.buf[pos + 4 : pos + 4 + n]).decode("utf-8")


def _type_alias(r: _Reader, type_id: int, t: Optional[int]) -> str:
    if type_id == _T_INT and t is not None:
        width = r.scalar(t, 0, "<i", 0)
        signed = r.scalar(t, 1, "<B", 0)
        return f"{'' if signed else 'u'}int{width}"
    if type_id == _T_DATE:
        unit = r.scalar(t, 0, "<h", 1) if t is not None else 1  # default ms
        return "date32" if unit == 0 else "date64"
    if type_id == _T_FLOAT:
        precision = r.scalar(t, 0, "<h", 0) if t is not None else 0  # default HALF
        if not 0 <= precision < len(_PRECISIONS):
            raise OutOfSpecError(f"invalid schema bytes: float precision {precision}")
        return _PRECISIONS[precision]
    if type_id == _T_DECIMAL:
        if t is None:
            raise OutOfSpecError("invalid schema bytes: a decimal without its type table")
        return decimal_alias(r.scalar(t, 2, "<i", 128), r.scalar(t, 0, "<i", 0),
                             r.scalar(t, 1, "<i", 0))
    if type_id in (_T_TIME, _T_TIMESTAMP, _T_DURATION):
        default = 0 if type_id == _T_TIMESTAMP else 1  # SECOND, else MILLISECOND
        unit = r.scalar(t, 0, "<h", default) if t is not None else default
        if not 0 <= unit < len(_UNITS):
            raise OutOfSpecError(f"invalid schema bytes: time unit {unit}")
        if type_id == _T_TIMESTAMP:
            tz = r.string(r.ref(t, 1)) if t is not None else ""
            return f"timestamp[{_UNITS[unit]}{', tz=' + tz if tz else ''}]"
        if type_id == _T_DURATION:
            return f"duration[{_UNITS[unit]}]"
        width = r.scalar(t, 1, "<i", 32) if t is not None else 32
        return f"time{width}[{_UNITS[unit]}]"
    if type_id == _T_FSL:
        return f"fixed_size_list[{r.scalar(t, 0, '<i', 0) if t is not None else 0}]"
    if type_id == _T_MAP and t is not None and r.scalar(t, 0, "<B", 0):
        return "map[keys_sorted]"
    return _TYPE_NAMES.get(type_id, f"type{type_id}")


def _read_field(r: _Reader, f: int, depth: int = 0) -> Field:
    if depth > 64:
        raise OutOfSpecError("invalid schema bytes: fields nested too deep")
    type_id = r.scalar(f, 2, "<B", 0)
    children = tuple(_read_field(r, c, depth + 1) for c in r.tables(r.ref(f, 5)))
    return Field(
        name=r.string(r.ref(f, 0)),
        dtype=_type_alias(r, type_id, r.ref(f, 3)),
        nullable=bool(r.scalar(f, 1, "<B", 0)),
        children=children,
        dictionary_encoded=r.ref(f, 4) is not None,
    )


def deserialize_schema(buf: bytes) -> List[Field]:
    """Schema bytes, bare (arrow2) or continuation-prefixed (pyarrow's
    stream form) → the list of top-level fields."""
    buf = bytes(buf)
    if buf[:4] == CONTINUATION_MARKER:
        buf = buf[8:]
    r = _Reader(buf)
    msg = r._unpack("<I", 0)
    version = r.scalar(msg, 0, "<h", 0)
    if version < 3:  # V4 and V5 describe the same schema layout
        raise OutOfSpecError(f"invalid schema bytes: metadata version {version}")
    if r.scalar(msg, 1, "<B", 0) != _HEADER_SCHEMA:
        raise OutOfSpecError("invalid schema bytes: the message is not a schema")
    schema = r.ref(msg, 2)
    if schema is None:
        raise OutOfSpecError("invalid schema bytes: no schema header")
    if r.scalar(schema, 0, "<h", 0) != 0:
        raise NotYetImplementedError("big-endian schemas")
    return [_read_field(r, f) for f in r.tables(r.ref(schema, 1))]


# ---------------------------------------------------------------------------
# writing


class _Builder:
    """A flatbuffers builder as the C++ library lays buffers out: back to
    front, every scalar at its natural alignment, a table's vtable right
    in front of it and shared with an equal earlier one, defaults left
    out.  With objects created in Arrow C++'s order, the bytes equal
    pyarrow's ``Schema.serialize``."""

    def __init__(self):
        self.data = bytearray()  # the buffer's tail; objects are prepended
        self.minalign = 1
        self.vtables: List[int] = []

    def _size(self) -> int:
        return len(self.data)

    def _prepend(self, b: bytes) -> None:
        self.data[0:0] = b

    def _prealign(self, n: int, align: int) -> None:
        """Pad so that the buffer is ``align``-aligned after ``n`` more bytes."""
        if n:
            self.minalign = max(self.minalign, align)
            self._prepend(b"\0" * ((-(self._size() + n)) % align))

    def _push(self, fmt: str, value) -> int:
        self._prealign(struct.calcsize(fmt), struct.calcsize(fmt))
        self._prepend(struct.pack(fmt, value))
        return self._size()

    def _refer(self, off: int) -> int:
        self._prealign(4, 4)
        return self._size() - off + 4

    def string(self, s: str) -> int:
        b = s.encode("utf-8")
        self._prealign(len(b) + 1, 4)
        self._prepend(b + b"\0")
        return self._push("<I", len(b))

    def vector(self, offsets: Sequence[int]) -> int:
        self._prealign(4 * len(offsets), 4)
        for off in reversed(offsets):
            self._push("<I", self._refer(off))
        return self._push("<I", len(offsets))

    def table(self, fields) -> int:
        """``fields`` in the order flatc's ``Create*`` adds them (widest
        first, later ids first): (id, struct format, value, default) for
        scalars, (id, None, object offset, None) for references."""
        start = self._size()
        locs = []
        for fid, fmt, value, default in fields:
            if fmt is None:
                loc = self._push("<I", self._refer(value))
            elif value == default:
                continue
            else:
                loc = self._push(fmt, value)
            locs.append((loc, 4 + 2 * fid))
        table = self._push("<i", 0)
        vt = bytearray(max((v for _l, v in locs), default=2) + 2)
        struct.pack_into("<HH", vt, 0, len(vt), table - start)
        for loc, voff in locs:
            struct.pack_into("<H", vt, voff, table - loc)
        use = next((off for off in self.vtables
                    if self.data[self._size() - off : self._size() - off + len(vt)] == vt), None)
        if use is None:
            self._prepend(bytes(vt))
            use = self._size()
            self.vtables.append(use)
        struct.pack_into("<i", self.data, self._size() - table, use - table)
        return table

    def finish(self, root: int) -> bytes:
        self._prealign(4, self.minalign)
        self._push("<I", self._refer(root))
        return bytes(self.data)


# alias → Type union id of the types without a type table payload
_EMPTY_TYPE_IDS = {"null": 1, "binary": 4, "string": 5, "large_binary": 19, "large_string": 20,
                   "list": _T_LIST, "large_list": _T_LARGE_LIST, "struct": _T_STRUCT}


def list_of(name: str, item: Field, large: bool = False, nullable: bool = True) -> Field:
    """A list field of ``item`` (pyarrow's child name is ``item``)."""
    return Field(name, "large_list" if large else "list", nullable, (item,))


def map_of(name: str, key: str, value: Field, nullable: bool = True,
           keys_sorted: bool = False) -> Field:
    """A map field: the non-nullable ``entries`` struct of a non-nullable
    ``key`` of type ``key`` and ``value`` (renamed ``value``)."""
    entries = Field("entries", "struct", False,
                    (Field("key", key, False), Field("value", value.dtype, value.nullable,
                                                     value.children)))
    return Field(name, "map[keys_sorted]" if keys_sorted else "map", nullable, (entries,))


def _writable(f: Field) -> bool:
    if f.dictionary_encoded:
        return False
    if f.is_nested:
        n = len(f.children)
        if f.dtype.startswith("map"):
            e = f.children[0] if n == 1 else None
            return (e is not None and e.dtype == "struct" and not e.nullable
                    and len(e.children) == 2 and not e.children[0].nullable)
        return n >= 1 if f.dtype == "struct" else n == 1
    return not f.children and (f.dtype in WRITABLE_TYPES or int_storage(f.dtype) is not None
                               or decimal_params(f.dtype) is not None)


def _type_table(b: _Builder, f: Field) -> Tuple[int, int]:
    """(Type union id, offset of the type table) of a writable field."""
    if f.dtype in _EMPTY_TYPE_IDS:
        return _EMPTY_TYPE_IDS[f.dtype], b.table([])
    if f.dtype == "date32":
        return _T_DATE, b.table([(0, "<h", 0, 1)])  # unit DAY (default MILLISECOND)
    if f.dtype == "date64":
        return _T_DATE, b.table([(0, "<h", 1, 1)])
    ts = _TIMESTAMP.match(f.dtype)
    if ts is not None:  # timezone (a string made first), unit (default SECOND)
        fields = [(0, "<h", _UNITS.index(ts.group(1)), 0)]
        if ts.group(2):
            fields.insert(0, (1, None, b.string(ts.group(2)), None))
        return _T_TIMESTAMP, b.table(fields)
    if f.dtype.startswith(("time32[", "time64[")):  # bitWidth (default 32), unit (default ms)
        unit = _UNITS.index(f.dtype[7:-1])
        return _T_TIME, b.table([(1, "<i", int(f.dtype[4:6]), 32), (0, "<h", unit, 1)])
    if f.dtype.startswith("duration["):
        return _T_DURATION, b.table([(0, "<h", _UNITS.index(f.dtype[9:-1]), 1)])
    size = fixed_size(f.dtype)
    if size is not None:  # listSize
        return _T_FSL, b.table([(0, "<i", size, 0)])
    if f.dtype.startswith("map"):  # keysSorted (default false)
        return _T_MAP, b.table([(0, "<B", int(f.dtype == "map[keys_sorted]"), 0)])
    if f.dtype in FLAT_FLOAT_TYPES:  # precision (default HALF)
        return _T_FLOAT, b.table([(0, "<h", _PRECISIONS.index(f.dtype), 0)])
    if f.dtype == BOOL_TYPE:
        return _T_BOOL, b.table([])
    dec = decimal_params(f.dtype)
    if dec is not None:  # bitWidth (default 128), scale, precision
        bit_width, precision, scale = dec
        return _T_DECIMAL, b.table([(2, "<i", bit_width, 128), (1, "<i", scale, 0),
                                    (0, "<i", precision, 0)])
    signed = not f.dtype.startswith("u")
    width = int(f.dtype.split("int")[1])
    return _T_INT, b.table([(0, "<i", width, 0), (1, "<B", int(signed), 0)])


def _field(b: _Builder, f: Field, depth: int = 0) -> int:
    if depth > 64 or not _writable(f):
        raise NotYetImplementedError(f"writing column {f.name!r} of type {f.dtype}")
    # Arrow C++ creates the children's fields, the type table, the name,
    # the children vector, then the field
    kids = [_field(b, c, depth + 1) for c in f.children]
    type_id, type_table = _type_table(b, f)
    name = b.string(f.name)
    children = b.vector(kids)
    return b.table([
        (5, None, children, None), (3, None, type_table, None), (0, None, name, None),
        (2, "<B", type_id, 0), (1, "<B", int(f.nullable), 0),
    ])


def schema_to_bytes(fields: Sequence[Field]) -> bytes:
    """Fields → the bare flatbuffers ``Message`` (MetadataVersion V5),
    zero-padded to a multiple of 8 bytes: pyarrow's bytes for the same
    schema.  Writes :data:`WRITABLE_TYPES`, decimals, the temporal types
    and the nested types over them."""
    b = _Builder()
    offsets = [_field(b, f) for f in fields]
    schema = b.table([(1, None, b.vector(offsets), None)])
    message = b.table([(2, None, schema, None), (0, "<h", _METADATA_V5, 0),
                       (1, "<B", _HEADER_SCHEMA, 0)])
    out = b.finish(message)
    return out + b"\0" * (-len(out) % 8)

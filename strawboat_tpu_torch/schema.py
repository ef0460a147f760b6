"""Arrow IPC schema bytes without pyarrow, for flat fields.

Counterpart of ``strawboat_tpu/schema.py``, which serializes a
``pa.Schema``.  A file's schema is the bare flatbuffers ``Message`` whose
header is a ``Schema`` (Arrow's ``Message.fbs`` / ``Schema.fbs``), the form
arrow2 writes; :func:`deserialize_schema` also takes the
continuation-prefixed form pyarrow emits.

A field is ``Field(name, dtype, nullable)``, with ``dtype`` the arrow alias
string ``DeviceColumn.dtype`` uses (``"int64"``, ``"date32"``).  Every type
parses, so a file with string or nested columns still opens and its integer
columns scan; :func:`schema_to_bytes` writes only :data:`FLAT_INT_TYPES`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .constants import CONTINUATION_MARKER
from .errors import NotYetImplementedError, OutOfSpecError

# alias → numpy storage dtype of the flat integer types the port reads and
# writes (date32 stores days since the epoch as int32)
FLAT_INT_TYPES = {
    "int8": "<i1", "int16": "<i2", "int32": "<i4", "int64": "<i8",
    "uint8": "<u1", "uint16": "<u2", "uint32": "<u4", "uint64": "<u8",
    "date32": "<i4",
}

_METADATA_V5 = 4  # MetadataVersion.V5
_HEADER_SCHEMA = 1  # MessageHeader.Schema
# Type union ids (Schema.fbs); only Int and Date are read in detail, the
# rest by name (enough to refuse them and to count their leaves)
_T_INT, _T_DATE = 2, 8
_TYPE_NAMES = {
    1: "null", 3: "float", 4: "binary", 5: "string", 6: "bool", 7: "decimal",
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
            self.dtype in FLAT_INT_TYPES
            and not self.children
            and not self.dictionary_encoded
        )

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


class _Table:
    """A flatbuffer table to write: ``scalars`` are (slot, struct format,
    value); ``refs`` are (slot, child) with a child a _Table, a _Vector of
    tables or a str."""

    def __init__(self, scalars=(), refs=()):
        self.scalars = list(scalars)
        self.refs = list(refs)


class _Vector:
    def __init__(self, items: Sequence[_Table]):
        self.items = list(items)


class _FlatWriter:
    """Lays objects out front to back: every child after its parent, so
    every uoffset points forward, as flatbuffers requires."""

    def __init__(self):
        self.buf = bytearray()

    def _pad(self, align: int) -> None:
        self.buf += b"\0" * (-len(self.buf) % align)

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def write(self, obj) -> int:
        if isinstance(obj, str):
            data = obj.encode("utf-8")
            self._pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
            return pos
        if isinstance(obj, _Vector):
            self._pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(obj.items)) + b"\0" * (4 * len(obj.items))
            for j, item in enumerate(obj.items):
                self._patch(pos + 4 + 4 * j, self.write(item))
            return pos
        return self._write_table(obj)

    def _write_table(self, t: _Table) -> int:
        fields = [(slot, fmt, v) for slot, fmt, v in t.scalars]
        fields += [(slot, "<I", child) for slot, child in t.refs]
        # widest first, so each field sits at its natural alignment
        fields.sort(key=lambda f: -struct.calcsize(f[1]))
        n_slots = 1 + max((f[0] for f in fields), default=-1)
        offsets = [0] * n_slots
        inline = 4
        for slot, fmt, _v in fields:
            size = struct.calcsize(fmt)
            inline += -inline % size
            offsets[slot] = inline
            inline += size
        inline += -inline % 4
        vtable = struct.pack(f"<HH{n_slots}H", 4 + 2 * n_slots, inline, *offsets)
        self._pad(2)
        vt_pos = len(self.buf)
        self.buf += vtable
        self._pad(4)
        pos = len(self.buf)
        self.buf += struct.pack("<i", pos - vt_pos) + b"\0" * (inline - 4)
        for slot, fmt, v in fields:
            if fmt != "<I":
                struct.pack_into(fmt, self.buf, pos + offsets[slot], v)
        for slot, child in t.refs:
            self._patch(pos + offsets[slot], self.write(child))
        return pos


def _field_table(f: Field) -> _Table:
    if not f.is_flat_int:
        raise NotYetImplementedError(
            f"writing column {f.name!r} of type {f.dtype} "
            "(ROADMAP.md 'Modules to port': scan_file, further types)"
        )
    if f.dtype == "date32":
        type_id, type_table = _T_DATE, _Table(scalars=[(0, "<h", 0)])  # DAY
    else:
        signed = not f.dtype.startswith("u")
        width = int(f.dtype.split("int")[1])
        type_id = _T_INT
        type_table = _Table(scalars=[(0, "<i", width), (1, "<B", int(signed))])
    return _Table(
        scalars=[(1, "<B", int(f.nullable)), (2, "<B", type_id)],
        refs=[(0, f.name), (3, type_table), (5, _Vector([]))],
    )


def schema_to_bytes(fields: Sequence[Field]) -> bytes:
    """Fields → the bare flatbuffers ``Message`` (MetadataVersion V5),
    zero-padded to a multiple of 8 bytes as pyarrow pads it."""
    schema = _Table(refs=[(1, _Vector([_field_table(f) for f in fields]))])
    message = _Table(
        scalars=[(0, "<h", _METADATA_V5), (1, "<B", _HEADER_SCHEMA)],
        refs=[(2, schema)],
    )
    b = _FlatWriter()
    b.buf += b"\0" * 4  # root uoffset
    b._patch(0, b.write(message))
    b._pad(8)
    return bytes(b.buf)

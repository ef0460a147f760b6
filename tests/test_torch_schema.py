"""Arrow IPC schema bytes of the torch port against the JAX package's
pyarrow-based ``strawboat_tpu.schema``, in both directions."""

import pyarrow as pa
import pytest

from strawboat_tpu import schema as ref
from strawboat_tpu_torch.errors import NotYetImplementedError, OutOfSpecError
from strawboat_tpu_torch import schema as port

FLAT = list(port.FLAT_INT_TYPES)


def _pa_type(alias):
    return pa.type_for_alias(alias)


@pytest.mark.parametrize("nullable", [True, False])
def test_port_bytes_read_by_pyarrow(nullable):
    fields = [port.Field(f"c_{t}", t, nullable) for t in FLAT]
    buf = port.schema_to_bytes(fields)
    assert len(buf) % 8 == 0
    want = pa.schema([pa.field(f.name, _pa_type(f.dtype), nullable) for f in fields])
    assert buf == ref.schema_to_bytes(want)  # pyarrow's bytes
    # bare (as a file stores it) and continuation-prefixed
    assert ref.deserialize_schema(buf).equals(want)
    prefixed = b"\xff\xff\xff\xff" + len(buf).to_bytes(4, "little") + buf
    assert pa.ipc.read_schema(pa.BufferReader(prefixed)).equals(want)


def test_pyarrow_bytes_read_by_port():
    schema = pa.schema(
        [pa.field(f"c_{t}", _pa_type(t), i % 2 == 0) for i, t in enumerate(FLAT)]
    )
    want = [port.Field(f.name, str(f.type).replace("[day]", "").replace("date64[ms]", "date64"),
                       f.nullable) for f in schema]
    assert port.deserialize_schema(ref.schema_to_bytes(schema)) == want  # bare
    assert port.deserialize_schema(schema.serialize().to_pybytes()) == want  # prefixed
    assert port.deserialize_schema(port.schema_to_bytes(want)) == want  # the port's own


def test_other_types_parse_with_their_leaf_counts():
    """Files with strings, floats, timestamps and nested columns open; the
    leaf count keeps the column metas aligned; a timestamp is a flat
    integer type now, and nested fields carry their children."""
    schema = pa.schema(
        [
            pa.field("s", pa.string()),
            pa.field("f", pa.float64()),
            pa.field("b", pa.bool_()),
            pa.field("d", pa.decimal128(15, 2)),
            pa.field("t", pa.timestamp("us")),
            pa.field("l", pa.list_(pa.struct([("p", pa.int8()), ("q", pa.float32())]))),
            pa.field("m", pa.map_(pa.int32(), pa.string())),
            pa.field("st", pa.struct([("a", pa.int64()), ("b", pa.list_(pa.int16()))])),
            pa.field("i", pa.int32()),
        ]
    )
    got = port.deserialize_schema(ref.schema_to_bytes(schema))
    assert [f.name for f in got] == schema.names
    assert [f.dtype for f in got] == ["string", "float64", "bool", "decimal128(15, 2)",
                                      "timestamp[us]", "list", "map", "struct", "int32"]
    assert [f.n_leaves for f in got] == [ref.n_leaf_columns(f.type) for f in schema]
    assert [f.is_flat_int for f in got] == [False] * 4 + [True] + [False] * 3 + [True]
    assert [f.is_nested for f in got] == [False] * 5 + [True] * 3 + [False]
    assert [f.is_flat_float for f in got] == [False, True] + [False] * 7
    assert [f.is_flat_bool for f in got] == [False, False, True] + [False] * 6
    assert [f.is_flat_decimal for f in got] == [False] * 3 + [True] + [False] * 5


def test_dictionary_field_is_not_a_flat_int():
    schema = pa.schema([pa.field("d", pa.dictionary(pa.int32(), pa.string()))])
    (f,) = port.deserialize_schema(ref.schema_to_bytes(schema))
    assert f.dictionary_encoded and not f.is_flat_int


def test_writing_other_types_raises():
    """Strings, floats, booleans, decimals, temporal and nested fields write
    now (``tests/test_torch_strings.py``, ``tests/test_torch_types.py``,
    ``tests/test_torch_temporal.py``, ``tests/test_torch_nested.py``);
    dictionary-typed fields, unions, intervals and malformed nested fields
    still raise."""
    for f in (port.Field("s", "string"), port.Field("x", "float64"), port.Field("b", "bool"),
              port.Field("d", "decimal256(40, 3)"), port.Field("t", "timestamp[ns]"),
              port.Field("l", "list", children=(port.Field("item", "int64"),))):
        assert port.schema_to_bytes([f])
    for f in (port.Field("t", "timestamp"),
              port.Field("l", "list"),
              port.Field("m", "map", children=(port.Field("item", "int64"),)),
              port.Field("u", "union", children=(port.Field("a", "int64"),)),
              port.Field("i", "interval"),
              port.Field("d", "string", dictionary_encoded=True)):
        with pytest.raises(NotYetImplementedError):
            port.schema_to_bytes([f])


def test_bad_bytes_raise():
    good = port.schema_to_bytes([port.Field("a", "int32")])
    with pytest.raises(OutOfSpecError):
        port.deserialize_schema(good[:12])
    with pytest.raises(OutOfSpecError):
        port.deserialize_schema(b"\x00" * 3)
    # a record-batch message is not a schema
    bad = bytearray(good)
    msg = int.from_bytes(bad[:4], "little")
    vt = msg - int.from_bytes(bad[msg : msg + 4], "little", signed=True)
    hdr_type_off = int.from_bytes(bad[vt + 6 : vt + 8], "little")
    bad[msg + hdr_type_off] = 3
    with pytest.raises(OutOfSpecError):
        port.deserialize_schema(bytes(bad))


def test_empty_schema_round_trips():
    assert port.deserialize_schema(port.schema_to_bytes([])) == []
    assert ref.deserialize_schema(port.schema_to_bytes([])).equals(pa.schema([]))

"""Footer parsing: the column metas and the schema.

Counterpart of ``read_meta`` / ``infer_schema`` in
``strawboat_tpu/read/reader.py`` (the reference's src/read/reader.rs).  The
file ends in ``[schema][metas][u32 schema_size][u32 meta_size][EOS: 8
bytes]``; the metas parse with the port's ``meta.py`` and the schema with
the port's own flatbuffer reader.
"""

from __future__ import annotations

import os
from typing import BinaryIO, List

from ..meta import ColumnMeta, deserialize_metas
from ..schema import Field, deserialize_schema


def read_meta(reader: BinaryIO) -> List[ColumnMeta]:
    reader.seek(-12, os.SEEK_END)
    meta_size = int.from_bytes(reader.read(4), "little")
    reader.seek(-16 - meta_size, os.SEEK_END)
    return deserialize_metas(reader.read(meta_size))


def infer_schema(reader: BinaryIO) -> List[Field]:
    reader.seek(-16, os.SEEK_END)
    schema_size = int.from_bytes(reader.read(4), "little")
    meta_size = int.from_bytes(reader.read(4), "little")
    reader.seek(-meta_size - schema_size - 8, os.SEEK_CUR)
    return deserialize_schema(reader.read(schema_size))

#!/usr/bin/env python
"""Write a strawboat file through the torch port's writer (the port's
counterpart of ``examples/strawboat_write.py``, the reference's
examples/strawboat_write.rs).

The table is a Parquet file's, or with ``--rows`` a non-nullable int64
column of that many seeded rows (BASELINE config 1); pages of 8192 rows,
the adaptive chooser over LZ4.  A JSON dump of the column metas goes
beside the file (``<output>.meta.json``, the external-catalog export of
strawboat_write.rs:45-52).

    python examples/torch_strawboat_write.py input.parquet [output.str]
    python examples/torch_strawboat_write.py --rows 1000000 [output.str]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "input.str")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parquet", nargs="?", help="a Parquet file to convert (else --rows)")
    ap.add_argument("output", nargs="?", default=DEFAULT_PATH)
    ap.add_argument("--rows", type=int, help="write a seeded non-nullable int64 column instead")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.rows is not None and args.parquet is not None and args.output == DEFAULT_PATH:
        args.output, args.parquet = args.parquet, None  # --rows N output.str

    import numpy as np
    import pyarrow as pa

    from strawboat_tpu_torch.api import write_file
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression

    if args.parquet is not None:
        import pyarrow.parquet as pq

        table = pq.read_table(args.parquet)
    elif args.rows is not None:
        values = np.random.default_rng(args.seed).integers(0, 1 << 40, args.rows)
        table = pa.table({"a": values}, schema=pa.schema([pa.field("a", pa.int64(), nullable=False)]))
    else:
        ap.error("give a Parquet file or --rows")
    t0 = time.perf_counter()
    metas = write_file(args.output, table, options=WriteOptions(
        default_compression=Compression.LZ4, default_compress_ratio=1.0, max_page_size=8192))
    ms = (time.perf_counter() - t0) * 1e3
    with open(args.output + ".meta.json", "w") as f:
        json.dump([{"offset": m.offset, "pages": [[p.length, p.num_values] for p in m.pages]}
                   for m in metas], f)
    print(f"wrote {args.output} ({table.num_rows} rows) cost {ms:.0f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Read a whole strawboat file at once through the torch port
(``api.read_table``), the port's counterpart of
``examples/strawboat_batch_read.py`` (the reference's
examples/strawboat_batch_read.rs).

    python examples/torch_strawboat_batch_read.py [input.str]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    from strawboat_tpu_torch.api import read_table

    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(tempfile.gettempdir(), "input.str")
    t0 = time.perf_counter()
    table = read_table(path)
    print(f"read {table.num_rows} rows, cost {(time.perf_counter() - t0) * 1e3:.0f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

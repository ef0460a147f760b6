#!/usr/bin/env python
"""Read a strawboat file page by page through the torch port
(``api.iter_batches``), the port's counterpart of
``examples/strawboat_read.py`` (the reference's examples/strawboat_read.rs).

    python examples/torch_strawboat_read.py [input.str]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    from strawboat_tpu_torch.api import iter_batches

    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(tempfile.gettempdir(), "input.str")
    t0 = time.perf_counter()
    rows = sum(batch.num_rows for batch in iter_batches(path))
    print(f"read {rows} rows, cost {(time.perf_counter() - t0) * 1e3:.0f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

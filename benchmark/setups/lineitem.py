"""Set-up of a TPC-H lineitem configuration: the rows generated on the
host from the seed by the benchmark's own generator
(``benchmark/reference/lineitem.py``), and, where the configuration holds
the table resident, the port's resident table on the device.

Configuration keys read: ``scale``, ``orders_per_slice``, ``columns``,
``orders`` (the table's orders, default the scale factor's: tests make
small tables so),
``text_pool_bytes`` (where ``l_comment`` is a column), and ``storage``:
``"resident"`` generates the whole table and builds ``make_resident`` of
the columns at ``tile``; ``"host"`` generates on demand: the slices an
operation asks for (:meth:`Data.make_slices`), or the whole table
(:attr:`Data.table`).  The text pool is kept in the checkout's
``.bench_cache``, made by a checkout's first run.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

from benchmark.reference import lineitem as li_lib

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".bench_cache")
POOL_CACHED_FROM = 1 << 26  # smaller pools (tests) are made anew


@dataclass
class Data:
    cfg: dict
    seed: int
    pool: Any = None  # the text pool, where a column needs it
    resident: Optional[Any] = None  # the port's ResidentTable
    seconds: Dict[str, float] = field(default_factory=dict)  # set-up by part
    slices: Dict[int, li_lib.Lineitem] = field(default_factory=dict)
    _table: Optional[li_lib.Lineitem] = None

    @property
    def table(self) -> li_lib.Lineitem:
        """Every slice's rows of the configuration's integer and coded
        columns, in order."""
        if self._table is None:
            scale, per = float(self.cfg["scale"]), int(self.cfg["orders_per_slice"])
            orders = int(self.cfg.get("orders", scale * li_lib.ORDERS_PER_SF))
            self._table = li_lib.generate_lineitem(self.seed, scale, per, range(-(-orders // per)),
                                                   self.cfg["columns"])
        return self._table

    def make_slices(self, indices: Iterable[int]) -> None:
        """Generate the slices ``indices`` with every configured column,
        in threads."""
        todo = sorted(set(indices) - set(self.slices))
        cols, scale, orders = self.cfg["columns"], float(self.cfg["scale"]), \
            int(self.cfg["orders_per_slice"])
        with cf.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            made = ex.map(lambda s: li_lib.generate_slice(self.seed, scale, s, orders, cols,
                                                          self.pool), todo)
            self.slices.update(zip(todo, made))

    def release(self) -> None:
        """Free the program's state; the generated rows stay for the check."""
        self.resident = None


def build(cfg: dict, seed: int, device) -> Data:
    data = Data(cfg, seed)
    if "l_comment" in cfg["columns"]:
        t0 = time.perf_counter()
        size = int(cfg["text_pool_bytes"])
        data.pool = li_lib.text_pool(size, CACHE if size >= POOL_CACHED_FROM else None)
        data.seconds["text_pool"] = time.perf_counter() - t0
    if cfg["storage"] == "resident":
        from strawboat_tpu_torch.exec import make_resident

        t0 = time.perf_counter()
        cols = data.table.columns(cfg["columns"])
        data.seconds["generate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        data.resident = make_resident(cols, device, tile=int(cfg["tile"]))
        data.seconds["make_resident"] = time.perf_counter() - t0
    elif cfg["storage"] != "host":
        raise ValueError(f"storage {cfg['storage']!r} (resident or host)")
    return data

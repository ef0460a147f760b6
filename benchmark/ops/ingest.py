"""Ingest: each operation writes one slice of the table, the lines of
``orders_per_slice`` orders (about 1,000,000 rows: Databend's
``row_per_block``), all sixteen columns, with ``write_file`` and the
configuration's ``write`` options, to a new file of the run's work
directory.  The columns reach the writer as a database hands them over:
integers and dates (date32) as numpy arrays, strings as arrow-style
offsets and bytes.  A write is acknowledged when ``write_file`` has
returned and the file is closed; nothing is flushed to the disk (no
fsync), as the reference's writer flushes nothing either.

The check reads a sample of the parts written in the window, drawn from
the seed (``check_parts`` of them, from the traffic file), back onto the
device with the program's ``scan_file`` and compares each value with the
rows the part was given; a part that does not read back counts all its
values as wrong.  The traced stretch reads back the parts it wrote, so that the
device's share of an ingest shows beside the writes."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from benchmark.lib.program import write_options
from benchmark.lib.traffic import domain
from benchmark.reference.compare import column_mismatches, text_mismatches
from benchmark.reference.lineitem import COLUMNS, DAYS_TO_1992

LIMITS = {"values_wrong": 0, "parts_unreadable": 0}
DATES = ("l_shipdate", "l_commitdate", "l_receiptdate")


@dataclass
class State:
    parts: Dict[int, dict]  # slice → the columns handed to write_file
    schema: list
    options: object
    directory: str
    device: object
    written: List[str] = field(default_factory=list)


def stored(li) -> Dict[str, object]:
    """What the columns of a generated slice store: integers as they are,
    dates as date32 (days since 1970), strings as (offsets, bytes)."""
    out = {}
    for name in li.names:
        if name in li.ints:
            v = li.ints[name]
            out[name] = (v + DAYS_TO_1992).astype(np.int32) if name in DATES else v
        else:
            out[name] = li.strings(name)
    return out


def _schema(columns: dict):
    from strawboat_tpu_torch.schema import Field

    def dtype(name, v):
        if isinstance(v, tuple):
            return "string"
        return "date32" if name in DATES else str(v.dtype)
    return [Field(n, dtype(n, v), nullable=False) for n, v in columns.items()]


def _program_input(columns: dict, rows: int) -> dict:
    """The writer's columns of the first ``rows`` rows."""
    from strawboat_tpu_torch.columns import BinaryColumn

    out = {}
    for name, v in columns.items():
        if isinstance(v, tuple):
            offsets, values = v
            out[name] = BinaryColumn("string", None, offsets[: rows + 1],
                                     values[: int(offsets[rows])])
        else:
            out[name] = v[:rows]
    return out


def prepare(data, cfg, traffic, device, workdir):
    d = os.path.join(workdir, "parts")
    os.makedirs(d, exist_ok=True)
    slices = domain(traffic["params"]["slice"])
    data.make_slices(slices)
    stores = {k: stored(data.slices[k]) for k in slices}
    parts = {k: _program_input(s, data.slices[k].rows) for k, s in stores.items()}
    order = [c for c in COLUMNS if c in stores[slices[0]]]
    return State({k: {c: p[c] for c in order} for k, p in parts.items()},
                 _schema({c: stores[slices[0]][c] for c in order}),
                 write_options(cfg["write"]), d, device)


def _write(st, columns: dict, k: int):
    from strawboat_tpu_torch.write import write_file

    path = os.path.join(st.directory, f"part-{len(st.written):05d}.str")
    st.written.append(path)
    metas = write_file(path, columns, schema=st.schema, options=st.options)
    rows = len(next(iter(columns.values())))
    return {"path": path, "rows": rows, "bytes": os.path.getsize(path), "slice": k,
            "column_bytes": {f.name: sum(pg.length for pg in m.pages)
                             for f, m in zip(st.schema, metas or [])}}


def run(st, p):
    k = int(p["slice"])
    return _write(st, st.parts[k], k)


def _read_back(path, device) -> Dict[str, tuple]:
    from strawboat_tpu_torch.exec import scan_file

    dt = scan_file(path, device)
    return {name: (c.values.cpu().numpy(), c.dictionary) for name, c in dt.columns.items()}


def after_trace(st, answers):
    for a in answers:
        _read_back(a["path"], st.device)


def facts(st, params):
    return {}


def check(data, traffic, done, device):
    rng = np.random.default_rng([int(data.seed), 0xC4EC])
    pick = rng.permutation(len(done))[: int(traffic["check_parts"])]
    wrong, unreadable = 0, 0
    for p, ans in (done[i] for i in sorted(pick)):
        want = stored(data.slices[int(p["slice"])])
        try:
            got = _read_back(ans["path"], device)
        except Exception:  # a part that does not read back holds nothing
            unreadable += 1
            wrong += sum(len(w[0]) - 1 if isinstance(w, tuple) else len(w) for w in want.values())
            continue
        for name, w in want.items():
            if isinstance(w, tuple):
                n = len(w[0]) - 1
                g = got.get(name)
                wrong += n if g is None or g[1] is None else text_mismatches(g[0], g[1], *w)
            else:
                g = got.get(name)
                wrong += len(w) if g is None else column_mismatches(g[0], w)
    return {"values_wrong": wrong, "parts_unreadable": unreadable}


def control(data, cfg, traffic, params, device, workdir):
    """Parts acknowledged before their last page is written: the program
    writes each of ``params``' slices short of its last page of rows, and
    the check judges them as it judges the window's parts."""
    st = prepare(data, cfg, traffic, device, workdir)
    page = st.options.max_page_size
    done = []
    for p in params:
        k = int(p["slice"])
        rows = data.slices[k].rows
        cut = stored(data.slices[k])
        done.append((p, _write(st, _program_input(cut, rows - ((rows - 1) % page + 1)), k)))
    return check(data, traffic, done, device)

"""Cases of the per-process loader and the keyed aggregate over sharded
resident tables, run by ``tests/test_torch_sharded_agg.py`` in a
single-process mesh and in worlds of processes (``_torch_world.run_world``
with ``"_torch_sharded_world:<case>"`` names; the spawned ranks import this
module, so it imports only numpy, torch and the port).

:func:`make_parts` makes the rows of :data:`SHARDS` shards from a seed:
shards of different lengths, a string column one shard lacks a value of,
an integer column every shard holds dictionary-coded over its own
dictionary, one that some shards hold plain and others coded, a nullable
column, and a key whose groups spread over every shard.  Its money
(``ep``) is dictionary-coded, so Q15's dense stages keep torch's passes;
with ``narrow`` it is one narrow plain plane, as lineitem's is at scale,
so they take kernel K9.  :func:`numpy_q15` is the plain answer they are
held to.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SHARDS = 4
TILE = 512
LENGTHS = (3000, 5200, 700, 4100)
KEYS = 300  # the key runs 1 .. KEYS
QUARTER = (100, 190)  # the ship-date bounds of the queries


def make_parts(seed: int = 7, tie: bool = False,
               narrow: bool = False) -> List[Dict[str, np.ndarray]]:
    """Every shard's columns.  ``tie``: keys 11 and 12 get the same large
    revenue, spread over the shards, so that the largest is held twice.
    ``narrow``: ``ep`` in [0, 512), too many distinct values a shard for
    a dictionary to save a bit (else 100 .. 10^7, dictionary-coded, and
    the tie's totals past 2^31)."""
    rng = np.random.default_rng(seed)
    parts = []
    for s, n in enumerate(LENGTHS):
        flags = np.array(["A", "N"] if s == 0 else ["A", "N", "R"])
        coded = np.array([7, 10**6, 5 * 10**6]) if s != 2 else np.array([7])
        mixed = rng.choice(np.array([0, 10**6]), n) if s % 2 else rng.integers(0, 16, n)
        nv = rng.integers(0, 1000, n)
        part = {
            "k": rng.integers(1, KEYS + 1, n),
            "ep": rng.integers(0, 512, n) if narrow else rng.integers(100, 10**7, n),
            "disc": rng.integers(0, 11, n),
            "sd": rng.integers(0, 300, n).astype(np.int32),
            "flag": flags[rng.integers(0, len(flags), n)],
            "dk": coded[rng.integers(0, len(coded), n)],
            "mixed": mixed,
            "nv": np.ma.MaskedArray(nv, mask=rng.random(n) < 0.1),
        }
        if tie and narrow:
            # keys 11 and 12 only in the first 40 rows of every shard, 20
            # each, in the quarter at the most a row is worth: each key's
            # 80 * 511 * 100 is several times any other key's total
            part["k"][np.isin(part["k"], (11, 12))] = 13
            part["k"][:40] = np.tile((11, 12), 20)
            part["sd"][:40] = QUARTER[0] + 1
            part["ep"][:40] = 511
            part["disc"][:40] = 0
        elif tie:
            # keys 11 and 12 only in rows worth 10**12 more than any other
            # key's total, two rows each on every shard, in the quarter
            part["k"][np.isin(part["k"], (11, 12))] = 13
            part["k"][:4] = (11, 12, 11, 12)
            part["sd"][:4] = QUARTER[0] + 1
            part["ep"][:4] = 10**10 // (SHARDS * 2)
            part["disc"][:4] = 0
        parts.append(part)
    return parts


def whole(parts) -> Dict[str, np.ndarray]:
    """The shards' rows as one table, in shard order."""
    out = {}
    for name in parts[0]:
        cols = [p[name] for p in parts]
        out[name] = (np.ma.concatenate(cols) if isinstance(cols[0], np.ma.MaskedArray)
                     else np.concatenate(cols))
    return out


def numpy_q15(parts, lo: int = QUARTER[0], hi: int = QUARTER[1]):
    """Revenue (``ep * (100 - disc)``) by key over ``lo <= sd < hi``:
    {key: revenue}, the largest and the keys holding it."""
    t = whole(parts)
    m = (t["sd"] >= lo) & (t["sd"] < hi)
    rev = np.zeros(KEYS + 1, np.int64)
    np.add.at(rev, t["k"][m], (t["ep"] * (100 - t["disc"]))[m])
    present = np.zeros(KEYS + 1, bool)
    present[t["k"][m]] = True
    best = int(rev[present].max())
    return ({int(k): int(rev[k]) for k in np.flatnonzero(present)}, best,
            [int(k) for k in np.flatnonzero(present & (rev == best))])


def revenue():
    from strawboat_tpu_torch.exec import col

    return col("ep") * (100 - col("disc"))


def queries(srt) -> Dict:
    """Every query of the cases over ``srt``: Q6's shape with code-space
    bounds on the string and the coded column, the sums by flag, and the
    keyed aggregates (Q15's answer; the nullable column's sum, count, min
    and max; the mixed column's max)."""
    from strawboat_tpu_torch import parallel as par

    out = {
        "filter_sum": par.sharded_filter_sum(
            srt, {"flag": ("N", "S"), "dk": (10, None), "sd": QUARTER}, value="ep"),
        "group_sum": par.sharded_group_sum(srt, "flag", ["ep"], num_groups=3,
                                           predicates={"sd": QUARTER}),
    }
    res = par.sharded_keyed_aggregate(srt, "k", {"revenue": ("sum", revenue())},
                                      {"sd": QUARTER}, max_of="revenue")
    out["q15"] = {"max": res["max"], "groups": groups(res, "revenue")}
    res = par.sharded_keyed_aggregate(
        srt, "k", {"s": ("sum", "nv"), "n": ("count", "nv"), "lo": ("min", "nv"),
                   "hi": ("max", "mixed")}, {"flag": ("N", None)})
    out["nullable"] = {name: groups(res, name) for name in ("s", "n", "lo", "hi")}
    return out


def groups(res, name):
    """A keyed aggregate's valid groups on this process's shards: {key:
    value of ``name``}, per rank (:func:`union` puts a world's together)."""
    from _torch_world import PerRank

    out = {}
    for k, v, a in zip(res["keys"].shards, res["valid"].shards, res[name].shards):
        out.update(zip(k[v].tolist(), a[v].tolist()))
    return PerRank(out)


def union(merged) -> Dict[int, int]:
    """:func:`groups` of every rank as one dict (a world's merged list, or
    a single process's ``PerRank``); no key on two ranks."""
    per = [merged.value] if hasattr(merged, "value") else list(merged)
    out = {}
    for d in per:
        assert not set(d) & set(out)
        out.update(d)
    return out


def local_parts(mesh, parts):
    """The parts of this process's shards on ``mesh`` (every shard outside
    a world)."""
    from strawboat_tpu_torch.parallel.mesh import world

    n = len(mesh.axis_devices("shards"))
    return parts[mesh.first_shard : mesh.first_shard + n] if world() else parts


def q15_run(srt):
    """One Q15 query on this process: its answer (``"max"``, and
    ``"groups"`` as :func:`groups`) and its ``k9.launches`` and
    ``k9.torch_routes`` (``"k9"``, per rank; a CPU shard takes K9's plain
    version, which launches nothing)."""
    from _torch_world import PerRank
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.util import obs

    names = ("k9.launches", "k9.torch_routes")
    before = [obs.counter(n) for n in names]
    res = par.sharded_keyed_aggregate(srt, "k", {"revenue": ("sum", revenue())},
                                      {"sd": QUARTER}, max_of="revenue")
    return {"max": res["max"], "groups": groups(res, "revenue"),
            "k9": PerRank(tuple(obs.counter(n) - b for n, b in zip(names, before)))}


def case_loader(_mesh, inp):
    """The loader over this process's parts on a 4-shard mesh (in a world
    of 2, two shards a process), every query, and a Q15 query's K9
    counts; with ``inp["narrow"]`` (:func:`make_parts` with ``narrow``),
    also Q15 over a table loaded from those (``"narrow_q15"``)."""
    from strawboat_tpu_torch import parallel as par

    mesh = par.make_mesh(SHARDS, _mesh.axis_devices("shards")[0])
    srt = par.load_sharded_resident(local_parts(mesh, inp["parts"]), mesh, tile=TILE)
    out = {"shard_rows": srt.shard_rows, "spans": srt.spans, **queries(srt),
           "q15_k9": q15_run(srt)["k9"]}
    if "narrow" in inp:
        narrow = par.load_sharded_resident(local_parts(mesh, inp["narrow"]), mesh, tile=TILE)
        out["narrow_q15"] = q15_run(narrow)
    return out


def case_capacity(_mesh, inp):
    """A ``num_groups`` below the key's groups raises on every process."""
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.errors import CapacityError

    mesh = par.make_mesh(SHARDS, _mesh.axis_devices("shards")[0])
    srt = par.load_sharded_resident(local_parts(mesh, inp["parts"]), mesh, tile=TILE)
    try:
        par.sharded_keyed_aggregate(srt, "k", {"r": ("sum", "ep")}, num_groups=64)
    except CapacityError as e:
        return {"capacity": e.capacity, "required": e.required}
    return {"capacity": None}

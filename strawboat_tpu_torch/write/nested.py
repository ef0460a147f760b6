"""Nested decomposition: a column → per leaf, its nest chain and leaf column.

Counterpart of ``strawboat_tpu/write/nested.py`` (arrow2's parquet
``to_nested`` / ``slice_parquet_array`` / ``write_rep_and_def``, borrowed
by the reference at src/write/common.rs:66-68 and serialize.rs:217-232),
over the port's column model (``columns.py``) and ``schema.Field``.

Levels are parquet's (Dremel's): with ``c[i]`` the cumulative (nullable +
repeated) sum below level i, a record with definition ``d`` reaches level
i iff ``d >= c[i]`` and is valid there iff ``d > c[i]`` (a nullable
level).  The first element of a list run repeats at its parent's level,
the others at the list's own.  Every step is a numpy expansion per depth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..columns import (
    BinaryColumn, BooleanColumn, Column, FixedSizeListColumn, ListColumn, MapColumn,
    NullColumn, PrimitiveColumn, StructColumn,
)
from ..errors import NotYetImplementedError
from ..read.levels import LIST, PRIMITIVE, STRUCT
from ..schema import Field


@dataclass
class Nest:
    """One level of a leaf's nest chain (arrow2 ``Nested`` analog)."""

    kind: str  # struct | list | primitive
    nullable: bool
    length: int
    validity: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None  # list only (len = length+1)

    @property
    def is_repeated(self) -> bool:
        return self.kind == LIST

    @property
    def is_required(self) -> bool:
        return self.kind != LIST and not self.nullable

    def def_delta(self) -> int:
        return int(self.nullable) + int(self.is_repeated)


def cum_sums(nests: List[Nest]) -> Tuple[np.ndarray, np.ndarray]:
    """(cum_sum, cum_rep) with max_depth+1 entries (read_basic.rs:95-106)."""
    d = len(nests)
    cum_sum = np.zeros(d + 1, dtype=np.int64)
    cum_rep = np.zeros(d + 1, dtype=np.int64)
    for i, n in enumerate(nests):
        cum_sum[i + 1] = cum_sum[i] + n.def_delta()
        cum_rep[i + 1] = cum_rep[i] + int(n.is_repeated)
    return cum_sum, cum_rep


def to_nested(col: Column, field: Field) -> List[Tuple[List[Nest], Column]]:
    """Decompose into per-leaf (nest chain, leaf column) pairs."""
    out: List[Tuple[List[Nest], Column]] = []

    def walk(c: Column, f: Field, parents: List[Nest]) -> None:
        nullable = bool(f.nullable)
        if isinstance(c, StructColumn):
            nest = Nest(STRUCT, nullable, len(c), c.validity)
            for child, cf in zip(c.children, f.children):
                walk(child, cf, parents + [nest])
        elif isinstance(c, ListColumn):
            nest = Nest(LIST, nullable, len(c), c.validity, c.offsets.astype(np.int64))
            walk(c.child, f.children[0], parents + [nest])
        elif isinstance(c, FixedSizeListColumn):
            # no offsets: they are synthesized.  Null rows still own child
            # slots but have no records, so their slots are dropped (a numpy
            # take) and the reader re-inserts them
            child = c.child
            if c.validity is not None and not c.validity.all():
                sizes = np.where(c.validity, c.size, 0).astype(np.int64)
                offs = np.zeros(len(c) + 1, dtype=np.int64)
                np.cumsum(sizes, out=offs[1:])
                child = child.take(np.flatnonzero(np.repeat(c.validity, c.size)))
            else:
                offs = np.arange(len(c) + 1, dtype=np.int64) * c.size
            nest = Nest(LIST, nullable, len(c), c.validity, offs)
            walk(child, f.children[0], parents + [nest])
        elif isinstance(c, MapColumn):
            nest = Nest(LIST, nullable, len(c), c.validity, c.offsets.astype(np.int64))
            entries = Nest(STRUCT, False, len(c.keys), None)
            key_f, value_f = f.children[0].children
            walk(c.keys, key_f, parents + [nest, entries])
            walk(c.items, value_f, parents + [nest, entries])
        elif isinstance(c, (PrimitiveColumn, BooleanColumn, BinaryColumn, NullColumn)):
            out.append((parents + [Nest(PRIMITIVE, nullable, len(c), c.validity)], c))
        else:
            raise NotYetImplementedError(f"to_nested for {type(c)}")

    walk(col, field, [])
    return out


def slice_nested(
    nests: List[Nest], leaf: Column, offset: int, length: int
) -> Tuple[List[Nest], Column]:
    """arrow2 ``slice_parquet_array``: slice rows, translating through offsets."""
    out: List[Nest] = []
    off, ln = offset, length
    for nest in nests:
        if nest.kind == LIST:
            offs = nest.offsets[off : off + ln + 1]
            val = None if nest.validity is None else nest.validity[off : off + ln]
            out.append(Nest(LIST, nest.nullable, ln, val, offs))
            new_off = int(offs[0])
            ln = int(offs[-1]) - new_off
            off = new_off
        elif nest.kind == STRUCT:
            val = None if nest.validity is None else nest.validity[off : off + ln]
            out.append(Nest(STRUCT, nest.nullable, ln, val))
        else:
            val = None if nest.validity is None else nest.validity[off : off + ln]
            out.append(Nest(PRIMITIVE, nest.nullable, ln, val))
    return out, leaf.slice(off, ln)


def write_levels(nests: List[Nest]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Emit (rep, def, leaf_elems) for a sliced nest chain (vectorized).

    ``leaf_elems``: leaf-slot indices (local to the sliced leaf window) the
    traversal reaches, in record order — exactly the values the page must
    store.  Slots under null ancestors are excluded (parquet semantics; the
    reader reconstructs the same count from the level stream).
    """
    cum_sum, cum_rep = cum_sums(nests)
    n_rows = nests[0].length
    rep = np.zeros(n_rows, dtype=np.int64)
    deff = np.zeros(n_rows, dtype=np.int64)
    elem = np.arange(n_rows, dtype=np.int64)
    alive = np.ones(n_rows, dtype=bool)
    # "frozen" records passed a null struct: they keep traversing 1:1 levels
    # (their physical slots ARE stored — the reader's required-struct
    # propagation re-creates them) but terminate at the next list level.
    frozen = np.zeros(n_rows, dtype=bool)
    leaf_elems = np.empty(0, dtype=np.int64)
    for depth, nest in enumerate(nests):
        if not alive.any():
            break
        if nest.kind == STRUCT:
            if nest.nullable:
                act = alive & ~frozen
                a_idx = np.flatnonzero(act)
                valid = (
                    nest.validity[elem[a_idx]]
                    if nest.validity is not None
                    else np.ones(len(a_idx), dtype=bool)
                )
                deff[a_idx[valid]] += 1
                frozen[a_idx[~valid]] = True
            # required struct: descend unchanged
        elif nest.kind == PRIMITIVE:
            leaf_elems = elem[alive]
            if nest.nullable:
                act = alive & ~frozen
                a_idx = np.flatnonzero(act)
                valid = (
                    nest.validity[elem[a_idx]]
                    if nest.validity is not None
                    else np.ones(len(a_idx), dtype=bool)
                )
                deff[a_idx[valid]] += 1
            alive[:] = False
        else:  # LIST
            list_rep = int(cum_rep[depth + 1])
            base_off = int(nest.offsets[0])
            # frozen records terminate at a list level (reader pushes the
            # empty list entry via propagation, then stops)
            alive = alive & ~frozen
            a_idx = np.flatnonzero(alive)
            # elem holds row indices local to this level's window
            e = elem[a_idx]
            starts = nest.offsets[e] - base_off
            ends = nest.offsets[e + 1] - base_off
            valid = (
                nest.validity[e]
                if nest.validity is not None
                else np.ones(len(e), dtype=bool)
            ) if nest.nullable else np.ones(len(e), dtype=bool)
            is_null = ~valid if nest.nullable else np.zeros(len(e), dtype=bool)
            n_children = (ends - starts).astype(np.int64)
            empty = (n_children == 0) & ~is_null
            descend = ~is_null & ~empty
            # per-record expansion counts (1 for terminated / dead)
            counts = np.ones(len(alive), dtype=np.int64)
            counts[a_idx[descend]] = n_children[descend]
            # terminate null / empty lists
            deff_new = deff.copy()
            deff_new[a_idx[empty]] += int(nest.nullable)
            alive_new = alive.copy()
            alive_new[a_idx[is_null]] = False
            alive_new[a_idx[empty]] = False
            # expand
            total = int(counts.sum())
            rep_x = np.repeat(rep, counts)
            deff_x = np.repeat(deff_new, counts)
            alive_x = np.repeat(alive_new, counts)
            elem_x = np.repeat(elem, counts)
            frozen = np.repeat(frozen, counts)
            # positions within each expansion
            firsts = np.zeros(total, dtype=bool)
            firsts[np.cumsum(counts)[:-1]] = True
            firsts[0] = True
            # non-first children of a descending list carry the list's rep
            descend_full = np.zeros(len(alive), dtype=bool)
            descend_full[a_idx[descend]] = True
            desc_x = np.repeat(descend_full, counts)
            rep_x[desc_x & ~firsts] = list_rep
            # child elem: for descending entries, start + offset-within-run
            run_start_positions = np.repeat(np.cumsum(counts) - counts, counts)
            within = np.arange(total, dtype=np.int64) - run_start_positions
            starts_full = np.zeros(len(alive), dtype=np.int64)
            starts_full[a_idx] = starts
            elem_x = np.where(
                desc_x, np.repeat(starts_full, counts) + within, elem_x
            )
            # descended records add nullable+repeated to def
            deff_x[desc_x] += int(nest.nullable) + 1
            rep, deff, elem, alive = rep_x, deff_x, elem_x, alive_x
    return rep.astype(np.uint32), deff.astype(np.uint32), leaf_elems

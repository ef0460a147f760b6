"""Validity and repetition / definition levels of a page.

Counterpart of ``strawboat_tpu/read/levels.py``: ``read_validity`` (a
simple page's prelude, the reference's src/read/read_basic.rs:36-63) and
``read_validity_nested``, the vectorized form of the per-record walk at
read_basic.rs:65-173 (arrow2's ``extend_offsets2``): a nested page's
levels expand into per-depth offsets and validities (``NestedState``) and
the leaf validity, by cumulative level thresholds instead of a walk.
``field_inits`` and ``leaf_fields`` (JAX ``read/deserialize.py``) give each
leaf of a field its chain and its field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..schema import Field
from ..util.hybrid_rle import decode_levels, decode_validity, get_bit_width

STRUCT, LIST, PRIMITIVE = "struct", "list", "primitive"  # the kinds of a level


@dataclass
class InitNested:
    """Schema-derived nesting shape (arrow2 ``InitNested``)."""

    kind: str  # struct | list | primitive
    nullable: bool


@dataclass
class NestedLevel:
    kind: str
    nullable: bool
    length: int
    validity: Optional[np.ndarray]
    offsets: Optional[np.ndarray]  # list levels: len = length + 1


@dataclass
class NestedState:
    levels: List[NestedLevel]

    def pop(self) -> NestedLevel:
        return self.levels.pop()


def read_validity(buf, pos: int, length: int) -> Tuple[Optional[np.ndarray], int]:
    """``[u32 def_levels_len][def levels]`` → (bool validity or None when
    the page has no nulls, position after the prelude)."""
    def_len = int(np.frombuffer(buf, "<u4", 1, pos)[0])
    pos += 4
    if def_len == 0:
        return None, pos
    validity = decode_validity(bytes(buf[pos : pos + def_len]), length)
    return validity, pos + def_len


def init_cums(init: List[InitNested]) -> Tuple[np.ndarray, np.ndarray]:
    d = len(init)
    cum_sum = np.zeros(d + 1, dtype=np.int64)
    cum_rep = np.zeros(d + 1, dtype=np.int64)
    for i, n in enumerate(init):
        cum_sum[i + 1] = cum_sum[i] + int(n.nullable) + int(n.kind == LIST)
        cum_rep[i + 1] = cum_rep[i] + int(n.kind == LIST)
    return cum_sum, cum_rep


def expand_levels(
    rep: np.ndarray, deff: np.ndarray, init: List[InitNested]
) -> Tuple[NestedState, Optional[np.ndarray]]:
    """Vectorized equivalent of the reference's record walk."""
    max_depth = len(init)
    cum_sum, cum_rep = init_cums(init)
    n = len(rep)
    push = []
    prev_push = np.zeros(n, dtype=bool)
    for d in range(max_depth):
        right = (rep <= cum_rep[d]) & (deff >= cum_sum[d])
        if d == 0:
            p = right
        else:
            prev = init[d - 1]
            # arrow2 Nested::is_required(): true for Struct (always), false
            # for lists, !nullable for primitives.  A pushed-but-invalid
            # required level propagates the push to its child, re-inserting
            # null slots so child lengths stay row-aligned.
            required = prev.kind == STRUCT or (
                prev.kind == PRIMITIVE and not prev.nullable
            )
            if required:
                prev_valid = (
                    (deff > cum_sum[d - 1]) if prev.nullable else np.zeros(n, bool)
                )
                p = right | (prev_push & ~prev_valid)
            else:
                p = right
        push.append(p)
        prev_push = p

    levels: List[NestedLevel] = []
    leaf_validity: Optional[np.ndarray] = None
    for d in range(max_depth):
        p = push[d]
        count = int(np.count_nonzero(p))
        nd = init[d]
        validity = None
        if nd.kind == LIST:
            child_push = push[d + 1] if d + 1 < max_depth else None
            if child_push is None:
                starts = np.zeros(count, dtype=np.int64)
                total = 0
            else:
                prior = np.concatenate(
                    ([0], np.cumsum(child_push.astype(np.int64))[:-1])
                )
                starts = prior[p]
                total = int(np.count_nonzero(child_push))
            offsets = np.concatenate([starts, [total]]).astype(np.int64)
            if nd.nullable:
                validity = (deff[p] > cum_sum[d])
            levels.append(NestedLevel(LIST, nd.nullable, count, validity, offsets))
        elif nd.kind == STRUCT:
            if nd.nullable:
                validity = (deff[p] > cum_sum[d])
            levels.append(NestedLevel(STRUCT, nd.nullable, count, validity, None))
        else:  # primitive leaf
            if nd.nullable:
                right = (rep <= cum_rep[d]) & (deff >= cum_sum[d])
                leaf_validity = (right & (deff != cum_sum[d]))[p]
            levels.append(
                NestedLevel(PRIMITIVE, nd.nullable, count, leaf_validity, None)
            )
    return NestedState(levels), leaf_validity


def read_validity_nested(
    buf, pos: int, num_values: int, init: List[InitNested]
) -> Tuple[NestedState, Optional[np.ndarray], int, int]:
    """Nested prelude: [rows u32][rep_len u32][def_len u32][rep][def].

    Returns (state, leaf_validity, rows, new_pos).
    """
    hdr = np.frombuffer(buf, "<u4", 3, pos)
    rows, rep_len, def_len = int(hdr[0]), int(hdr[1]), int(hdr[2])
    pos += 12
    max_rep = int(sum(1 for n in init if n.kind == LIST))
    cum_sum, _ = init_cums(init)
    max_def = int(cum_sum[-1])
    rep_bytes = bytes(buf[pos : pos + rep_len])
    pos += rep_len
    def_bytes = bytes(buf[pos : pos + def_len])
    pos += def_len
    rep = decode_levels(rep_bytes, get_bit_width(max_rep), num_values)
    deff = decode_levels(def_bytes, get_bit_width(max_def), num_values)
    state, leaf_validity = expand_levels(
        rep.astype(np.int64), deff.astype(np.int64), init
    )
    return state, leaf_validity, rows, pos


def nests_to_init(nests) -> List[InitNested]:
    return [InitNested(n.kind, n.nullable) for n in nests]


def field_inits(field: Field) -> List[List[InitNested]]:
    """Per leaf of ``field``, its chain of levels (arrow2's ``InitNested``
    building in the reference's deserialize.rs)."""
    out: List[List[InitNested]] = []

    def walk(f: Field, parents: List[InitNested]) -> None:
        if f.dtype == "struct":
            for child in f.children:
                walk(child, parents + [InitNested(STRUCT, f.nullable)])
        elif f.dtype.startswith("map"):
            n = parents + [InitNested(LIST, f.nullable), InitNested(STRUCT, False)]
            for child in f.children[0].children:
                walk(child, n)
        elif f.is_nested:  # list, large_list, fixed_size_list
            walk(f.children[0], parents + [InitNested(LIST, f.nullable)])
        else:
            out.append(parents + [InitNested(PRIMITIVE, f.nullable)])

    walk(field, [])
    return out


def leaf_fields(field: Field) -> List[Field]:
    """The leaf fields of ``field`` in leaf order (a map: key, then value)."""
    if not field.is_nested:
        return [field]
    kids = field.children[0].children if field.dtype.startswith("map") else field.children
    return [leaf for c in kids for leaf in leaf_fields(c)]

"""What the harness reads of the program's own objects: the shapes of a
resident table's packed planes, and the write options a configuration
names, as the program's ``WriteOptions``."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def resident_planes(rt, names: Sequence[str]) -> List[Tuple[int, int, int]]:
    """``(n_tiles, bits, tile)`` of every packed plane (values, then
    validity) of the resident columns ``names``: what one query over
    them hands kernel K1."""
    out = []
    for n in names:
        c = rt.columns[n]
        out.extend(tuple(w.shape) for w, _b in c.planes)
        if c.validity_plane is not None:
            out.append(tuple(c.validity_plane.shape))
    return out


def write_options(spec: dict):
    """The program's ``WriteOptions`` from a configuration's ``write``
    block (the codec by its name)."""
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.constants import Compression

    return WriteOptions(
        default_compression=Compression[spec["default_compression"]],
        default_compress_ratio=spec.get("default_compress_ratio"),
        max_page_size=spec.get("max_page_size"),
        sample_seed=spec.get("sample_seed"),
        zone_maps=bool(spec.get("zone_maps", False)),
    )

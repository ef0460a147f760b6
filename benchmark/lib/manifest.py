"""``BENCHMARK.json`` and the files it names: loading, lookup by name,
and the checks of names and units that the format sets."""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("device_trace", "host_clock")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def config_data(manifest: dict, name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, by_name(manifest["configs"], name, "config")["file"]))


def traffic_data(name: str, root: str = ROOT) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"traffic name {name!r}")
    return load_json(os.path.join(root, "benchmark", "traffic", f"{name}.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (a per-layer metric without a
    ``workloads`` key goes with every cell that reports what it moves)."""
    e2e = [m for m in manifest["end_to_end"] if _applies(m, cell)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def problems(manifest: dict) -> List[str]:
    """What in ``manifest`` breaks the format's rules of names, units,
    sources and cross references (empty when nothing does)."""
    out: List[str] = []
    names: Dict[str, set] = {"configs": set(), "workloads": set(), "metrics": set()}

    def name_ok(n, what):
        if not isinstance(n, str) or not NAME_RE.match(n):
            out.append(f"{what} name {n!r}")

    for c in manifest.get("configs", []):
        name_ok(c.get("name"), "config")
        if c.get("name") in names["configs"]:
            out.append(f"config {c.get('name')!r} twice")
        names["configs"].add(c.get("name"))
        for k in c.get("reduced", []):
            name_ok(k, "reduced key")
    cells = set()
    for w in manifest.get("workloads", []):
        name_ok(w.get("name"), "workload")
        name_ok(w.get("traffic"), "traffic")
        if w.get("name") in names["workloads"]:
            out.append(f"workload {w.get('name')!r} twice")
        names["workloads"].add(w.get("name"))
        if w.get("config") not in names["configs"]:
            out.append(f"workload {w.get('name')!r}: unknown config {w.get('config')!r}")
        if (w.get("config"), w.get("traffic")) in cells:
            out.append(f"config and traffic of {w.get('name')!r} twice")
        cells.add((w.get("config"), w.get("traffic")))
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')!r}: chips {w.get('chips')!r}")
    e2e = {}
    for group in ("end_to_end", "per_layer"):
        for m in manifest.get(group, []):
            name_ok(m.get("name"), "metric")
            if m.get("name") in names["metrics"]:
                out.append(f"metric {m.get('name')!r} twice")
            names["metrics"].add(m.get("name"))
            if not isinstance(m.get("unit"), str) or not UNIT_RE.match(m["unit"]):
                out.append(f"metric {m.get('name')!r}: unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                out.append(f"metric {m.get('name')!r}: better {m.get('better')!r}")
            allowed = E2E_SOURCES if group == "end_to_end" else SOURCES
            if m.get("source") not in allowed:
                out.append(f"metric {m.get('name')!r}: source {m.get('source')!r}")
            for cell in m.get("workloads", []):
                if cell not in names["workloads"]:
                    out.append(f"metric {m.get('name')!r}: unknown workload {cell!r}")
            if group == "end_to_end":
                e2e[m.get("name")] = m
    for m in manifest.get("per_layer", []):
        moved = e2e.get(m.get("moves"))
        if moved is None:
            out.append(f"metric {m.get('name')!r} moves unknown {m.get('moves')!r}")
            continue
        for cell in m.get("workloads", []):
            if not _applies(moved, cell):
                out.append(f"metric {m.get('name')!r}: {cell!r} does not report {m.get('moves')!r}")
    for cell in names["workloads"]:
        reported = [m for m in manifest.get("end_to_end", []) if _applies(m, cell)]
        if "setup_s" not in {m["name"] for m in reported} or len(reported) < 2:
            out.append(f"workload {cell!r} lacks setup_s or another end-to-end metric")
        if not cell_metrics(manifest, cell, True):
            out.append(f"workload {cell!r} has no per-layer metric")
    return out


def plugin(kind: str, name: str, root: str = ROOT):
    """The module of a plug-in file, ``benchmark/<kind>/<name>.py``, loaded
    by its path (a name may hold dots), once a process."""
    import importlib.util
    import sys

    if not NAME_RE.match(name):
        raise ValueError(f"{kind} name {name!r}")
    key = f"_bench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    mod = sys.modules.get(key)
    if mod is None:
        path = os.path.join(root, "benchmark", kind, f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no {kind} file {os.path.relpath(path, root)}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod

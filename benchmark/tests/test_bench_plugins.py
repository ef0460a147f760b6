"""The harness is driven by data: a per-layer metric added as a new file
and a new entry of ``BENCHMARK.json`` is found and reported, with no edit
to a file that is there."""

import json
import os
import shutil

from bench_helpers import ROOT, TINY, tiny_run


def test_a_new_metric_file_and_entry_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    manifest["per_layer"].append({
        "name": "ops_in_window", "unit": "ops", "better": "higher", "source": "host_clock",
        "layer": "device (H100)", "moves": "queries_per_s", "workloads": ["resident_q6"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (root / "benchmark" / "metrics" / "ops_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx.done) or None\n")
    res = tiny_run("resident_q6", trace=1, seconds=0.3, root=str(root))
    assert res["correct"]
    assert res["metrics"]["ops_in_window"]["value"] >= 1
    assert res["metrics"]["ops_in_window"]["unit"] == "ops"
    # a cell that the entry does not list does not report it
    res = tiny_run("resident_q1", trace=1, seconds=0.3, root=str(root))
    assert "ops_in_window" not in res["metrics"]


def test_a_new_traffic_file_and_cell_run(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    manifest["workloads"].append({"name": "resident_q6_1994", "config": "lineitem_sf10_resident",
                                  "traffic": "q6_1994", "chips": 1, "why": "one year"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "resident_q6" in m.get("workloads", []):
            m["workloads"].append("resident_q6_1994")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    t = json.load(open(os.path.join(ROOT, "benchmark", "traffic", "q6_closed.json")))
    t["params"]["year"] = {"values": [1994]}
    (root / "benchmark" / "traffic" / "q6_1994.json").write_text(json.dumps(t))
    res = tiny_run("resident_q6_1994", seconds=0.3, root=str(root), overrides=TINY["resident_q6"])
    assert res["correct"] and res["metrics"]["queries_per_s"]["value"] > 0

"""``BENCHMARK.json``: the format's names, units and cross references,
and every file it names."""

import copy
import json
import os

import pytest

from benchmark.lib import manifest as mf

from bench_helpers import ROOT

M = mf.load(ROOT)


def test_manifest_has_no_problems():
    assert mf.problems(M) == []


def test_manifest_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("m", M["end_to_end"] + M["per_layer"], ids=lambda m: m["name"])
def test_metric_name_unit_and_reader(m):
    assert mf.NAME_RE.match(m["name"])
    assert mf.UNIT_RE.match(m["unit"]) and len(m["unit"]) <= 16
    assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
    assert hasattr(mf.plugin("metrics", m["name"]), "read")


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert mf.by_name(M["end_to_end"], "setup_s", "metric")["bound"] == 0.25


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_moves(w):
    cfg = mf.config_data(M, w["config"], ROOT)
    traffic = mf.traffic_data(w["traffic"], ROOT)
    assert hasattr(mf.plugin("setups", cfg["setup"]), "build")
    op = mf.plugin("ops", traffic["operation"])
    for fn in ("prepare", "run", "facts", "check", "control"):
        assert callable(getattr(op, fn)), fn
    e2e = {m["name"] for m in mf.cell_metrics(M, w["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = mf.cell_metrics(M, w["name"], True)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], w["name"])


def test_reduced_names_keys_of_the_file():
    for c in M["configs"]:
        cfg = mf.config_data(M, c["name"], ROOT)
        assert set(c["reduced"]) <= set(cfg)
        assert c["file"].startswith("benchmark/")


def test_files_configuration_writes_every_lineitem_column():
    from benchmark.reference.lineitem import COLUMNS

    assert mf.config_data(M, "lineitem_sf10_files", ROOT)["columns"] == list(COLUMNS)


@pytest.mark.parametrize("change, problem", [
    (lambda m: m["end_to_end"][0].update(unit="queries per s"), "unit"),
    (lambda m: m["end_to_end"][0].update(name="bad name"), "metric name"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves unknown"),
    (lambda m: m["per_layer"][0].update(workloads=["file_ingest_1m"]), "does not report"),
    (lambda m: m["end_to_end"][0].update(source="program_counter"), "source"),
    (lambda m: m["workloads"][1].update(name=m["workloads"][0]["name"]), "twice"),
    (lambda m: m["workloads"][0].update(chips=2), "chips"),
])
def test_problems_are_found(change, problem):
    m = copy.deepcopy(M)
    change(m)
    assert any(problem in p for p in mf.problems(m))

"""The port's scripts of BASELINE configs 4 and 5, end to end on the CPU.

Each example or script runs in a subprocess with ``--device cpu`` at a
tiny size (about 50 000 rows, 2 shards) and must pass its own checks
against the numpy references: exit 0 and a last line of JSON with
``"ok": true``.  The child runs the script through ``runpy`` and then
prints whether JAX or any module of the JAX package was loaded: none may
be.  A per-test limit keeps a hung script from holding up the suite.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240

CHILD = """
import json, runpy, sys
sys.argv = {argv!r}
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
ref = sorted(m for m in sys.modules if m == "strawboat_tpu" or m.startswith("strawboat_tpu."))
print(json.dumps({{"jax": "jax" in sys.modules, "strawboat_tpu": ref}}))
"""

SCRIPTS = {
    "examples/torch_tpch_bench.py": ["--rows", "50000"],
    "examples/torch_resident_query.py": ["--rows", "50000"],
    "examples/torch_bench_write.py": ["--max-log2", "14", "--iters", "1"],
    "scripts/torch_tpch_sf10.py": ["--rows", "50000", "--reps", "1"],
    "scripts/torch_resident_q1.py": ["--rows", "50000", "--reps", "2"],
    "scripts/torch_dist_sf1_stream.py": ["--rows", "50000", "--shards", "2"],
    "scripts/torch_scaling_proxy.py": ["--rows", "50000", "--shards", "2", "--reps", "1"],
}


def run_script(script: str, args, tmp_path) -> dict:
    """The script's JSON summary (its last line but one) after it ran on
    the CPU; the child's own last line must show no JAX module loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), TMPDIR=str(tmp_path))
    argv = [str(ROOT / script), "--device", "cpu", *args]
    out = subprocess.run([sys.executable, "-c", CHILD.format(argv=argv)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"jax": False, "strawboat_tpu": []}
    return json.loads(lines[-2])


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_runs_and_passes_its_checks(script, tmp_path):
    summary = run_script(script, SCRIPTS[script], tmp_path)
    assert summary["ok"] is True
    if "device" in summary:
        assert summary["device"] == "cpu"


def test_config5_scripts_report_the_reference_keys(tmp_path):
    proxy = "scripts/torch_scaling_proxy.py"
    summary = run_script(proxy, SCRIPTS[proxy], tmp_path)
    for key in ("rows_s_1", "rows_s_N", "efficiency_proxy", "n_rows"):
        assert key in summary, key
    assert summary["n_rows"] == 50000 and summary["n_shards"] == 2
    # the reference's definition: (rows_s_N / N) / rows_s_1
    assert summary["efficiency_proxy"] == pytest.approx(
        summary["rows_s_N"] / summary["rows_s_1"] / 2, rel=1e-12)
    assert summary["speedup_N"] == pytest.approx(summary["rows_s_N"] / summary["rows_s_1"],
                                                 rel=1e-12)
    stream = run_script("scripts/torch_dist_sf1_stream.py",
                        SCRIPTS["scripts/torch_dist_sf1_stream.py"], tmp_path)
    assert (stream["parts"], stream["groups"], stream["shards"]) == (12, 50, 2)


def test_scripts_refuse_a_missing_card(tmp_path):
    """No fallback: ``--device cuda`` (the default) without a card fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, str(ROOT / "examples/torch_tpch_bench.py"), "--rows",
                          "5000"], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

"""The harness on the card at a small size: a traced run of each cell
reads ``correct`` true and gives its per-layer metrics.  Marked ``cuda``;
on the card: ``python -m pytest benchmark/tests -q -m cuda``."""

import pytest

from benchmark.lib import manifest as mf

from bench_helpers import ROOT, TINY, tiny_run

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_tiny_run_on_card(cuda, cell):
    res = tiny_run(cell, trace=1, seconds=0.5, device=cuda)
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    want = {m["name"] for m in mf.cell_metrics(mf.load(ROOT), cell, True)}
    # K1's records at this size: the roofline is read wherever K1 ran
    assert want <= set(res["metrics"]), (want, res["metrics"])

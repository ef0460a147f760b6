"""The control of every cell comes out as not correct: the reference in
int32 in the program's place, or for ingest, parts acknowledged before
their last page is written (at the cells' tiny sizes on the CPU; on the
card at their own size by ``benchmark/control.py``)."""

import pytest

from bench_helpers import TINY

from benchmark.control import control_numbers


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails(cell, seed):
    numbers, limits = control_numbers(cell, seed, ops=40 if cell != "file_ingest_1m" else 3,
                                      device_name="cpu", overrides=TINY[cell])
    assert any(numbers[k] > limits[k] for k in limits), numbers

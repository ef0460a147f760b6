"""A run with the timed path broken underneath reads ``correct`` false:
each fault a cell can have, planted in the program, on the CPU at the
cell's tiny size.  (The cells run on one card: none has an exchange
between chips to leave out.)"""

import pytest

from bench_helpers import tiny_run


@pytest.fixture
def resident():
    from strawboat_tpu_torch.exec.resident import ResidentTable

    return ResidentTable


def _half_mask(orig):
    def mask_tiled(self):
        m = orig(self).clone()
        m[1::2] = False  # half of the rows left out
        return m
    return mask_tiled


@pytest.mark.parametrize("cell", ["resident_q1", "resident_q6"])
def test_half_the_rows_left_out(monkeypatch, resident, cell):
    monkeypatch.setattr(resident, "mask_tiled", _half_mask(resident.mask_tiled))
    assert tiny_run(cell)["correct"] is False


def test_resident_q6_answer_altered(monkeypatch, resident):
    orig = resident.filter_sum
    monkeypatch.setattr(resident, "filter_sum", lambda self, *a, **k: orig(self, *a, **k) + 1)
    assert tiny_run("resident_q6")["correct"] is False


def test_resident_q1_answer_altered(monkeypatch):
    from strawboat_tpu_torch.exec import query

    orig = query.dense_group_sum

    def altered(*a, **k):
        s, c = orig(*a, **k)
        return s + 1, c
    monkeypatch.setattr(query, "dense_group_sum", altered)
    assert tiny_run("resident_q1")["correct"] is False


def test_ingest_write_that_leaves_nothing(monkeypatch):
    from strawboat_tpu_torch import write

    orig, calls = write.write_file, []

    def nothing(path, data, **k):
        calls.append(path)
        if len(calls) == 1:  # the warm-up's part is sound
            return orig(path, data, **k)
        open(path, "wb").close()
    monkeypatch.setattr(write, "write_file", nothing)
    res = tiny_run("file_ingest_1m")
    assert res["correct"] is False and res["checks"]["parts_unreadable"]["value"] > 0


def test_ingest_value_altered(monkeypatch):
    from strawboat_tpu_torch import write

    orig = write.write_file

    def altered(path, data, **k):
        data = dict(data)
        q = data["l_quantity"].copy()
        q[len(q) // 3] += 1
        data["l_quantity"] = q
        return orig(path, data, **k)
    monkeypatch.setattr(write, "write_file", altered)
    res = tiny_run("file_ingest_1m")
    assert res["correct"] is False and res["checks"]["values_wrong"]["value"] > 0


def test_ingest_half_the_rows_left_out(monkeypatch):
    from strawboat_tpu_torch import write

    orig = write.write_file

    def half(path, data, **k):
        n = len(next(iter(data.values()))) // 2
        return orig(path, {name: c.slice(0, n) if hasattr(c, "slice") else c[:n]
                           for name, c in data.items()}, **k)
    monkeypatch.setattr(write, "write_file", half)
    res = tiny_run("file_ingest_1m")
    assert res["correct"] is False and res["checks"]["values_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", ["resident_q1", "resident_q6", "file_ingest_1m"])
def test_sound_runs_are_correct(cell):
    assert tiny_run(cell)["correct"] is True

"""A whole run on the CPU past the look for a card, sound and with the timed
path broken underneath: ``correct`` holds, then comes out false for each
fault a cell can have (one card, so no exchange between cards to leave
out)."""

import math

import pytest

from cpu_cells import run_cell


@pytest.mark.parametrize("name", ["cp_train", "hash_train"])
def test_sound_run_is_correct(name):
    line, records = run_cell(name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] >= 1 and line["failed"] == 0
    assert "setup_s" in line["metrics"] and line["metrics"]["setup_s"]["value"] > 0
    assert len(line["metrics"]) >= 2
    assert any(r.startswith("setup:") for r in records)


@pytest.mark.parametrize("name,fault", [("cp_train", "unchanged"), ("cp_train", "half_batch"),
                                        ("hash_train", "unchanged"),
                                        ("hash_train", "half_batch")])
def test_fault_is_caught(name, fault):
    line, _ = run_cell(name, fault=fault)
    assert not line["correct"], line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_traced_run_carries_breakdown():
    line, _ = run_cell("cp_train", trace=True)
    assert line["correct"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0 and math.isfinite(line["device"]["busy_s"])
    assert "mfu.cp_train" in line["metrics"] and "trainer_host_ms.cp" in line["metrics"]

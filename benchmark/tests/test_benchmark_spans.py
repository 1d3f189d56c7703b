"""The readers of the program's spans and counters (``spans.py``) on a
synthetic snapshot, and a whole traced CPU run that reports the counter
metrics beside every metric it reported before."""

import os
from types import SimpleNamespace

import pytest

from cpu_cells import BENCH, run_cell

NEW = ("march_ms", "encode_ms", "network_ms", "backward_ms", "host_syncs_per_step",
       "march_slot_use")


def reader(name):
    from benchmark import harness
    return harness.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                               "metric_" + name.replace(".", "_")).read


def _snapshot(device: bool):
    """Two steps: train_step > [grid.refresh > encode (the first only), render >
    [march, geometry > encode, color], backward > scatter_add_rows]."""
    from envidr_tpu_torch import obs

    spans = []

    def add(name, parent, ms, step):
        root = len(spans) if parent is None else spans[parent].root
        depth = 0 if parent is None else spans[parent].depth + 1
        spans.append(obs.SpanRecord(name, parent, root, depth, step, 0, 0, 1,
                                    ms if device else None))
        return len(spans) - 1

    per = [  # march, geometry, encode, color, backward, refresh encode
        (4.0, 30.0, 20.0, 10.0, 100.0, 50.0),
        (6.0, 40.0, 25.0, 12.0, 120.0, None)]
    for step, (march, geo, enc, color, bwd, refresh) in enumerate(per):
        r = add("train_step", None, 300.0, step)
        if refresh is not None:
            add("encode", add("grid.refresh", r, 60.0, step), refresh, step)
        render = add("render", r, 80.0, step)
        add("march", render, march, step)
        add("encode", add("geometry", render, geo, step), enc, step)
        add("color", render, color, step)
        add("scatter_add_rows", add("backward", r, bwd, step), 1.0, step)
        spans[r].counters = {"host_sync": 1 - step, "host_sync.implicit": 2,
                             "march.slots": 1000, "march.samples": 130.0 + 20 * step}
    return obs.Snapshot(spans, {})


@pytest.mark.parametrize("device", [True, False])
def test_readers_on_a_synthetic_snapshot(monkeypatch, device):
    from envidr_tpu_torch import obs
    snap = _snapshot(device)
    monkeypatch.setattr(obs, "snapshot", lambda: snap)
    run = SimpleNamespace(kind="train", trace=object())
    want = {"march_ms": 5.0, "encode_ms": 22.5, "network_ms": 23.5, "backward_ms": 110.0,
            "host_syncs_per_step": 2.5, "march_slot_use": 14.0}
    for name in NEW:
        for cell in ("cp", "hash"):
            got = reader(f"{name}.{cell}")(run)
            if device or name in ("host_syncs_per_step", "march_slot_use"):
                assert got == pytest.approx(want[name]), name
            else:
                assert got is None, name       # no card, no device ms


def test_readers_read_nothing_without_spans(monkeypatch):
    from envidr_tpu_torch import obs
    traced = SimpleNamespace(kind="train", trace=object())
    monkeypatch.setattr(obs, "snapshot", lambda: obs.Snapshot([], {}))
    for name in NEW:
        assert reader(f"{name}.cp")(traced) is None
        assert reader(f"{name}.cp")(SimpleNamespace(kind="train", trace=None)) is None
    monkeypatch.setattr(obs, "snapshot", lambda: _snapshot(True))
    assert reader("march_ms.cp")(SimpleNamespace(kind="train", trace=None)) is None


def test_traced_run_reports_the_counter_metrics_beside_the_old_ones():
    line, _ = run_cell("cp_train", trace=True)
    assert line["correct"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    metrics = line["metrics"]
    # what the CPU run reported before, and the counters; no device ms without a card
    assert set(metrics) == {"mfu.cp_train", "trainer_host_ms.cp", "host_syncs_per_step.cp",
                            "march_slot_use.cp"}
    syncs = metrics["host_syncs_per_step.cp"]
    # 16 traced steps: at most one starts an epoch and reads the mean count
    assert syncs["unit"] == "count" and syncs["value"] in (0.0, 1 / 16)
    assert 0 < metrics["march_slot_use.cp"]["value"] <= 100
    assert metrics["march_slot_use.cp"]["unit"] == "%"

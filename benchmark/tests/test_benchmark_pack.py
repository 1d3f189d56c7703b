"""The reader of the march's packing (``readers_pack.py``) on synthetic
snapshots: the share over the traced steps, and None where nothing packed
or nothing was recorded (a program without the counters reads None)."""

import os
from types import SimpleNamespace

from cpu_cells import BENCH


def reader():
    from benchmark import harness
    return harness.load_module(os.path.join(BENCH, "metrics", "march_pack_share.cp.py"),
                               "metric_march_pack_share_cp").read


def _snapshot(counters):
    """One closed ``train_step`` root a dict of ``counters``."""
    from envidr_tpu_torch import obs
    spans = []
    for step, c in enumerate(counters):
        spans.append(obs.SpanRecord("train_step", None, len(spans), 0, step, 0, 0, 1, 200.0,
                                    counters=dict(c)))
    return obs.Snapshot(spans, {})


def test_share_of_the_packed_renders_slots(monkeypatch):
    from envidr_tpu_torch import obs
    traced = SimpleNamespace(kind="train", trace=object())
    steps = [{"march.pack.rows": 4096, "march.pack.slots": 32768, "march.slots": 32768},
             {"march.pack.rows": 8192, "march.pack.slots": 32768, "march.slots": 32768},
             {"march.pack.dense": 1, "march.slots": 32768}]       # a step that stayed dense
    monkeypatch.setattr(obs, "snapshot", lambda: _snapshot(steps))
    assert reader()(traced) == 100.0 * 12288 / 65536
    assert reader()(SimpleNamespace(kind="train", trace=None)) is None
    # a program without the counters (the parent), or renders that all stayed dense
    monkeypatch.setattr(obs, "snapshot", lambda: _snapshot([{"march.slots": 32768}] * 2))
    assert reader()(traced) is None
    monkeypatch.setattr(obs, "snapshot", lambda: obs.Snapshot([], {}))
    assert reader()(traced) is None

"""The port's spans and counters (``envidr_tpu_torch/obs.py``) on the small
hash-grid trainer on the CPU: off by default and free, the span tree of a
recorded step, the profiler's clock, the counters a step, the launch counts
and the idle-gap naming."""

import dataclasses
import json
import threading
import warnings

import pytest
import torch

from envidr_tpu_torch import obs
from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from envidr_tpu_torch.ops import _cuda, gather, scatter
from envidr_tpu_torch.ops.grid import init_grid
from envidr_tpu_torch.train import profile_step
from envidr_tpu_torch.train import trainer as trainer_mod
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import SMALL, SYNTH_INI, one_torch_thread_fixture

one_torch_thread = one_torch_thread_fixture()

RENDER_CHILDREN = ["march", "geometry", "composite", "color", "composite"]


@pytest.fixture
def tiny():
    """A small hash-grid trainer on a 32^3 grid (its first refresh takes
    milliseconds), four 40 px views, after an empty recording."""
    torch.manual_seed(0)
    opt = load_options(SYNTH_INI, **SMALL)
    tr = Trainer(opt, network_config(opt), device="cpu")
    tr.grid_spec = dataclasses.replace(tr.grid_spec, grid_size=32)
    tr.grid = init_grid(tr.grid_spec, "cpu")
    _empty_recording()
    return tr, SynthSpheres("train", size=40, n=4, scale=opt.scale)


def _empty_recording():
    with obs.recording():
        pass


def _children(snap, i):
    return [s.name for s in snap.spans if s.parent == i]


def test_off_span_is_one_shared_noop_and_a_step_records_nothing(tiny, monkeypatch):
    tr, data = tiny
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(a) or None)
    assert obs.span("a") is obs.span("b", step=3)
    with obs.span("a") as inside:
        assert inside is None
    tr.train_step(data)
    snap = obs.snapshot()
    assert snap.spans == [] and snap.counters == {} and made == []


def test_recorded_step_is_the_span_tree(tiny):
    tr, data = tiny
    with obs.recording():
        tr.train_step(data)                     # step 0: refreshes the grid
        tr.train_step(data)
    snap = obs.snapshot()
    roots = snap.roots("train_step")
    assert [snap.spans[r].step for r in roots] == [0, 1]
    for k, r in enumerate(roots):
        refresh = ["grid.refresh"] if k == 0 else []
        assert _children(snap, r) == refresh + ["rays", "render", "loss", "backward", "update"]
        top = snap.spans[r]
        for i, s in enumerate(snap.spans):
            if s.root == r:
                assert s.step == k and top.t0_ns <= s.t0_ns <= s.t1_ns <= top.t1_ns
        render = next(i for i, s in enumerate(snap.spans) if s.root == r and s.name == "render")
        assert _children(snap, render) == RENDER_CHILDREN
        geometry = next(i for i in range(len(snap.spans)) if snap.path(i)[-2:] == (
            "render", "geometry") and snap.spans[i].root == r)
        assert _children(snap, geometry) == ["encode"]
        assert all(s.device_ms is None for s in snap.spans)      # no card
    refresh = [snap.path(i) for i, s in enumerate(snap.spans) if s.name == "encode"]
    assert ("train_step", "grid.refresh", "encode") in refresh


def test_spans_start_on_the_profilers_clock(tiny, tmp_path):
    tr, data = tiny
    tr.train_step(data)                         # the refresh, unprofiled
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.train_step(data)
    snap = obs.snapshot()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    trace = json.loads((tmp_path / "t.json").read_text())
    base_us = float(trace["baseTimeNanoseconds"]) / 1e3
    marks = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            marks.setdefault(e["name"], []).append(float(e["ts"]) + base_us)
    names = {s.name for s in snap.spans}
    assert {"train_step", "render", "march", "encode", "backward"} <= names
    for name in names:
        starts = sorted(s.t0_ns / 1e3 for s in snap.spans if s.name == name)
        assert len(marks[name]) == len(starts)
        for ours, theirs in zip(starts, sorted(marks[name])):
            assert abs(ours - theirs) < 200.0, name


def test_launch_counts_is_a_view_of_the_counters():
    before = _cuda.launch_counts()
    libs = [scatter.KERNEL, gather.KERNEL]
    assert before == {lib.symbol: lib.launches for lib in _cuda.LIBRARIES}
    assert set(before) >= {lib.symbol for lib in libs}
    assert all(type(v) is int for v in before.values())
    saved = [lib.launches for lib in libs]
    try:
        obs.count(scatter.KERNEL.counter)
        assert scatter.KERNEL.launches == saved[0] + 1
        scatter.KERNEL.launches = 0
        assert _cuda.launch_counts()[scatter.KERNEL.symbol] == 0
        assert obs.COUNTERS["launches.scatter_add_rows_launch"] == 0
    finally:
        for lib, n in zip(libs, saved):
            lib.launches = n
    assert _cuda.launch_counts() == before


def test_host_sync_counts_planted_reads(tiny, monkeypatch):
    """A planted ``.item()`` made on purpose counts as ``host_sync``; the sync
    debug mode's warning of one the program did not mean counts as
    ``host_sync.implicit``, and is not printed."""
    tr, data = tiny
    with obs.recording():
        tr.train_step(data)                    # starts the epoch: reads the mean count
    assert obs.snapshot().counters.get("host_sync") == 1
    orig = trainer_mod.compute_losses

    def planted(out, *a, **k):
        with obs.host_sync():
            out["weights_sum"].sum().item()
        warnings.warn(obs.SYNC_WARNING)         # as torch's sync debug mode words it
        return orig(out, *a, **k)
    monkeypatch.setattr(trainer_mod, "compute_losses", planted)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with obs.recording():
            tr.train_step(data)                # mid-epoch: no read of its own
    counters = obs.snapshot().counters
    assert counters.get("host_sync") == 1 and counters.get("host_sync.implicit") == 1
    assert not [w for w in shown if obs.SYNC_WARNING in str(w.message)]


def test_march_samples_over_slots_is_mean_count_over_k(tiny):
    tr, data = tiny
    with obs.recording():
        m = tr.train_step(data)
    c = obs.snapshot().counters
    assert c["march.slots"] == tr.opt.num_rays * m["K"]
    assert c["march.samples"] / c["march.slots"] == pytest.approx(
        float(m["mean_count"]) / m["K"], rel=1e-6)


def test_span_on_another_thread_takes_the_roots_open_span_as_parent():
    seen = {}

    def backward_thread():
        with obs.span("scatter_add_rows"):
            seen["ok"] = True
    with obs.recording():
        with obs.span("train_step", 7):
            with obs.span("backward"):
                t = threading.Thread(target=backward_thread)
                t.start()
                t.join(timeout=10)
        with obs.span("other"):                  # a new root after it closed
            pass
    assert seen and not t.is_alive()
    snap = obs.snapshot()
    names = [s.name for s in snap.spans]
    assert names == ["train_step", "backward", "scatter_add_rows", "other"]
    s = snap.spans[2]
    assert snap.path(2) == ("train_step", "backward", "scatter_add_rows")
    assert s.step == 7 and s.thread != snap.spans[1].thread
    assert snap.spans[3].parent is None and snap.spans[3].step is None


def test_recording_cap_and_a_new_recording_clears(monkeypatch):
    monkeypatch.setattr(obs, "MAX_SPANS", 3)
    with obs.recording():
        for _ in range(5):
            with obs.span("x"):
                pass
    snap = obs.snapshot()
    assert len(snap.spans) == 3 and snap.dropped == 2
    with obs.recording():
        with obs.span("y"):
            pass
    assert [s.name for s in obs.snapshot().spans] == ["y"] and obs.snapshot().dropped == 0
    with obs.span("off"):                       # off again: the recording stays
        pass
    assert [s.name for s in obs.snapshot().spans] == ["y"]
    _empty_recording()
    assert obs.snapshot().spans == [] and obs.snapshot().counters == {}


def _span(name, depth, t0_us, t1_us):
    return obs.SpanRecord(name, None, 0, depth, None, 0, int(t0_us * 1e3), int(t1_us * 1e3))


def test_idle_gaps_are_named_by_the_innermost_span():
    spans = [_span("train_step", 0, 0, 100), _span("render", 1, 10, 65),
             _span("march", 2, 12, 30), _span("backward", 1, 66, 95)]
    busy = [(0, 5), (3, 14), (20, 50), (70, 90), (120, 130)]   # the last lies outside
    gaps = profile_step.idle_gaps(busy, 0, 120, spans)
    assert [(n, a) for n, a, _ in gaps] == [("between_spans", 90), ("render", 50),
                                            ("march", 14)]
    assert [ms for _, _, ms in gaps] == pytest.approx([0.03, 0.02, 0.006])
    assert profile_step.idle_gaps(busy, 0, 120, spans, n=1)[0][0] == "between_spans"


def test_profile_steps_table_and_trace_from_a_snapshot():
    spans = [_span("train_step", 0, 0, 100), _span("render", 1, 10, 60)]
    spans[1].parent = 0
    for s, ms, own in zip(spans, (80.0, 60.0), (20.0, 60.0)):
        s.device_ms, s.self_device_ms = ms, own
    spans[0].counters = {"host_sync": 2, "march.slots": 64}
    snap = obs.Snapshot(spans, {"host_sync": 2, "march.slots": 64})
    table = profile_step.span_table(snap)
    assert "train_step/render" in table and "children_share_of_train_step_device_ms: " \
        "min 0.7500" in table and "host_sync=2" in table
    trace = profile_step.trace_with_spans({"baseTimeNanoseconds": 5000, "traceEvents": []},
                                          snap)
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e["ts"], e["dur"]) for e in xs] == [("train_step", -5.0, 100.0),
                                                             ("render", 5.0, 50.0)]
    assert profile_step.span_table(obs.Snapshot([], {})) == "spans: none recorded\n"

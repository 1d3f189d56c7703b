"""The interreflection cell ``shiny3_indir_train`` on the CPU: its files
found by name, its scene reader against the program's loader, its FLOP
count and readers against hand counts, the reference against the program
at a tiny size, the TF32 and half-batch controls failing its limits, and
whole tiny runs, sound and with a fault planted under the timed path.

The tiny size: 64 rays a step, the env net (drawn from the seed) 64 wide,
and in place of the 60 train views one 8 x 12 crop of the scene's val view 0
around pixels where the renv gate opens (a reflected ray's opacity above 0.9
on the mirror sphere's low roughness): at 64 uniform rays of a whole
400 x 400 view the gate would open on none, and a fault in the renv branch
or in pass 2 would change nothing the step computes."""

import contextlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cpu_cells import BENCH, ROOT, SEED, find

CELL = "shiny3_indir_train"
TINY = {"num_rays": 64, "hidden_dim_env": 64}
CROP = (169, 181, 134, 142)          # rows, columns of val view 0 at 400 x 400
METRICS = {"indirect_geometry_ms", "indirect_reflect_ms", "indirect_main_ms", "renv_ms",
           "indirect_ref_ray_share", "indirect_reflect_slot_use", "mfu.shiny3_indir_train"}
# metrics on the existing readers of a train step: cp_train's, and the idle share
REUSED = {"backward_ms.cp", "host_syncs_per_step.cp", "trainer_host_ms.cp",
          "grid_refresh_step_ms.cp", "encode_ms.cp", "network_ms.cp", "march_ms.cp",
          "march_slot_use.cp", "device_idle_share.shiny3_indir_train"}


def kind():
    from benchmark import harness
    return harness.load_module(os.path.join(BENCH, "traffic", "train_indir.py"),
                               "traffic_train_indir")


def reader(name):
    from benchmark import harness
    return harness.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                               "metric_" + name.replace(".", "_")).read


class Crop:
    """Rows ``r0:r1`` and columns ``c0:c1`` of one view of a scene as a
    scene of one view: the principal point moves with the crop."""

    def __init__(self, scene, view, r0, r1, c0, c1):
        fx, fy, cx, cy = scene.intrinsics
        self.images = np.ascontiguousarray(scene.images[view:view + 1, r0:r1, c0:c1])
        self.poses = scene.poses[view:view + 1]
        self.intrinsics = (fx, fy, cx - c0, cy - r0)
        _, self.H, self.W, self.C = self.images.shape

    def __len__(self):
        return 1

    def device_images(self, device):
        return torch.from_numpy(self.images.reshape(1, self.H * self.W, self.C)).to(device)

    def epoch_order(self, rng):
        idx = np.arange(1)
        rng.shuffle(idx)
        return idx


_SCENE = {}


def crop():
    if not _SCENE:
        from benchmark.scene_nerf import NerfScene
        val = NerfScene(os.path.join(ROOT, "data", "synth_shiny3"), "val", 0.8)
        _SCENE["crop"] = Crop(val, 0, *CROP)
    return _SCENE["crop"]


def tiny_options(cell):
    return {**cell.options(), **TINY}


@contextlib.contextmanager
def planted(fault):
    """The program broken underneath the timed call, its files untouched:
    ``pass2_skipped`` returns a black, empty pass 2 (every ``r_images``
    zero); ``renv_left_out`` returns the specular colour without the renv
    branch; ``frozen_updated`` leaves ``frozen_mlps`` out of the optimizer's
    groups, so that Adam updates the colour heads; ``lr_doubled`` and
    ``update_dropped`` scale every update by 2 and by 0 (Adam's moments as
    they should be, the parameters moved twice as far or left as they
    were)."""
    import envidr_tpu_torch.models.network as network
    import envidr_tpu_torch.render.indirect as indirect
    import envidr_tpu_torch.train.trainer as trainer

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if fault == "pass2_skipped":
        orig = indirect.render_scene

        def render(net, opts, bitfield, rays_o, rays_d, bg_color, *a, **kw):
            out = orig(net, opts, bitfield, rays_o, rays_d, bg_color, *a, **kw)
            if opts.grad_ray:                  # pass 2, the reflected rays
                out = {**out, "image": out["image"] * 0.0,
                       "weights_sum": out["weights_sum"] * 0.0}
            return out
        patch(indirect, "render_scene", render)
    elif fault == "renv_left_out":
        def blend(self, c_env, head, r_images, roughness, blend_weight, aux):
            aux["renv_mask"] = torch.zeros_like(roughness[..., 0], dtype=torch.bool)
            return c_env
        patch(network.NeRFNetwork, "_blend_renv", blend)
    elif fault == "frozen_updated":
        patch(trainer, "frozen_modules", lambda opt, names=(): frozenset())
    elif fault in ("lr_doubled", "update_dropped"):
        decay = trainer.Adam.decay
        scale = 2.0 if fault == "lr_doubled" else 0.0
        patch(trainer.Adam, "decay", lambda self: decay(self) * scale)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def run_tiny(*, trace=False, fault=None, seed=SEED):
    """(result line, records) of one tiny CPU run of the cell on the crop."""
    from benchmark import harness, run

    torch.set_num_threads(2)
    cell = find(CELL)
    orig = harness.find_cell

    def small(n):
        c = orig(n)
        c.params.update(setup_steps=c.params["compare_steps"] + 1, warm_through_refresh=False)
        return c
    harness.find_cell = small
    try:
        with planted(fault):
            return run.run(CELL, seed, 0.5, trace, device=torch.device("cpu"),
                           options=tiny_options(cell), size=crop().H, scene=crop())
    finally:
        harness.find_cell = orig


def judged(seed, variant):
    from benchmark.control import judged as judge
    torch.set_num_threads(2)
    cell = find(CELL)
    return cell, judge(cell, seed, torch.device("cpu"), tiny_options(cell), crop().H, variant,
                       scene=crop())


def test_cell_files_found_by_name():
    cell = find(CELL)
    assert cell.kind == "train_indir" and cell.config["name"] == "synth_shiny3_indir"
    assert {m["name"] for m in cell.per_layer} == METRICS | REUSED
    assert {m["name"] for m in cell.end_to_end} == {"train_rays_per_s.cp", "setup_s"}
    assert cell.options()["num_rays"] == 12288
    p = cell.params
    assert os.path.exists(os.path.join(ROOT, p["checkpoint"]))
    assert os.path.exists(os.path.join(ROOT, p["scene"], "transforms_train.json"))
    assert set(p["limits"]) == {"loss_gap", "loss_gap_first", "grad_gap", "change_gap",
                                "renv_grad_zero", "frozen_moved"}
    assert p["limits"]["renv_grad_zero"] == p["limits"]["frozen_moved"] == 0.5
    o = cell.config["options"]
    widths = (o["hidden_dim_env"], o["num_layers_env"], o["sh_degree"], o["cp_rank"],
              o["num_levels"], o["geo_feat_dim"], o["env_feat_dim"], o["learn_indir_blend"])
    assert widths == (256, 4, 5, 32, 16, 12, 12, True) and cell.config["reduced"] == []


def test_scene_reader_reads_what_the_programs_loader_reads():
    from benchmark.scene_nerf import NerfScene
    from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
    root = os.path.join(ROOT, "data", "synth_shiny3")
    mine = NerfScene(root, "train", 0.8, downscale=10)
    theirs = NeRFDataset(root, "train", scale=0.8, downscale=10)
    assert mine.images.shape == (60, 40, 40, 4)
    assert np.array_equal(mine.images, theirs.images)
    assert np.array_equal(mine.poses, theirs.poses)
    assert mine.intrinsics == theirs.intrinsics


def test_start_draws_the_env_net_and_marks_unseen_cells():
    from benchmark.reference import indirect as ref
    from benchmark.reference import params_indirect
    cell = find(CELL)
    spec = ref.make_spec({**cell.options(), **cell.config["stated"]})
    names = [n for n, *_ in params_indirect.leaves(spec)]
    assert "renv_net.3.weight" in names and "sdf_net.2.bias" in names
    start = kind().make_start(cell, spec, SEED, torch.device("cpu"), crop())
    assert start.resumed and start.drawn == ["env_net"]
    assert tuple(start.params["env_net.0.weight"].shape) == (256, 72)
    assert tuple(start.params["sdf_net.2.weight"].shape) == (15, 64)
    assert tuple(start.params["renv_net.0.weight"].shape) == (64, 4)
    assert 0 < float((start.density < 0).float().mean()) < 1


TINY_CP = dict(encoding_pos="cp", num_levels=2, level_dim=2, cp_rank=4, hidden_dim=8,
               num_layers=2, geo_feat_dim=3, sh_degree=2, hidden_dim_env=5, num_layers_env=2,
               env_feat_dim=2, hidden_dim_diffuse=4, num_layers_diffuse=2,
               hidden_dim_color=6, num_layers_color=2)


def test_step_flops_by_hand():
    from benchmark import readers_indirect as r
    f = r.step_flops(TINY_CP)
    S = 2 * (36 + 8 + 16) + 2 * (4 * 8 + 8 * 5)          # CP encoder + SDF [4, 8, 5]
    C = 2 * 2 * (10 * 5 + 5 * 2)                         # env [10, 5, 2] twice
    D = 2 * (5 * 4 + 4 * 3)                              # diffuse [3 + 2, 4, 3]
    H = 2 * (9 * 6 + 6 * 3)                              # colour [3 + 3 + 2 + 1, 6, 3]
    R = 2 * (4 * 64 + 64 * 64 + 64 * 64 + 64 * 2)        # renv [4, 64, 64, 64, 2]
    assert (f["S"], f["C"], f["D"], f["H"], f["R"]) == (S, C, D, H, R)
    F2 = S + C + D + H
    assert f["pass1"] == 6 * S
    assert f["pass2"] == 3 * F2 + 3 * S - D - H
    assert f["pass3"] == 3 * (F2 + R + H) + 3 * S - D - 2 * H


def _snapshot(device=True):
    """Two traced steps: train_step > [indirect.geometry > render,
    indirect.reflect > render, indirect.main > render > color > renv]."""
    from envidr_tpu_torch import obs
    spans = []

    def add(name, parent, ms, step):
        root = len(spans) if parent is None else spans[parent].root
        depth = 0 if parent is None else spans[parent].depth + 1
        spans.append(obs.SpanRecord(name, parent, root, depth, step, 0, 0, 1,
                                    ms if device else None))
        return len(spans) - 1
    for step, (g, rf, m, rv) in enumerate([(80.0, 100.0, 110.0, 2.0), (84.0, 96.0, 90.0, 1.0)]):
        r = add("train_step", None, 400.0, step)
        add("render", add("indirect.geometry", r, g, step), g - 1, step)
        add("render", add("indirect.reflect", r, rf, step), rf - 1, step)
        add("renv", add("color", add("render", add("indirect.main", r, m, step), m - 1, step),
                        20.0, step), rv, step)
        spans[r].counters = {"indirect.rays": 100, "indirect.ref_rays": 40.0 + step,
                             "indirect.reflect.slots": 3200,
                             "indirect.reflect.samples": 600.0 + 100 * step,
                             "indirect.geometry.samples": 3000.0, "march.samples": 3000.0}
    return obs.Snapshot(spans, {})


def test_readers_on_a_synthetic_snapshot(monkeypatch):
    from envidr_tpu_torch import obs
    run = SimpleNamespace(kind="train", trace=object())
    monkeypatch.setattr(obs, "snapshot", lambda: _snapshot())
    assert reader("indirect_geometry_ms")(run) == pytest.approx(82.0)
    assert reader("indirect_reflect_ms")(run) == pytest.approx(98.0)
    assert reader("indirect_main_ms")(run) == pytest.approx(100.0)
    assert reader("renv_ms")(run) == pytest.approx(1.5)
    assert reader("indirect_ref_ray_share")(run) == pytest.approx(100.0 * 81 / 200)
    assert reader("indirect_reflect_slot_use")(run) == pytest.approx(100.0 * 1300 / 6400)
    monkeypatch.setattr(obs, "snapshot", lambda: _snapshot(device=False))
    assert reader("renv_ms")(run) is None                 # no card, no device ms
    assert reader("indirect_ref_ray_share")(run) == pytest.approx(40.5)


def test_readers_read_nothing_from_a_program_without_the_spans(monkeypatch):
    """The parent program has neither the passes' spans nor their counters:
    every new reader returns None, and none raises."""
    from envidr_tpu_torch import obs
    window = SimpleNamespace(wall_s=10.0, samples=1e6, steps=10)
    run = SimpleNamespace(kind="train", trace=object(), options=dict(TINY_CP), window=window)
    monkeypatch.setattr(obs, "snapshot", lambda: obs.Snapshot(
        [obs.SpanRecord("train_step", None, 0, 0, 0, 0, 0, 1, 300.0, counters={
            "march.samples": 3000.0, "march.slots": 6400})], {}))
    for name in METRICS:
        assert reader(name)(run) is None, name
    assert reader("mfu.shiny3_indir_train")(SimpleNamespace(kind="train", trace=None,
                                                            options=dict(TINY_CP),
                                                            window=window)) is None


def test_mfu_reader_counts_each_pass(monkeypatch):
    from benchmark import readers_indirect as r
    from envidr_tpu_torch import obs
    monkeypatch.setattr(obs, "snapshot", lambda: _snapshot())
    window = SimpleNamespace(wall_s=2.0, samples=1e6, steps=10)
    run = SimpleNamespace(kind="train", trace=object(), options=dict(TINY_CP), window=window)
    f = r.step_flops(TINY_CP)
    per = f["pass3"] + 6000 / 6000 * f["pass1"] + 1300 / 6000 * f["pass2"]
    assert reader("mfu.shiny3_indir_train")(run) == pytest.approx(
        100.0 * 1e6 * per / 2.0 / 67e12)


def test_reference_follows_the_program():
    """The program is correct at the committed limits, and on every gap
    lies ten times or more closer to the reference than the reference at
    TF32 does, on the same seed, with the renv gate open."""
    cell, got = judged(SEED, "program")
    assert got["correct"], got["checks"]
    _, tf32 = judged(SEED, "tf32")
    for k in ("loss_gap", "loss_gap_first", "grad_gap", "change_gap"):
        assert got[k] <= tf32[k] / 10, (k, got[k], tf32[k])


@pytest.mark.parametrize("variant,seed", [("tf32", SEED + 1), ("half_batch", SEED + 2)])
def test_control_fails(variant, seed):
    _, got = judged(seed, variant)
    assert not got["correct"], got["checks"]


def test_sound_run_is_correct_with_the_gate_open():
    line, records = run_tiny()
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_rays_per_s.cp", "setup_s"}
    detail = next(r for r in records if r.startswith("check detail:"))
    assert "'renv_moved': [True, True]" in detail        # the gate opened on both sides
    assert any("indir_ref=True grad_rays=True" in r for r in records)


@pytest.mark.parametrize("fault", ["pass2_skipped", "renv_left_out", "frozen_updated",
                                   "lr_doubled", "update_dropped"])
def test_fault_is_caught(fault):
    line, _ = run_tiny(fault=fault)
    assert not line["correct"], line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
    if fault in ("lr_doubled", "update_dropped"):
        # the first step's loss and gradient come before any update: only the
        # parameters' change sees the update
        over = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
        assert "change_gap" in over, line["checks"]


def test_traced_run_reports_the_counter_metrics():
    line, records = run_tiny(trace=True)
    assert line["correct"], line["checks"]
    # no device ms without a card: the counters' metrics, the FLOPs and the
    # host's readings
    assert set(line["metrics"]) == {"indirect_ref_ray_share", "indirect_reflect_slot_use",
                                    "mfu.shiny3_indir_train", "march_slot_use.cp",
                                    "host_syncs_per_step.cp", "trainer_host_ms.cp"}
    assert 0 < line["metrics"]["march_slot_use.cp"]["value"] <= 100
    assert 0 < line["metrics"]["indirect_ref_ray_share"]["value"] <= 100
    assert 0 < line["metrics"]["indirect_reflect_slot_use"]["value"] <= 100
    counters = next(r for r in records if r.startswith("trace counters"))
    assert "'renv.open'" in counters and "'indirect.ref_rays'" in counters


def test_reference_loads_nothing_of_the_program():
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c",
                          "import sys; sys.path.insert(0, '.')\n"
                          "import benchmark.reference.indirect, benchmark.reference.params_indirect\n"
                          "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(out.stdout.split())
    assert not mods & {"jax", "jaxlib", "flax", "envidr_tpu", "envidr_tpu_torch"}

"""The yardstick's arithmetic against hand counts: FLOPs a sample, the
scatter's bytes, the trace's busy time and gaps, the readers."""

import os
from types import SimpleNamespace

import pytest

from cpu_cells import BENCH


def reader(name):
    """The ``read`` of metric file ``name``."""
    from benchmark import harness
    return harness.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                               "metric_" + name.replace(".", "_")).read


def counts():
    from benchmark import readers
    return readers


TINY_CP = dict(encoding_pos="cp", num_levels=2, level_dim=2, cp_rank=4, hidden_dim=8,
               num_layers=2, geo_feat_dim=3, sh_degree=2, hidden_dim_env=5, num_layers_env=2,
               env_feat_dim=2, hidden_dim_diffuse=4, num_layers_diffuse=2,
               hidden_dim_color=6, num_layers_color=2)


def test_flops_per_sample_by_hand():
    f = counts().flops_per_sample(TINY_CP)
    # CP: per level 3 axes x 3 x rank(4) = 36, product 2 x 4 = 8, projection 2 x 4 x 2 = 16
    assert f["encoder"] == 2 * (36 + 8 + 16)
    # SDF net [4, 8, 1 + 3 + 1]: 2 x (4 x 8 + 8 x 5)
    assert f["sdf"] == 2 * (32 + 40)
    # IDE of degree 2: (2^2 - 1 + 2) x 2 = 10 inputs; env [10, 5, 2] twice,
    # diffuse [3 + 2, 4, 3], colour [3 + 3 + 2 + 1, 6, 3]
    env = 2 * (10 * 5 + 5 * 2)
    assert f["color"] == 2 * env + 2 * (5 * 4 + 4 * 3) + 2 * (9 * 6 + 6 * 3)
    assert f["forward"] == f["encoder"] + f["sdf"] + f["color"]
    assert f["step"] == 3 * f["forward"] + 3 * (f["encoder"] + f["sdf"])


def test_hash_encoder_flops_by_hand():
    o = dict(TINY_CP, encoding_pos="rolled_tiled")
    # per level: smoothstep 3 x 4, 8 corner weights x 2, 8 rows x 2 x C(2)
    assert counts().encoder_flops(o) == 2 * (12 + 16 + 32)


def test_mfu_reader():
    o = dict(TINY_CP)
    run = SimpleNamespace(kind="train", options=o,
                          window=SimpleNamespace(wall_s=2.0, samples=1e6))
    expect = 100.0 * 1e6 * counts().flops_per_sample(o)["step"] / 2.0 / 67e12
    for name in ("mfu.cp_train", "mfu.hash_train"):
        assert reader(name)(run) == pytest.approx(expect)
        assert reader(name)(SimpleNamespace(kind="render")) is None


def test_scatter_bytes_by_hand():
    r = counts()
    # the kernel table's row 1: L=16, B=262144, W=16, S=2^19 -> 0.2454 ms at 3.35 TB/s
    b = r.launch_bytes(16, 262144, 16, 2 ** 19)
    assert b == 16 * 262144 * 4 + 16 * 262144 * 64 + 16 * 2 ** 19 * 64
    assert b / 3.35e12 * 1e3 == pytest.approx(0.2454, abs=5e-5)


def _events(L, steps):
    """A launch = a memset then L level kernels; two launches a step."""
    ev, t = [], 0.0
    ev.append(("other", "kernel", t, t + 5.0))
    t += 10.0
    for _ in range(2 * steps):
        ev.append(("Memset (Device)", "gpu_memset", t, t + 1.0))
        t += 1.0
        for _ in range(L):
            ev.append(("void (anonymous namespace)::level_kernel<float, false>(...)", "kernel",
                       t, t + 2.0))
            t += 2.0
    return ev


def test_roofline_reader_counts_kernels_and_their_memsets():
    r, read = counts(), reader("scatter_add_rows_roofline")
    o = {"num_levels": 2, "level_dim": 2, "log2_hashmap_size": 4, "num_rays": 8}
    trace = SimpleNamespace(device_events=_events(2, 3))
    run = SimpleNamespace(kind="train", options=o, trace=trace, trace_ks=[4, 4, 2])
    t_us = 2 * 3 * (1.0 + 2 * 2.0)
    bound = sum(2 * r.launch_bytes(2, 8 * k, 16, 16) for k in (4, 4, 2)) / 3.35e12
    assert read(run) == pytest.approx(100.0 * bound / (t_us * 1e-6))
    run.trace_ks = [4, 4]               # a launch not accounted for: no reading
    assert read(run) is None


def test_reduce_trace_union_clip_and_gaps():
    from benchmark import harness
    base_us = 1000.0
    trace = {"baseTimeNanoseconds": base_us * 1e3, "traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5.0, "dur": 10.0},     # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "d", "ts": 95.0, "dur": 20.0},    # clipped at 100
    ]}
    spans = [("train_step", base_us - 5.0, base_us + 20.0),
             ("train_step_refresh", base_us + 20.0, base_us + 100.0)]
    tr = harness.reduce_trace(trace, base_us - 10.0, base_us + 100.0, spans)
    assert tr.window_s == pytest.approx(110e-6)
    assert tr.busy_s == pytest.approx((15.0 + 5.0 + 5.0) * 1e-6)
    gaps = dict((round(s * 1e6, 6), n) for n, s in tr.gaps)
    assert gaps == {10.0: "train_step", 15.0: "train_step_refresh",
                    60.0: "train_step_refresh"}
    assert tr.idle_gaps(1) == [["train_step_refresh", pytest.approx(60e-6)]]
    assert [n for n, _ in tr.device_ops()] == ["a", "b", "c", "d"][:4]


def test_idle_share_readers():
    tr = SimpleNamespace(busy_s=0.8, window_s=3.0)
    run = SimpleNamespace(kind="train", trace=tr, trace_ks=[32] * 16,
                          window=SimpleNamespace(wall_s=30.0, steps=300))
    # busy 50 ms a step against 100 ms a step untraced
    assert reader("device_idle_share.cp_train")(run) == pytest.approx(50.0)
    assert reader("device_idle_share.hash_train")(run) == pytest.approx(50.0)
    run.trace = None                    # the untraced run reads nothing
    assert reader("device_idle_share.cp_train")(run) is None


def test_step_readers():
    w = SimpleNamespace(step_ms=[10.0, 50.0, 12.0, 11.0, 70.0], refresh=[False, True, False,
                                                                         False, True],
                        host_ms=[1.0, 3.0, 2.0, 4.0, 5.0])
    run = SimpleNamespace(kind="train", window=w)
    for cell in ("cp", "hash"):
        assert reader(f"grid_refresh_step_ms.{cell}")(run) == 60.0
        assert reader(f"trainer_host_ms.{cell}")(run) == 3.0


def test_percentile_is_numpys_linear():
    import numpy as np
    from benchmark import harness
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0]
    for q in (5, 50, 95):
        assert harness.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))

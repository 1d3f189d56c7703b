"""bench_torch.py, the port's benchmark, run on the CPU through its function
at a tiny size: one JSON line with bench.py's keys."""

import importlib.util
import json
import os

import pytest

from test_torch_helpers import ROOT

KEYS = {"metric", "value", "unit", "vs_baseline", "config", "coarse_march",
        "eval_rays_per_sec"}
# synth_spheres_cp.ini cut to test size
TINY = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16,
            hidden_dim_color=16, hidden_dim_env=16)


def _bench():
    spec = importlib.util.spec_from_file_location("bench_torch",
                                                  os.path.join(ROOT, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config,coarse", [("synth_spheres_cp.ini", True),
                                           ("synth_spheres.ini", False)])
def test_bench_runs_on_cpu_and_reports_bench_keys(config, coarse):
    bench = _bench()
    out = bench.run(os.path.join(ROOT, "configs", config), num_rays=64, device="cpu",
                    warmup=1, steps=2, downscale=20, log2_hashmap_size=12, **TINY)
    assert set(out) == KEYS
    line = json.loads(json.dumps(out))
    assert line["metric"] == "train_rays_per_sec_fwd_bwd" and line["config"] == config
    assert line["coarse_march"] is coarse
    assert line["value"] > 0 and line["eval_rays_per_sec"] > 0
    assert bench.DEFAULT_CONFIG.endswith(os.path.join("configs", "synth_spheres_cp.ini"))

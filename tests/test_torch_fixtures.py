"""The port's dataset fixture (envidr_tpu_torch/data/fixtures.py) against
``tools/gen_synth_scene.py``, run at the same arguments: the same files,
JSON byte for byte and pixels equal; the resolution check of an existing
set; and the written set read back by the port's ``NeRFDataset``."""

import os
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest

from envidr_tpu_torch.data.fixtures import ensure_synth_spheres
from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from test_torch_helpers import ROOT

SIZE, N_TRAIN = 32, 3
PIXEL_ATOL = 0       # the same numpy renderer on the same machine: equal bytes


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixtures")
    ours, ref = str(root / "port"), str(root / "tool")
    assert ensure_synth_spheres(ours, size=SIZE, n_train=N_TRAIN) == ours
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "gen_synth_scene.py"), ref,
                    "--size", str(SIZE), "--n-train", str(N_TRAIN)], check=True,
                   capture_output=True, timeout=120)
    return ours, ref


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_fixture_writes_what_the_generator_writes(both):
    ours, ref = both
    assert _files(ours) == _files(ref)
    assert len([f for f in _files(ours) if f.startswith("train/")]) == N_TRAIN
    for name in _files(ref):
        a, b = os.path.join(ours, name), os.path.join(ref, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name
        else:
            x, y = imageio.imread(a), imageio.imread(b)
            assert x.dtype == y.dtype == np.uint8 and x.shape == y.shape == (SIZE, SIZE, 4)
            np.testing.assert_allclose(x, y, rtol=0, atol=PIXEL_ATOL, err_msg=name)


def test_existing_set_is_checked_not_rewritten(both):
    ours, _ = both
    before = {f: os.path.getmtime(os.path.join(ours, f)) for f in _files(ours)}
    assert ensure_synth_spheres(ours, size=SIZE, n_train=N_TRAIN) == ours
    assert before == {f: os.path.getmtime(os.path.join(ours, f)) for f in _files(ours)}
    with pytest.raises(RuntimeError, match=f"resolution {SIZE}px but 16px"):
        ensure_synth_spheres(ours, size=16, n_train=N_TRAIN)


def test_written_set_decodes_to_the_in_memory_scene(both):
    ours, _ = both
    for split in ("train", "val"):
        ds = NeRFDataset(ours, split, scale=0.33)
        mem = SynthSpheres(split, size=SIZE, n=N_TRAIN if split == "train" else None)
        np.testing.assert_array_equal(ds.images, mem.images)
        np.testing.assert_array_equal(ds.poses, mem.poses)
        assert ds.intrinsics == mem.intrinsics

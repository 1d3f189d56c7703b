"""The port's web viewer (``apps/viewer.py``): the cases of
``tests/test_viewer.py`` on a small port trainer on the CPU: a frame's PNG
and its train steps, the automatic budgets, and the HTTP round trip; the
PNGs read back by the port's decoder."""

import threading
import urllib.request

import numpy as np
import pytest

from envidr_tpu_torch.apps.viewer import ViewerState, make_handler
from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.data.png import decode
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import one_torch_thread_fixture

one_torch_thread = one_torch_thread_fixture()

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def tiny_opt(workspace: str):
    """``tests/test_trainer.py:tiny_opt`` for the port, with the constant
    march step the port marches (``dt_gamma`` 0) and no grid refresh in the
    viewer's train steps (a whole-grid sweep takes ~10 s on one CPU thread;
    the first train step makes one)."""
    return load_options(
        "", path="/tmp/none", workspace=workspace, num_rays=64,
        max_steps=32, early_stop_steps=8, iters=100, num_levels=4, level_dim=2,
        base_resolution=8, desired_resolution=32, log2_hashmap_size=10, hidden_dim=16,
        hidden_dim_color=16, hidden_dim_env=16, num_layers=2, num_layers_color=2,
        encoding_pos="rolled_tiled", use_sdf=True, eikonal_loss_weight=1e-3,
        mask_loss_weight=0.1, eval_ray_chunk=256, eval_samples_budget=16,
        update_extra_interval=1000, dt_gamma=0.0)


@pytest.fixture(scope="module")
def trainer_and_data(tmp_path_factory):
    opt = tiny_opt(str(tmp_path_factory.mktemp("viewer")))
    return Trainer(opt, network_config(opt), device="cpu"), opt, SynthSpheres("train", size=24, n=3)


@pytest.fixture
def state(trainer_and_data):
    """A fresh viewer (its budgets at their start) on the module's trainer."""
    return ViewerState(*trainer_and_data[:2], "scene", trainer_and_data[2])


def test_frame_png_and_train_steps(state):
    png, info = state.frame(35, -25, 3.2, 24, "image", 0, 0, 0)
    assert png[:8] == SIGNATURE and decode(png).shape == (24, 24, 3)
    step0, epoch0 = state.trainer.global_step, state.trainer.epoch
    png, info = state.frame(35, -25, 3.2, 24, "depth", 0, 30, 2)
    assert state.trainer.global_step == step0 + 2 and state.trainer.epoch == epoch0
    assert "loss" in info and decode(png).shape == (24, 24, 3)
    png, _ = state.frame(35, -25, 3.2, 24, "normal_image", 0, 0, 0)
    assert decode(png).std() > 0


def test_auto_budgets(state):
    """Dynamic resolution (200 ms) and dynamic train steps (500 ms), gui.py:109-161."""
    state.auto_base = 32             # keep the CPU renders tiny
    png, info = state.frame(35, -25, 3.2, "auto", "image", 0, 0, -1)
    assert png[:8] == SIGNATURE
    assert "(auto)" in info and "loss" in info
    assert 0.25 <= state.downscale <= 1.0
    assert 4 <= state.auto_train_steps <= 16
    d0 = state.downscale
    state.frame(35, -25, 3.2, "auto", "image", 0, 0, 0)
    assert 0.25 <= state.downscale <= max(d0, 1.0)


def test_http_roundtrip(state):
    from http.server import HTTPServer
    srv = HTTPServer(("127.0.0.1", 0), make_handler(state))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(base + "/", timeout=30).read()
        assert b"envidr_tpu_torch" in page
        png = urllib.request.urlopen(base + "/render?size=24&mode=normal_image",
                                     timeout=120).read()
        assert png[:8] == SIGNATURE
        img = decode(png)
        assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    finally:
        srv.shutdown()
        srv.server_close()

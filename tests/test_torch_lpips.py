"""The port's LPIPS (envidr_tpu_torch/train/lpips.py) and ``LPIPSMeter``
against the JAX package's: the untrained trunk bit-equal, the distance on
the same image pairs, JAX's own property tests (tests/test_lpips.py) on the
port, the meter's weight resolution, and ``Trainer.evaluate`` filling
``lpips``, ``lpips_kind`` and ``best_result_lpips``."""

import numpy as np
import pytest
import torch

from envidr_tpu.train.lpips import LPIPSJax
from envidr_tpu.train.lpips import init_random_weights as jax_init_random_weights
from envidr_tpu_torch.train import metrics
from envidr_tpu_torch.train.lpips import LPIPS, init_random_weights, load_torch_weights
from envidr_tpu_torch.train.metrics import LPIPSMeter
from test_torch_helpers import one_torch_thread_fixture

# relative: the same f32 convolutions (im2col against XLA's), other orders;
# readings 1.7e-7 (64x64) and 6.6e-7 (48x80)
LPIPS_RTOL = 1e-5
one_torch_thread = one_torch_thread_fixture()


def _img(seed, H=64, W=64):
    rng = np.random.default_rng(seed)
    x, y = np.linspace(0, 1, W), np.linspace(0, 1, H)
    base = np.stack(np.meshgrid(x, y), -1).sum(-1)[..., None] / 2.0
    return np.clip(base + 0.1 * rng.normal(size=(H, W, 3)), 0, 1).astype(np.float32)


def test_untrained_weights_are_jax_bit_for_bit():
    ours, ref = init_random_weights(3), jax_init_random_weights(3)
    assert ours.keys() == ref.keys()
    for k in ref:
        for name, a in ref[k].items():
            assert ours[k][name].dtype == a.dtype
            np.testing.assert_array_equal(ours[k][name], a)


@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_distance_matches_jax(shape):
    a, b = _img(10, *shape), _img(11, *shape)
    ref = LPIPSJax()(a, b)
    ours = LPIPS(device="cpu")
    assert ours.kind == "alex_untrained"
    assert ours(a, b) == pytest.approx(ref, rel=LPIPS_RTOL)
    assert ours(torch.from_numpy(a), torch.from_numpy(b)) == pytest.approx(ref, rel=LPIPS_RTOL)


def test_below_31_pixels_is_nan_as_in_jax():
    a, b = _img(1, 30, 40), _img(2, 30, 40)
    assert np.isnan(LPIPSJax()(a, b)) and np.isnan(LPIPS(device="cpu")(a, b))


# JAX's tests/test_lpips.py properties, on the port

def test_identical_images_zero():
    a = _img(0)
    assert LPIPS(device="cpu")(a, a) == 0.0


def test_perceptual_ordering():
    fn = LPIPS(device="cpu")
    a = _img(1)
    flat = a.reshape(-1, 3).copy()
    np.random.default_rng(2).shuffle(flat, axis=0)
    assert 0 < fn(a, np.clip(a + 0.05, 0, 1)) < fn(a, flat.reshape(a.shape))


def test_symmetry_and_determinism():
    fn = LPIPS(device="cpu")
    a, b = _img(3), _img(4)
    assert abs(fn(a, b) - fn(b, a)) < 1e-6
    assert abs(fn(a, b) - LPIPS(device="cpu")(a, b)) < 1e-6


def test_random_weights_shapes():
    p = init_random_weights()
    assert p["conv0"]["w"].shape == (64, 3, 11, 11)
    assert p["conv4"]["w"].shape == (256, 256, 3, 3)
    assert p["lin2"]["w"].shape == (384,)


def _write_alex_pth(path):
    sd = {}
    shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3),
              (256, 256, 3, 3)]
    g = torch.Generator().manual_seed(0)
    for li, shp in zip([0, 3, 6, 8, 10], shapes):
        sd[f"features.{li}.weight"] = torch.randn(shp, generator=g)
        sd[f"features.{li}.bias"] = torch.randn(shp[0], generator=g)
    for i, shp in enumerate(shapes):
        sd[f"lin{i}.model.1.weight"] = torch.rand((1, shp[0], 1, 1), generator=g)
    torch.save(sd, path)
    return sd


def test_load_torch_weights_roundtrip(tmp_path):
    path = str(tmp_path / "alex.pth")
    sd = _write_alex_pth(path)
    params = load_torch_weights(path)
    np.testing.assert_array_equal(params["conv1"]["w"], sd["features.3.weight"].numpy())
    np.testing.assert_array_equal(params["lin3"]["w"], sd["lin3.model.1.weight"].numpy().reshape(256))
    fn = LPIPS(weights_path=path, device="cpu")
    assert fn.kind == "alex"
    a, b = _img(7), _img(8)
    assert fn(a, a) == 0.0 and np.isfinite(fn(a, b)) and fn(a, b) > 0
    assert fn(a, b) == pytest.approx(LPIPSJax(weights_path=path)(a, b), rel=LPIPS_RTOL)


def test_meter_kind_and_weight_resolution(tmp_path, monkeypatch):
    """No lpips package here: the meter takes $ENVIDR_LPIPS_WEIGHTS, else
    assets/lpips_alex.pth, else the untrained trunk, as JAX's does."""
    monkeypatch.delenv("ENVIDR_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(metrics, "DEFAULT_LPIPS_WEIGHTS", str(tmp_path / "absent.pth"))
    m = LPIPSMeter(device="cpu")
    assert m.available and m.kind == "alex_untrained"
    v = m.update(_img(5), _img(6))
    assert np.isfinite(v) and m.measure() == v and m.N == 1
    m.clear()
    assert m.N == 0
    path = str(tmp_path / "alex.pth")
    _write_alex_pth(path)
    monkeypatch.setenv("ENVIDR_LPIPS_WEIGHTS", path)
    assert LPIPSMeter(device="cpu").kind == "alex"


def test_evaluate_fills_lpips(tmp_path):
    """``evaluate`` of a tiny CP trainer on two 32x32 views: ``lpips`` is the
    mean of the port's LPIPS of each clipped render and its composited
    ground truth (held to JAX's ``LPIPSJax`` on the same pairs)."""
    import dataclasses

    from envidr_tpu_torch.config import network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.parallel.tiny_step import tiny_options
    from envidr_tpu_torch.train.trainer import Trainer, eval_pair

    opt = dataclasses.replace(tiny_options(1), workspace=str(tmp_path), eval_ray_chunk=512)
    trainer = Trainer(opt, network_config(opt), device="cpu")
    trainer.update_extra_state()
    val = SynthSpheres("val", size=32, n=2)
    trainer.evaluate(val, max_images=2)
    r = trainer.stats["results"][-1]
    assert r["lpips_kind"] == "alex_untrained"
    ref = np.mean([LPIPSJax()(*eval_pair(trainer.render_view(val, i), val, i, opt))
                   for i in range(2)])
    assert r["lpips"] == pytest.approx(ref, rel=LPIPS_RTOL)
    assert trainer.stats["best_result_lpips"] == r["lpips"]
    assert (tmp_path / "checkpoints" / "best.ckpt").exists()

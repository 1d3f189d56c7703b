"""The port's training CLI (``apps/cli.py``) against the JAX package's, on
the CPU, on a small scene that both read from the same files (PNGs written
by the port's ``write_png``, ``transforms_*.json``):

* JAX's CLI trains an epoch and the port's ``--resume`` goes on to the
  second, and the reverse: each reads the other's checkpoint, resumes at its
  epoch and step, trains the epoch's order as JAX shuffles it, and returns
  the same averaged keys; ``args.json`` holds JAX's ``Options`` fields;
* the ``latest`` / ``best`` / emergency lookup, against JAX's, and the
  emergency checkpoint of an epoch that raises;
* ``--test``: its PSNR equals ``Trainer.evaluate``'s, its dumps and render;
* ``--swap_env``: the relit render against JAX's from the same checkpoint;
* a sphere-mode run's exported ``env_net_{i}.pth``, read by JAX's
  ``load_env_net``, equal to the EMA stack's rows;
* a generated set made in memory when its split file is absent, and any
  other missing path raising ``FileNotFoundError``.
"""

import dataclasses
import json
import os
import pickle
import re

import numpy as np
import pytest

from envidr_tpu_torch.apps import cli
from envidr_tpu_torch.data.png import read_png, write_png
from envidr_tpu_torch.data.synth_scene import render, split_poses
from test_torch_helpers import ROOT, f32_cp_encoder, one_torch_thread_fixture

one_torch_thread = one_torch_thread_fixture()

CP_INI = os.path.join(ROOT, "configs", "synth_spheres_cp.ini")
SPHERE_INI = os.path.join(ROOT, "configs", "neural_renderer_cp.ini")
ENV_NET = os.path.join(ROOT, "assets", "env_ckpts", "env_net_5.pth")
SIZE = 16
SPLITS = {"train": (4, 0), "val": (2, 1), "test": (2, 2)}
SMALL = dict(num_rays=64, cp_rank=4, num_levels=4, desired_resolution=64, hidden_dim=16,
             hidden_dim_color=16, hidden_dim_env=16, max_steps=64, early_stop_steps=16,
             eval_ray_chunk=256, update_extra_interval=100)
SETS = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]
# the relit render, port against JAX's jitted eval, the CP encoder in f32 in
# both: reading 2.0e-6 (mean 1.8e-7) over the 256 pixels of a scene trained
# for three epochs
SWAP_ATOL = 1e-4
EPOCH_LINE = re.compile(r"^\[ep +\d+\] loss=\d+\.\d{5} color=\d+\.\d{5} rays/s=\d+ K=\d+ "
                        r"mean_count=\d+\.\d t=\d+\.\ds$")


def write_scene(root: str):
    """The sphere scene of ``data/synth_scene.py`` at SIZE x SIZE, as
    ``tools/gen_synth_scene.py`` writes it."""
    focal = SIZE * 1.25
    for split, (n, seed) in SPLITS.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, c2w in enumerate(split_poses(n, seed)):
            write_png(os.path.join(root, split, f"r_{i}.png"), render(c2w, SIZE, SIZE, focal))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 2 * np.arctan(SIZE / (2 * focal)), "frames": frames}, f)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    write_scene(root)
    return root


class Recorder:
    """Wraps ``train_one_epoch`` of a Trainer class: each call's trainer,
    its returned averages, and (the port's) the frames its steps trained."""

    def __init__(self, monkeypatch, trainer_cls, port: bool):
        self.calls = []
        epoch, step = trainer_cls.train_one_epoch, getattr(trainer_cls, "train_step", None)
        rec = self

        def train_one_epoch(tr, *a, **kw):
            rec.frames = []
            out = epoch(tr, *a, **kw)
            rec.calls.append((tr, out, rec.frames))
            return out

        def train_step(tr, *a, **kw):
            out = step(tr, *a, **kw)
            rec.frames.append(out["index"])
            return out

        monkeypatch.setattr(trainer_cls, "train_one_epoch", train_one_epoch)
        if port:
            monkeypatch.setattr(trainer_cls, "train_step", train_step)


def run_cli(which: str, scene: str, workspace: str, *extra):
    args = ["--config", CP_INI, "--path", scene, "--workspace", workspace, *SETS, *extra]
    if which == "port":
        return cli.main(args + ["--device", "cpu"])
    from envidr_tpu.apps import cli as jax_cli
    return jax_cli.main(args)


@pytest.fixture(scope="module")
def resumed(scene, tmp_path_factory):
    """{first CLI: (workspace, JAX recorder, port recorder)}: the first CLI
    trains epoch 1, the other resumes for epoch 2."""
    from envidr_tpu.train.trainer import Trainer as JaxTrainer
    from envidr_tpu_torch.train.trainer import Trainer
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jrec, trec = Recorder(mp, JaxTrainer, False), Recorder(mp, Trainer, True)
        for first, second in (("jax", "port"), ("port", "jax")):
            ws = str(tmp_path_factory.mktemp(f"{first}_first"))
            run_cli(first, scene, ws, "--max-epochs", "1")
            run_cli(second, scene, ws, "--max-epochs", "2", "--resume")
            out[first] = (ws, list(jrec.calls), list(trec.calls))
            jrec.calls.clear()
            trec.calls.clear()
    return out


def jax_order(scene: str, epoch: int, seed: int = 0):
    from envidr_tpu.data.nerf_dataset import NeRFDataset as JaxNeRF
    ds = JaxNeRF(scene, "train", scale=0.8)
    return list(ds.epoch_order(np.random.default_rng(seed * 100003 + epoch)))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_the_two_clis(resumed, scene, first):
    ws, jcalls, tcalls = resumed[first]
    (jtr, javg, _), = jcalls
    (ttr, tavg, frames), = tcalls
    n = SPLITS["train"][0]
    first_tr, second_tr = (jtr, ttr) if first == "jax" else (ttr, jtr)
    assert (first_tr.epoch, first_tr.global_step) == (1, n)
    assert (second_tr.epoch, second_tr.global_step) == (2, 2 * n)
    # the port trained its epoch's order as JAX shuffles it
    port_epoch = 2 if first == "jax" else 1
    assert frames == jax_order(scene, port_epoch)
    assert set(javg) == set(tavg)
    assert all(np.isfinite(v) for v in tavg.values()) and tavg["notfinite"] == 0
    assert tavg["rays_per_sec"] == pytest.approx(SMALL["num_rays"] * n / tavg["time"])
    with open(os.path.join(ws, "checkpoints", "ep0002.ckpt"), "rb") as f:
        payload = pickle.load(f)
    assert (payload["epoch"], payload["global_step"]) == (2, 2 * n)
    assert len(payload["stats"]["loss"]) == 2
    lines = open(os.path.join(ws, "log.txt")).read().splitlines()
    port_lines = [l for l in lines if l.startswith("[ep ")]
    assert len(port_lines) == 2 and all(EPOCH_LINE.match(l) for l in port_lines), port_lines
    assert sum(l.startswith("[eval ep ") for l in lines) == 2
    assert os.path.exists(os.path.join(ws, "results", "final_rgb.png"))
    assert read_png(os.path.join(ws, "results", "final_rgb.png")).shape == (SIZE, SIZE, 3)


def test_epoch_orders_and_args_json_keys(resumed, scene):
    from envidr_tpu.config import Options as JaxOptions
    from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
    ds = NeRFDataset(scene, "train", scale=0.8)
    for epoch in (1, 2, 3):
        assert list(ds.epoch_order(np.random.default_rng(epoch))) == jax_order(scene, epoch)
    with open(os.path.join(resumed["port"][0], "args.json")) as f:
        keys = set(json.load(f))
    assert keys == {f.name for f in dataclasses.fields(JaxOptions)}


def test_checkpoint_lookup_matches_jax(scene, tmp_path):
    """``latest`` takes the last ``ep*`` file before any ``emergency_*``,
    ``best`` takes ``best.ckpt``; both packages load the same file; with no
    checkpoint both start fresh."""
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
    from envidr_tpu.train.trainer import Trainer as JaxTrainer
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer

    ws = str(tmp_path)
    keep = dict(SMALL, max_keep_ckpt=5)       # no rotation among the four files
    opt = load_options(CP_INI, workspace=ws, **keep)
    tr = Trainer(opt, network_config(opt), device="cpu")
    jopt = jax_load(CP_INI, workspace=ws, **keep)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=ws)
    with pytest.warns(UserWarning, match="starting fresh"):
        assert tr.load_checkpoint("latest") is False
    assert jt.load_checkpoint("latest") is False
    for epoch, name in ((9, "emergency_ep0009"), (1, None), (2, None), (5, "best")):
        tr.epoch = epoch
        tr.save_checkpoint(name=name)
    d = os.path.join(ws, "checkpoints")
    assert sorted(os.listdir(d)) == ["best.ckpt", "emergency_ep0009.ckpt", "ep0001.ckpt",
                                     "ep0002.ckpt"]
    for which, epoch in (("latest", 2), (None, 2), ("best", 5)):
        assert tr.load_checkpoint(which) and jt.load_checkpoint(which)
        assert tr.epoch == jt.epoch == epoch, which
    for name in ("ep0001.ckpt", "ep0002.ckpt"):
        os.remove(os.path.join(d, name))
    assert tr.load_checkpoint("latest") and jt.load_checkpoint("latest")
    assert tr.epoch == jt.epoch == 9


def test_an_epoch_that_raises_leaves_an_emergency_checkpoint(scene, tmp_path, monkeypatch):
    from envidr_tpu_torch.train.trainer import Trainer
    step = Trainer.train_step
    calls = []

    def failing(self, *a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected")
        return step(self, *a, **kw)

    monkeypatch.setattr(Trainer, "train_step", failing)
    with pytest.raises(RuntimeError, match="injected"):
        run_cli("port", scene, str(tmp_path), "--max-epochs", "1")
    assert os.listdir(tmp_path / "checkpoints") == ["emergency_ep0001.ckpt"]
    assert "[error] RuntimeError: injected" in (tmp_path / "log.txt").read_text()


def test_test_mode_psnr_equals_evaluate(resumed, scene):
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
    from envidr_tpu_torch.train.trainer import Trainer

    ws = resumed["jax"][0]
    psnr = run_cli("port", scene, ws, "--test", "--set", "test_ids=[1]", "--set", "test_skip=1")
    opt = load_options(CP_INI, workspace=ws, path=scene, test_skip=1, **SMALL)
    tr = Trainer(opt, network_config(opt), device="cpu")
    assert tr.load_checkpoint("latest") and tr.epoch == 2
    tr.update_extra_state(full=opt.extra_state_full_update)
    test_set = NeRFDataset(scene, "test", scale=opt.scale, test_skip=1)
    assert psnr == tr.evaluate(test_set, max_images=len(test_set), track_best=False, indices=[1])
    assert np.isfinite(psnr) and psnr > 5.0
    dumps = sorted(os.listdir(os.path.join(ws, "validation", "test")))
    assert dumps == ["001_normal.png", "001_rgb.png"]
    assert read_png(os.path.join(ws, "results", "test_0_rgb.png")).shape == (SIZE, SIZE, 3)
    assert "[test] PSNR = " in open(os.path.join(ws, "log.txt")).read()


def test_swap_env_matches_the_jax_render(resumed, scene):
    """``--test --swap_env`` runs and relights; the relit render of a test
    view from the same checkpoint (no grid refresh: one grid) equals JAX's."""
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
    from envidr_tpu.train.trainer import Trainer as JaxTrainer
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
    from envidr_tpu_torch.train.trainer import Trainer

    ws = resumed["port"][0]
    plain = run_cli("port", scene, ws, "--test")
    relit = run_cli("port", scene, ws, "--test", "--swap_env", ENV_NET)
    assert np.isfinite(relit) and relit != plain
    test_set = NeRFDataset(scene, "test", scale=0.8)
    args = (test_set.poses[0], test_set.intrinsics, SIZE, SIZE)
    with f32_cp_encoder():
        opt = load_options(CP_INI, workspace=ws, **SMALL)
        tr = Trainer(opt, network_config(opt), device="cpu")
        tr.load_checkpoint("latest")
        tr.swap_env_net(ENV_NET)
        ours = tr.render_image(*args)["image"]
        jopt = jax_load(CP_INI, workspace=ws, **SMALL)
        jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=ws)
        jt.load_checkpoint("latest")
        jt.swap_env_net(ENV_NET)
        ref = jt.render_image(*args)["image"]
    np.testing.assert_allclose(ours, ref, atol=SWAP_ATOL)
    assert ours.std() > 0.01


def write_env_sphere_set(root: str, n_envs: int):
    """A small env-sphere set in the layout of ``tools/gen_env_dataset.py``
    (random pixels: the run checks the flow and the export, not a fit)."""
    from envidr_tpu_torch.geometry.rays import pose_spherical
    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("val", 1)):
        frames = []
        for i in range(n):
            path = f"{split}_{i}.png"
            write_png(os.path.join(root, path),
                      rng.integers(0, 256, (SIZE, SIZE, 4), dtype=np.uint8))
            frames.append({"file_path": path, "env_image_name": f"env{i % n_envs}",
                           "roughness": 0.3, "metallic": 0.5, "color": [0.5, 0.6, 0.7, 1.0],
                           "transform_matrix": pose_spherical(40.0 * i, -30.0, 4.0).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames,
                       "env_images_names": [f"env{e}" for e in range(n_envs)]}, f)


def test_sphere_mode_run_exports_env_nets_that_jax_reads(tmp_path):
    from envidr_tpu.io.torch_import import load_env_net
    n_envs = 3
    data = tmp_path / "envs"
    data.mkdir()
    write_env_sphere_set(str(data), n_envs)
    ws = str(tmp_path / "ws")
    small = dict(SMALL, num_envs=n_envs, hidden_dim_env=16)
    cli.main(["--config", SPHERE_INI, "--path", str(data), "--workspace", ws,
              "--max-epochs", "1", "--device", "cpu",
              *[a for k, v in small.items() for a in ("--set", f"{k}={v}")]])
    with open(os.path.join(ws, "checkpoints", "ep0001.ckpt"), "rb") as f:
        env_nets = pickle.load(f)["ema"]["env_nets"]
    for e in range(n_envs):
        layers = load_env_net(os.path.join(ws, "env_ckpts", f"env_net_{e}.pth"))
        assert len(layers) == len(env_nets)
        for got, want in zip(layers, env_nets):
            np.testing.assert_array_equal(np.asarray(got["w"]), want["w"][e])
            np.testing.assert_array_equal(np.asarray(got["b"]), want["b"][e])
    assert "[export] 3 env ckpts" in open(os.path.join(ws, "log.txt")).read()


def test_generated_set_when_absent_and_other_paths_raise(tmp_path):
    from envidr_tpu_torch.config import load_options
    opt = load_options(CP_INI, path=str(tmp_path / "synth_spheres"))
    lines = []
    ds = cli.load_split(opt, "val", downscale=16, log=lines.append)
    assert (len(ds), ds.H, ds.W, ds.C) == (5, 25, 25, 4)
    assert lines and "made in memory" in lines[0]
    test = cli.load_split(opt, "test", downscale=16, test_skip=2, log=lines.append)
    assert len(test) == 3
    with pytest.raises(FileNotFoundError):
        cli.load_split(dataclasses.replace(opt, path=str(tmp_path / "elsewhere")), "val")

"""NeuS alpha (envidr_tpu_torch/ops/density.py), the parameter bridge's CP
and variance leaves, and one train step of a small CP + NeuS + coarse-march
model (configs/synth_spheres_cp.ini cut to test size) against the JAX
package on the same parameters and rays.

The step runs twice.  With the CP encoder in f32 (both packages'
``NetworkConfig.cp_spec`` patched here to ``compute_dtype='float32'``) it is
held against the jitted JAX step to f32 tolerances.  With the production bf16
encoder (trap C3) it is held against the JAX step compiled with XLA's
``xla_allow_excess_precision`` off (``jit_keeping_bf16``): by default XLA
drops bf16 roundings under ``jit``, and this step's gradients are so
sensitive to those roundings that the default-jitted and the op-by-op
(``jax.disable_jit``) JAX steps differ by 2-46% of each leaf's max (encoder
0.458, sdf_net 0.172, env_net 0.094, color_net 0.063, diffuse_net 0.021;
tests/cp_readings.py).  With excess precision off the JAX step rounds where
the op-by-op step and the port round, in a fifth of the op-by-op time.
A third run, in f32 on a sparser grid (8% of the cells occupied, so that
a third of the slots fill), packs the port's render (the encode, the
networks and their backward on the march's filled slots alone) and is held
against the dense JAX step on that grid to the same tolerances."""

import copy
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.models.network import init_network_params
from envidr_tpu.ops import density as jdens
from envidr_tpu.render.scene import SceneRenderOptions, render_scene
from envidr_tpu.train.losses import compute_losses
from envidr_tpu.train.schedules import resolve as jax_resolve
from envidr_tpu_torch import obs
from envidr_tpu_torch.config import load_options as torch_load, network_config as torch_netcfg
from envidr_tpu_torch.io.jax_params import load_jax_params
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.ops import density as tdens
from envidr_tpu_torch.ops.marching import PACK_ROWS
from envidr_tpu_torch.train.schedules import resolve
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import (CP_SMALL, ROOT, camera_rays, export_jax_layout,
                                f32_cp_encoder, jit_keeping_bf16, one_torch_thread_fixture,
                                rel_err)

one_torch_thread = one_torch_thread_fixture("function", autouse=False)
CP_INI = os.path.join(ROOT, "configs", "synth_spheres_cp.ini")
# synth_spheres_cp.ini cut to test size by CP_SMALL; the grid stays 128, so
# the coarse march runs (S = 8)
ALPHA_ATOL = 1e-6    # alphas in [0, 1], the same f32 expression
TERM_RTOL = 1e-4     # f32 loss terms over 64 rays x 32 samples
GRAD_RTOL = 1.3e-3   # f32 double backward, rel. to max (ROADMAP C-5)
# bf16 step against the JAX step that keeps its bf16 roundings: JAX rounds
# the second-order table-gradient partial sums to bf16 in more places than
# the port (tests/test_torch_cp.py), and the step amplifies them.  Readings
# (tests/cp_readings.py), max over each leaf's tensors, against the op-by-op
# step: encoder 7.3e-3, sdf_net 3.1e-3, color_net 2.7e-3, env_net 2.5e-3;
# against the one compiled without excess precision: encoder 7.3e-3, sdf_net
# 2.2e-4, env_net 1.2e-4; so 2^-6 leaves 2x room.
BF16_STEP_RTOL = 2.0**-6
K = 32
GLOBAL_STEP = 250    # cos_anneal_ratio 0.5 at cos_anneal_steps 500


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("with_normals", [True, False])
def test_neus_alpha_matches(ratio, with_normals):
    rng = np.random.default_rng(int(ratio * 10) + with_normals)
    sdf = rng.normal(0, 0.05, (200, 16)).astype(np.float32)
    dirs = rng.normal(size=(200, 16, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    grads = rng.normal(size=(200, 16, 3)).astype(np.float32)
    dists = rng.uniform(0.001, 0.02, (200, 16)).astype(np.float32)
    var = np.float32(0.45)
    kw = dict(cos_anneal_ratio=ratio)
    if with_normals:
        ref = jdens.neus_alpha(jnp.asarray(sdf), jnp.asarray(var), jnp.asarray(dirs),
                               jnp.asarray(dists), jnp.asarray(grads), **kw)
        ours = tdens.neus_alpha(torch.tensor(sdf), torch.tensor(var), torch.tensor(dirs),
                                torch.tensor(dists), torch.tensor(grads), **kw)
    else:
        ref = jdens.neus_alpha(jnp.asarray(sdf), jnp.asarray(var), dists=2.0 * 3**0.5 / 1024,
                               **kw)
        ours = tdens.neus_alpha(torch.tensor(sdf), torch.tensor(var), dists=2.0 * 3**0.5 / 1024,
                                **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ALPHA_ATOL)
    assert 0.0 < float(ours.mean()) < 1.0


def _cp_model(seed=0):
    jopt, topt = jax_load(CP_INI, **CP_SMALL), torch_load(CP_INI, **CP_SMALL)
    jcfg, tcfg = jax_netcfg(jopt), torch_netcfg(topt)
    params = jax.tree.map(np.asarray, init_network_params(jax.random.PRNGKey(seed), jcfg))
    return (jopt, jcfg, params), (topt, tcfg, load_jax_params(NeRFNetwork(tcfg), params))


def test_bridge_carries_cp_tables_and_variance():
    (_, _, params), (_, tcfg, net) = _cp_model(seed=3)
    names = {n for n, _ in net.named_parameters()}
    assert {"encoder.axes.0.0", "encoder.axes.3.2", "encoder.proj.3",
            "sdf_density.variance"} <= names and "sdf_density.beta" not in names
    back = export_jax_layout(net)
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        b = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        np.testing.assert_array_equal(np.asarray(a), b)
    assert float(net.sdf_density.variance.detach()) == float(params["sdf_density"]["variance"])
    bad = jax.tree.map(lambda a: a, params)
    bad["encoder"]["axes"][0] = bad["encoder"]["axes"][0][:2]     # a missing axis table
    with pytest.raises(ValueError, match="encoder"):
        load_jax_params(NeRFNetwork(tcfg), bad)
    bad = jax.tree.map(lambda a: a, params)
    bad["sdf_density"] = {"beta": np.float32(0.1)}
    with pytest.raises(ValueError, match="sdf_density"):
        load_jax_params(NeRFNetwork(tcfg), bad)


@pytest.fixture(scope="module", params=["float32", "bfloat16", "float32_packed"])
def cp_step(request):
    dtype, _, packed = request.param.partition("_")
    return cp_step_case(dtype, pack=bool(packed))


def cp_step_case(dtype: str, pack: bool = False):
    """The step with the CP encoder in ``dtype``: the JAX step jitted in f32,
    compiled keeping its roundings in bf16.  With ``pack`` the port's render
    packs its samples (``Trainer.packs`` forced on): the per-sample work
    runs on the march's filled slots alone, against JAX's dense step."""
    if dtype == "float32":
        with f32_cp_encoder():
            return _cp_step(jax.jit, pack)
    return _cp_step(jit_keeping_bf16, pack)


def _cp_step(jit, pack=False):
    (jopt, jcfg, params), (topt, tcfg, net) = _cp_model(seed=5)
    o, d = camera_rays(64, seed=4)
    rng = np.random.default_rng(5)
    pix = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=64) > 0.4).astype(np.float32)
    bg = np.ones((64, 3), np.float32)
    gt = (pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])).astype(np.float32)
    alpha = pix[:, 3].copy()
    # packed: 8% of the cells occupied, so that 1/3 of the slots fill (at 60%
    # every slot does)
    bits = np.random.default_rng(6).uniform(size=(1, 128 ** 3)) < (0.08 if pack else 0.6)
    jsched = jax_resolve(jopt, 1, GLOBAL_STEP)
    ropts = SceneRenderOptions(max_steps=jsched.max_steps, num_samples=K,
                               early_stop_steps=jsched.early_stop_steps,
                               dt_gamma=jopt.dt_gamma, T_thresh=jopt.T_thresh,
                               min_near=jopt.min_near, training=True,
                               cos_anneal_ratio=jsched.cos_anneal_ratio, coarse_march=True)
    aabb = jnp.asarray([-1.0] * 3 + [1.0] * 3)
    weights = {k: jnp.asarray(v) for k, v in jsched.weights.items()}

    def loss_fn(p):
        out = render_scene(p, jcfg, ropts, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(bg), aabb, cos_anneal_ratio=weights["_cos_anneal"])
        inv_s = jnp.clip(jnp.exp(p["sdf_density"]["variance"] * 10.0), 1e-6, 1e6)
        return compute_losses(out, jnp.asarray(gt), jsched.flags, weights,
                              neus_inv_s=inv_s, alpha_mask=jnp.asarray(alpha))

    jp = jax.tree.map(jnp.asarray, params)
    (jl, jterms), jgrads = jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    tr.grid = tr.grid._replace(bitfield=torch.from_numpy(bits))
    tr.packs = lambda flags: pack
    sched = resolve(topt, 1, GLOBAL_STEP)
    rows = obs.COUNTERS.get("march.pack.rows", 0)
    tl, out, tterms = tr.forward_loss(*(torch.from_numpy(a) for a in (o, d, gt, bg, alpha)),
                                      K=K, sched=sched)
    filled = int(out["mask"].sum())
    assert obs.COUNTERS.get("march.pack.rows", 0) - rows == (
        -(-filled // PACK_ROWS) * PACK_ROWS if pack else 0)
    if pack:        # empty slots left out
        assert 0 < filled < out["mask"].numel()
    tl.backward()
    return dict(jl=float(jl), jterms=jterms, jgrads=jax.tree.map(np.asarray, jgrads), tr=tr,
                tl=float(tl.detach()), tterms=tterms, out=out, ratio=sched.cos_anneal_ratio,
                dtype=tcfg.cp_spec.compute_dtype)


def test_cp_step_loss_terms_match(cp_step):
    c = cp_step
    assert c["ratio"] == 0.5
    assert set(c["tterms"]) == set(c["jterms"]) == {"color", "mask", "eikonal"}
    for k, v in c["jterms"].items():
        assert float(c["tterms"][k]) == pytest.approx(float(v), rel=TERM_RTOL), k
    assert c["tl"] == pytest.approx(c["jl"], rel=TERM_RTOL)
    assert int(c["out"]["counts"].sum()) > 0


@pytest.mark.parametrize("leaf", ["encoder", "sdf_density", "sdf_net", "diffuse_net",
                                  "color_net", "env_net"])
def test_cp_step_gradients_match(cp_step, leaf):
    ours = dict(jax.tree_util.tree_leaves_with_path(
        export_jax_layout(cp_step["tr"].net, grads=True)[leaf]))
    tol = GRAD_RTOL if cp_step["dtype"] == "float32" else BF16_STEP_RTOL
    errs = {}
    for path, a in jax.tree_util.tree_leaves_with_path(cp_step["jgrads"][leaf]):
        assert np.abs(a).max() > 0, path
        errs[jax.tree_util.keystr(path)] = rel_err(a, ours[path])
    assert max(errs.values()) <= tol, errs


# the 20 shipped configs, each trained from the first epoch at which every
# one of its scheduled terms is on: back-face and Cauchy from 40 and eikonal
# from 120 (r4_laplace_ref.ini), the beta cap held from 60 or 80, the beta
# floor from 150, the indirect pass and then grad rays (indir_ref_start_iter +
# grad_rays_start_iter + 1), the specular branch of the neural-renderer
# pretrain from color_net_start_iter (5); two views, so the third step starts
# the next epoch
TRAINED_CONFIGS = {
    "synth_spheres.ini": 1, "synth_spheres_sorted.ini": 1, "synth_spheres_cp.ini": 1,
    "synth_spheres_neus.ini": 1, "r4_laplace_betamin.ini": 151, "r4_laplace_ref.ini": 121,
    "synth_spheres_cp_laplace.ini": 81, "r4_laplace_cue.ini": 61, "r4_laplace_cue_cont.ini": 61,
    "synth_spheres_density.ini": 1, "scenes/synth_spheres_ours.ini": 1,
    "scenes/synth_shiny_ours.ini": 51, "scenes/shiny2_indir.ini": 76,
    "scenes/shiny3_indir.ini": 76, "scenes/shiny2_stack.ini": 18,
    "scenes/materials.ini": 241, "scenes/toaster.ini": 241,
    "neural_renderer_cp.ini": 5, "neural_renderer_synth.ini": 5, "neural_renderer_renv.ini": 1,
}
PRETRAIN = os.path.join(ROOT, "assets", "env_sphere_pretrain_best.ckpt")
RENV_PRETRAIN = os.path.join(ROOT, "assets", "renv_pretrain_best.ckpt")
# the hash configs' table cut as tests/test_torch_helpers.py cuts it; the
# scene configs load a pretrain's rendering MLPs (their own paths are under
# exps/, which is not in the repo): the interreflection scenes the renv
# pretrain's colour 28 -> 64 -> 64 -> 3, diffuse and renv nets
_RENV = dict(color_mlp_path=RENV_PRETRAIN, hidden_dim_color=64)
CONFIG_EXTRA = {
    "synth_spheres.ini": dict(log2_hashmap_size=12),
    "synth_spheres_sorted.ini": dict(log2_hashmap_size=12),
    "synth_spheres_density.ini": dict(log2_hashmap_size=12),
    "scenes/synth_spheres_ours.ini": dict(
        color_mlp_path=PRETRAIN, hidden_dim_color=64, hidden_dim_env=160),
    "scenes/synth_shiny_ours.ini": _RENV, "scenes/shiny2_indir.ini": _RENV,
    "scenes/shiny3_indir.ini": _RENV,
    # the ray-count schedules (2048 -> 4096 rays) cut to the test's 64 rays
    "scenes/shiny2_stack.ini": dict(_RENV, log2_hashmap_size=12, num_rays_sched=()),
    "scenes/materials.ini": dict(_RENV, log2_hashmap_size=12),
    "scenes/toaster.ini": dict(_RENV, log2_hashmap_size=12, num_rays_sched=()),
    "neural_renderer_synth.ini": dict(log2_hashmap_size=12),
    # the renv pretrain as the card runs it (ROADMAP A5): the CP pretrain
    # resumed whole (its 16 levels; its MLP widths), CP in place of the
    # shipped hashgrid_diff, which cannot take the CP tree
    # (test_shipped_renv_config_cannot_take_the_cp_pretrain)
    "neural_renderer_renv.ini": dict(color_mlp_path=PRETRAIN, encoding_pos="cp",
                                     num_levels=16, hidden_dim_color=64, hidden_dim_env=160),
}
# the sphere configs train on the env-sphere set, generated in memory
SPHERE_CONFIGS = ("neural_renderer_cp.ini", "neural_renderer_synth.ini",
                  "neural_renderer_renv.ini")
# the configs whose datasets the repo tracks read them through the port's
# loader at downscale 8 (two views); materials and toaster read datasets
# that are not in the repo and train on the in-memory sphere scene
TRACKED_DATA = ("scenes/synth_shiny_ours.ini", "scenes/shiny2_indir.ini",
                "scenes/shiny3_indir.ini", "scenes/shiny2_stack.ini")
_DATA = {}
# options of the shipped schema that the port refuses, on a config that
# trains, and the name each raises with: skip_layers, on which the JAX
# package's own SDF net fails (tests/test_torch_runtime_options.py)
UNPORTED_OPTIONS = {
    "skip_layers": (dict(skip_layers=(1,)), "skip_layers"),
}
# options that no shipped config sets, each on the CP config: the trainer
# takes three steps with it (their parity with JAX: test_torch_volsdf*.py,
# test_torch_runtime_options.py, test_torch_ours.py)
PORTED_OPTIONS = {
    "bg_radius": dict(bg_radius=2.0),
    "split_diffuse_env": dict(split_diffuse_env=True),
    # VolSDF's sampler reads the Laplace beta (NeuS has none, in JAX too)
    "error_bound_sample": dict(error_bound_sample=True, num_steps=32, use_neus_sdf=False),
    "patch_size": dict(patch_size=4),
    "center_crop": dict(center_crop=0.5),
    "image_batch": dict(image_batch=2),
    "dt_gamma": dict(dt_gamma=1.0 / 128),
    "numerical_normals": dict(numerical_normals=True),
    "geometric_init": dict(geometric_init=True),
    "roughness_layer": dict(ensemble_mlp=False),
}


def test_config_lists_cover_every_shipped_config():
    import glob
    shipped = {os.path.relpath(p, os.path.join(ROOT, "configs"))
               for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.ini"), recursive=True)}
    assert shipped == set(TRAINED_CONFIGS)
    assert (len(shipped), len(TRAINED_CONFIGS)) == (20, 20)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("config", sorted(TRAINED_CONFIGS))
def test_config_builds_a_trainer_and_takes_a_step(config):
    """Each config the port trains: a trainer on the CPU at small widths,
    three steps on the scene from the epoch at which all its scheduled terms
    are on, across an epoch boundary."""
    from envidr_tpu_torch.data.env_dataset import generate_env_sphere
    from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    opt = torch_load(os.path.join(ROOT, "configs", config),
                     **{**CP_SMALL, **CONFIG_EXTRA.get(config, {})})
    tr = Trainer(opt, torch_netcfg(opt), device="cpu")
    tr.epoch = TRAINED_CONFIGS[config] - 1
    frozen = {n: [p.detach().clone() for p in getattr(tr.net, n).parameters()]
              for n in tr.optimizer.frozen_names}
    first = {n: p.detach().clone() for n, p in tr.net.named_parameters()}
    if config in TRACKED_DATA:
        if opt.path not in _DATA:       # each scene decoded once a process
            _DATA[opt.path] = NeRFDataset(os.path.join(ROOT, opt.path), "train",
                                          scale=opt.scale, downscale=8)
        data = copy.copy(_DATA[opt.path])
        data.images, data.poses = data.images[:2], data.poses[:2]
    elif config in SPHERE_CONFIGS:
        data = generate_env_sphere("train", 2, size=40, env_res=8, with_renv=opt.train_renv,
                                   device="cpu")
    else:
        data = SynthSpheres("train", size=40, n=2, scale=opt.scale)
    ms = [tr.train_step(data) for _ in range(3)]
    assert all(np.isfinite(float(m["loss"])) for m in ms)
    assert tr.use_grid == (config not in SPHERE_CONFIGS)
    assert float(ms[0]["mean_count"]) > 0 if tr.use_grid else "mean_count" not in ms[0]
    assert int(tr.notfinite) == 0 and int(tr.applied_steps) == 3
    assert tr.epoch == TRAINED_CONFIGS[config] + 1
    flags = tr._sched.flags
    on = {"backsdf": flags.use_backsdf_loss, "cauchy": flags.use_cauchy_loss,
          "eikonal": flags.use_eikonal_loss}
    assert {k for k, v in on.items() if v} <= set(ms[-1])
    if config == "r4_laplace_ref.ini":
        assert on == {"backsdf": True, "cauchy": True, "eikonal": True}
        assert ms[-1]["K"] == 128                   # the early stop raised at epoch 40
    for n, ps in frozen.items():
        assert all(torch.equal(a, b) for a, b in zip(ps, getattr(tr.net, n).parameters())), n
    assert bool(frozen) == (config.startswith("scenes/") or opt.train_renv)
    if config in SPHERE_CONFIGS:           # every term and the specular branch on
        assert not tr._sched.diffuse_only and flags.use_sdf_loss == (not opt.train_renv)
        assert set(ms[-1]) >= ({"color"} if opt.train_renv
                               else {"color", "backsdf", "eikonal", "sdf"})
        moved = {n for n, p in tr.net.named_parameters()
                 if not torch.equal(p, first[n])}
        assert moved and all(n.startswith("renv_net") for n in moved) == opt.train_renv
    if opt.indir_ref_start_iter > 0:       # the three-pass render with grad rays
        assert tr._sched.indir_ref and tr._sched.grad_rays and tr.cfg.use_renv
        assert "renv_open" in ms[-1]
        assert (tr.error_map is not None) == opt.error_map


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("option", sorted(PORTED_OPTIONS))
def test_ported_option_builds_a_trainer_and_takes_a_step(option):
    """Each option: a trainer of the small CP config on the CPU, three steps
    on the sphere scene (two views, so the third starts epoch 2; with image
    batches of two each step is an epoch), finite, every update applied, and
    the option's own part in play."""
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.ops.marching import MARCH_PATHS
    opt = torch_load(CP_INI, **CP_SMALL, **PORTED_OPTIONS[option])
    tr = Trainer(opt, torch_netcfg(opt), device="cpu")
    data = SynthSpheres("train", size=40, n=2, scale=opt.scale)
    MARCH_PATHS.clear()
    ms = [tr.train_step(data) for _ in range(3)]
    assert all(np.isfinite(float(m["loss"])) for m in ms)
    assert int(tr.notfinite) == 0 and int(tr.applied_steps) == 3
    assert tr.epoch == (3 if option == "image_batch" else 2)
    names = {n for n, _ in tr.net.named_children()}
    own = {"bg_radius": "bg", "split_diffuse_env": "diffuse_env_net",
           "roughness_layer": "roughness_layer"}.get(option)
    assert own is None or (own in names and tr.net.get_submodule(own).parameters())
    if option == "error_bound_sample":       # no march, no mean count
        assert not MARCH_PATHS and "mean_count" not in ms[-1] and float(tr.mean_count) == -1.0
    elif option == "image_batch":            # two views a step: one epoch is one step
        assert all(isinstance(m["index"], tuple) and len(m["index"]) == 2 for m in ms)
    elif option == "dt_gamma":               # growing steps march the dense ladder
        assert MARCH_PATHS["dense"] == 3 and not MARCH_PATHS["coarse"]
    else:
        assert float(ms[-1]["mean_count"]) > 0


@pytest.mark.parametrize("option", sorted(UNPORTED_OPTIONS))
def test_unported_config_raises_naming_what_is_missing(option):
    extra, name = UNPORTED_OPTIONS[option]
    opt = torch_load(CP_INI, **CP_SMALL, **extra)
    with pytest.raises(NotImplementedError, match=re.escape(name)):
        Trainer(opt, torch_netcfg(opt), device="cpu")


def test_shipped_renv_config_cannot_take_the_cp_pretrain(tmp_path):
    """neural_renderer_renv.ini as shipped (hashgrid_diff) resuming ``all``
    from the CP pretrain: JAX takes the CP encoder tree as it is
    (``_merge_tolerant`` fails, trainer.py:190-203) and its first render then
    looks for the hash table that tree lacks; the port refuses at once,
    naming the encoder."""
    from envidr_tpu.train.trainer import Trainer as JaxTrainer
    kw = dict(color_mlp_path=PRETRAIN, log2_hashmap_size=12)
    jopt = jax_load(os.path.join(ROOT, "configs", "neural_renderer_renv.ini"),
                    workspace=str(tmp_path), **kw)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=str(tmp_path))
    assert set(jt.state["params"]["encoder"]) == {"axes", "proj"}
    with pytest.raises(KeyError, match="embeddings"):
        jt.render_image(np.eye(4, dtype=np.float32), (8.0, 8.0, 4.0, 4.0), 8, 8, mode="sphere",
                        material={"roughness": 0.3, "metallic": 0.5, "color": [0.5] * 3})
    opt = torch_load(os.path.join(ROOT, "configs", "neural_renderer_renv.ini"), **kw)
    with pytest.raises(ValueError, match="encoder"):
        Trainer(opt, torch_netcfg(opt), device="cpu")

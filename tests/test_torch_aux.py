"""The rest of the sphere-scene configs in the port against the JAX package:
the six auxiliary loss terms (``train/losses.py``), the render's loss
auxiliaries and stratified jitter, ``beta_cap_sched`` (the per-epoch
projection and the cap handed to the render and the loss), the geometric
cue, and one step of the density field (``use_sdf=False``).

CP configs run at test size (4 levels up to resolution 64, rank 8, width-16
MLPs) with the encoder in f32, held against the jitted JAX step (trap C3);
the density config is a hash config, cut as tests/test_torch_helpers.py
cuts synth_spheres.ini."""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.models.network import init_network_params
from envidr_tpu.render.scene import SceneRenderOptions as JaxRenderOptions
from envidr_tpu.render.scene import render_scene as jax_render
from envidr_tpu.ops.density import laplace_beta as jax_laplace_beta
from envidr_tpu.train import losses as jlosses
from envidr_tpu.train.schedules import resolve as jax_resolve
from envidr_tpu.train.trainer import Trainer as JaxTrainer
from envidr_tpu_torch.config import load_options as torch_load, network_config as torch_netcfg
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from envidr_tpu_torch.io.jax_params import load_jax_params
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.ops.grid import all_cell_coords
from envidr_tpu_torch.render.scene import SceneRenderOptions, render_scene
from envidr_tpu_torch.train import losses as tlosses
from envidr_tpu_torch.train import trainer as ttrainer
from envidr_tpu_torch.train.schedules import resolve
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import (ROOT, SMALL, camera_rays, export_jax_layout, f32_cp_encoder,
                                one_torch_thread_fixture, rel_err)

one_torch_thread = one_torch_thread_fixture()
CONFIGS = os.path.join(ROOT, "configs")
CUE_INI = os.path.join(CONFIGS, "r4_laplace_cue.ini")
REF_INI = os.path.join(CONFIGS, "r4_laplace_ref.ini")
DENSITY_INI = os.path.join(CONFIGS, "synth_spheres_density.ini")
CP_SMALL = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16,
                hidden_dim_color=16, hidden_dim_env=16, num_rays=64)
TERM_RTOL = 1e-4     # f32 loss terms over 64 rays x 32 samples
GRAD_RTOL = 1.3e-3   # f32 double backward, rel. to max (ROADMAP C-5)
# the jittered step: one hidden pre-activation in each of two colour-branch
# layers flips its ReLU between f32 and f64 in the port.  Readings
# (tests/ours_readings.py): port f32 against port f64 2.49e-3 (encoder),
# JAX f32 against port f64 4.8e-4, port against JAX 2.50e-3 (the plain step:
# 4.0e-5); 5e-3 leaves 2x room, as tests/test_torch_ours.py's RELU_FLIP_RTOL
RELU_FLIP_RTOL = 5e-3
# an auxiliary term's gradient with respect to its inputs: the same
# elementwise f32 expressions, one sum; readings (tests/ours_readings.py) at
# most 4.8e-7 of the max
AUX_GRAD_RTOL = 1e-5
RENDER_ATOL = 2e-4   # f32 render outputs, as tests/test_torch_render.py
# three cue steps, f32: readings (tests/ours_readings.py) 9.3e-8 on the last
# loss, 6.0e-8 on a parameter after the three Adam updates (lr 3e-3)
CUE_LOSS_RTOL = 1e-6
CUE_PARAM_ATOL = 1e-6
K = 32
AABB = [-1.0] * 3 + [1.0] * 3


def _cp_models(ini, seed, tmp_path=None, **extra):
    kw = {**CP_SMALL, **extra}
    jopt = jax_load(ini, **kw, **({"workspace": str(tmp_path)} if tmp_path else {}))
    topt = torch_load(ini, **kw)
    jcfg, tcfg = jax_netcfg(jopt), torch_netcfg(topt)
    params = _nonzero_head_biases(
        jax.tree.map(np.asarray, init_network_params(jax.random.PRNGKey(seed), jcfg)), seed)
    return (jopt, jcfg, params), (topt, tcfg, load_jax_params(NeRFNetwork(tcfg), params))


def _nonzero_head_biases(params, seed):
    """The SDF net's and the env net's output biases drawn U(-0.1, 0.1)
    instead of 0, so that no geo or env feature vector is exactly zero (a
    sample outside the CP grid, or one whose width-16 hidden layer is all
    ReLU-dead, gives one).  There the JAX package's unitNorm backward is
    0/0 and poisons the whole gradient with NaN, where the port (like
    torch's F.normalize) gives a finite one: test_zero_vector_gradient."""
    rng = np.random.default_rng(seed)
    for name in ("sdf_net", "env_net"):
        b = params[name][-1]["b"]
        params[name][-1]["b"] = rng.uniform(-0.1, 0.1, b.shape).astype(np.float32)
    return params


@pytest.mark.parametrize("where", ["unit_norm", "eikonal"])
def test_zero_vector_gradient(where):
    """A vector that is exactly zero: a feature vector under unitNorm, or the
    SDF gradient of a valid sample that lies outside the CP grid (the
    stratified jitter can move one there) under the eikonal term.  The JAX
    package's gradient there is NaN (``jnp.linalg.norm``'s backward at 0),
    which makes apply_if_finite skip the whole update; the port's is finite,
    as the reference's torch code (F.normalize, ``Tensor.norm``) gives it:
    ``c / eps`` through unitNorm, 0 through the eikonal norm.  Elsewhere the
    two agree."""
    from envidr_tpu.models.mlp import unit_norm as jax_unit_norm
    from envidr_tpu_torch.models.mlp import unit_norm
    n = 12 if where == "unit_norm" else 3
    x = np.zeros((2, n), np.float32)
    x[1] = np.linspace(-1, 1, n)
    c = np.random.default_rng(0).standard_normal((2, n)).astype(np.float32)
    t = torch.tensor(x, requires_grad=True)
    if where == "unit_norm":
        jg = jax.grad(lambda v: jnp.sum(jax_unit_norm(v) * c))(jnp.asarray(x))
        (unit_norm(t) * torch.from_numpy(c)).sum().backward()
        want0 = torch.nn.functional.normalize  # the reference's activation
        ref = torch.tensor(x, requires_grad=True)
        (want0(ref, dim=-1) * torch.from_numpy(c)).sum().backward()
        torch.testing.assert_close(t.grad, ref.grad, rtol=0, atol=0)
    else:
        flags = jlosses.LossFlags(use_eikonal_loss=True)
        img = np.zeros((2, 3), np.float32)

        def jl(g):
            out = {"image": jnp.asarray(img), "sdf_gradients": g[:, None, :],
                   "mask": jnp.ones((2, 1), bool)}
            return jlosses.compute_losses(out, jnp.asarray(img), flags, {"eikonal": 1.0})[0]

        jg = jax.grad(jl)(jnp.asarray(x))
        out = {"image": torch.from_numpy(img), "sdf_gradients": t[:, None, :],
               "mask": torch.ones((2, 1), dtype=torch.bool)}
        tlosses.compute_losses(out, torch.from_numpy(img), tlosses.LossFlags(
            use_eikonal_loss=True), {"eikonal": 1.0})[0].backward()
        assert (t.grad[0] == 0).all()
    jg = np.asarray(jg)
    assert np.isnan(jg[0]).all() and torch.isfinite(t.grad).all()
    np.testing.assert_allclose(t.grad[1].numpy(), jg[1], rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- loss terms

def _aux_outputs(seed=0, n=64, k=32):
    """Per-sample loss inputs of the shapes the render gives them."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(
        relsdf=f(n, k - 1) * 0.02, est_relsdf=f(n, k - 1) * 0.02,
        sdf_dist=np.abs(f(n, k - 1)) * 0.01, sdf_weights=rng.uniform(0, 0.2, (n, k - 1)
                                                                     ).astype(np.float32),
        cos=f(n, k - 1) * 0.5, sdfs=f(n, k) * 0.05,
        point_mask=rng.uniform(size=(n, k - 1)) > 0.2,
        roughness=rng.uniform(0.0, 0.2, (n, k, 1)).astype(np.float32),
        image=rng.uniform(size=(n, 3)).astype(np.float32))


# (flags, weights, sharpness): every term and mode of losses.py:102-178
AUX_CASES = {
    "relsdf_mean": (dict(use_relsdf_loss=True, relsdf_mode="mean"), "laplace"),
    "relsdf_sum": (dict(use_relsdf_loss=True, relsdf_mode="sum"), "laplace"),
    "dist_bound": (dict(use_dist_bound=True), "laplace"),
    "backsdf_sum": (dict(use_backsdf_loss=True, backsdf_mode="sum", backsdf_thresh=0.01),
                    "laplace"),
    "backsdf_mean": (dict(use_backsdf_loss=True, backsdf_mode="mean", backsdf_thresh=0.1),
                     "laplace"),
    "orientation": (dict(use_orientation_loss=True), "laplace"),
    "cauchy_laplace": (dict(use_cauchy_loss=True), "laplace"),
    "cauchy_laplace_undetached": (dict(use_cauchy_loss=True, cauchy_undetach_beta=True),
                                  "laplace"),
    "cauchy_neus_roughness_weighted": (dict(use_cauchy_loss=True,
                                            cauchy_roughness_weighted=True), "neus"),
    "entropy_laplace": (dict(use_entropy_loss=True), "laplace"),
    "entropy_neus": (dict(use_entropy_loss=True), "neus"),
}
AUX_WEIGHTS = dict(color=0.0, relsdf=0.7, dist_bound=1.3, backsdf=2.0, orientation=0.9,
                   cauchy=1.1, entropy=0.6)


@pytest.mark.parametrize("case", sorted(AUX_CASES))
def test_aux_term_matches(case):
    """One term and mode: its value and its gradients with respect to every
    input (and the sharpness, where it is not detached) against
    ``compute_losses`` of the JAX package on the same outputs."""
    c = aux_term_case(case)
    jterms, tterms = c["jterms"], c["tterms"]
    term = [t for t in jterms if t != "color"]
    assert len(term) == 1 and set(tterms) == set(jterms), (jterms, tterms)
    assert float(tterms[term[0]]) == pytest.approx(float(jterms[term[0]]), rel=TERM_RTOL)
    assert float(jterms[term[0]]) != 0.0
    assert c["tl"] == pytest.approx(c["jl"], rel=TERM_RTOL)
    for k, a in c["jgrads"].items():
        b = c["tgrads"][k]
        if np.abs(a).max() == 0:
            assert np.abs(b).max() == 0, k
        else:
            assert rel_err(a, b) <= AUX_GRAD_RTOL, k
    # the sharpness takes a gradient only where the Cauchy term undetaches it
    assert (float(c["jgrads"]["s"]) != 0.0) == AUX_CASES[case][0].get("cauchy_undetach_beta",
                                                                       False)


def aux_term_case(case):
    """Loss, terms and the gradients with respect to each input ("s" is the
    sharpness: beta or NeuS's inv_s) in both packages."""
    kw, sharp = AUX_CASES[case]
    outs = _aux_outputs(seed=len(case))
    gt = np.random.default_rng(1).uniform(size=(64, 3)).astype(np.float32)
    diff = ["relsdf", "est_relsdf", "sdf_dist", "sdf_weights", "cos", "sdfs", "image"]
    s0 = np.float32(0.03 if sharp == "laplace" else 60.0)

    def jax_loss(x):
        o = {**outs, **x}
        return jlosses.compute_losses(o, jnp.asarray(gt), jlosses.LossFlags(**kw), AUX_WEIGHTS,
                                      beta=x["s"] if sharp == "laplace" else None,
                                      neus_inv_s=x["s"] if sharp == "neus" else None,
                                      roughness=jnp.asarray(outs["roughness"]))

    jx = {k: jnp.asarray(outs[k]) for k in diff} | {"s": jnp.asarray(s0)}
    (jl, jterms), jg = jax.value_and_grad(jax_loss, has_aux=True)(jx)

    tx = {k: torch.tensor(outs[k], requires_grad=True) for k in diff}
    tx["s"] = torch.tensor(s0, requires_grad=True)
    o = {**{k: torch.from_numpy(np.asarray(v)) for k, v in outs.items()}, **tx}
    tl, tterms = tlosses.compute_losses(
        o, torch.from_numpy(gt), tlosses.LossFlags(**kw), AUX_WEIGHTS,
        beta=tx["s"] if sharp == "laplace" else None,
        neus_inv_s=tx["s"] if sharp == "neus" else None,
        roughness=torch.from_numpy(outs["roughness"]))
    tl.backward()
    return dict(jl=float(jl), jterms=jterms, tl=float(tl.detach()), tterms=tterms,
                jgrads={k: np.asarray(v) for k, v in jg.items()},
                tgrads={k: (torch.zeros_like(t) if t.grad is None else t.grad).numpy()
                        for k, t in tx.items()})


def test_sphere_surface_term_still_raises():
    """The sphere-surface term is JAX's: mean |surf_sdfs| at its weight.

    The name is a leftover: this test checked that the term raised while
    sphere mode was unported, and it keeps its name so that its record
    continues; it now holds the ported term to JAX and raises nothing."""
    rng = np.random.default_rng(9)
    img, gt = rng.uniform(size=(2, 8, 3)).astype(np.float32)
    surf = rng.normal(0, 0.1, 8).astype(np.float32)
    w = {"sdf": 0.1}
    jl, jterms = jlosses.compute_losses({"image": jnp.asarray(img), "surf_sdfs": jnp.asarray(surf)},
                                        jnp.asarray(gt), jlosses.LossFlags(use_sdf_loss=True), w)
    tl, tterms = tlosses.compute_losses({"image": torch.from_numpy(img),
                                         "surf_sdfs": torch.from_numpy(surf)},
                                        torch.from_numpy(gt), tlosses.LossFlags(use_sdf_loss=True), w)
    assert float(tterms["sdf"]) == pytest.approx(float(jterms["sdf"]), rel=1e-6)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)


# ------------------------------------------------ render: aux and jitter

@pytest.fixture(scope="module", params=["aux", "aux_stratified"])
def aux_render(request):
    with f32_cp_encoder():
        return _aux_render(request.param == "aux_stratified")


AUX_FLAGS = dict(use_relsdf_loss=True, use_dist_bound=True, use_orientation_loss=True,
                 use_entropy_loss=True)
AUX_ON = {"relsdf": 0.1, "dist_bound": 0.1, "orientation": 0.01, "entropy": 0.01}


def aux_inputs(stratified: bool):
    """r4_laplace_ref.ini at epoch 121 (back-face, Cauchy and eikonal terms
    on) with every auxiliary term switched on: the models, rays, targets,
    occupancy and the JAX package's sample jitter."""
    (jopt, jcfg, params), (topt, tcfg, net) = _cp_models(REF_INI, seed=21)
    o, d = camera_rays(64, seed=22)
    gt = np.random.default_rng(23).uniform(size=(64, 3)).astype(np.float32)
    # occupancy inside |x| < 0.87 only: no valid sample lies within a step of
    # the grid's edge, where the jitter would move it outside the CP grid
    # (an exactly-zero SDF gradient: test_zero_vector_gradient)
    cells = all_cell_coords(128).numpy()
    inner = ((cells >= 8) & (cells < 120)).all(axis=1)
    bits = (np.random.default_rng(24).uniform(size=(1, 128 ** 3)) < 0.6) & inner
    key = jax.random.PRNGKey(25)
    # the JAX render's jitter (scene.py:107-108), handed to the port
    strat = np.array(jax.random.uniform(jax.random.fold_in(key, 17), (64, K)))
    sched = resolve(topt, 121)
    kw = dict(max_steps=sched.max_steps, num_samples=K, early_stop_steps=sched.early_stop_steps,
              T_thresh=topt.T_thresh, min_near=topt.min_near, training=True,
              with_loss_aux=True, stratified_sampling=stratified)
    return dict(jopt=jopt, jcfg=jcfg, params=params, net=net, o=o, d=d, gt=gt, bits=bits,
                key=key, strat=strat, kw=kw, stratified=stratified,
                weights={**sched.weights, **AUX_ON},
                flags=dataclasses.replace(sched.flags, **AUX_FLAGS))


def aux_port_loss(net, c, dtype=torch.float32):
    """The port's render and loss of ``aux_inputs`` in ``dtype``."""
    from envidr_tpu_torch.ops.density import laplace_beta

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    out = render_scene(net, SceneRenderOptions(**c["kw"]), torch.from_numpy(c["bits"]),
                       t(c["o"]), t(c["d"]), 1.0, t(AABB),
                       strat_noise=t(c["strat"]) if c["stratified"] else None)
    beta = laplace_beta(net.sdf_density.beta, c["weights"]["_beta_min"], net.cfg.beta_max)
    loss, terms = tlosses.compute_losses(out, t(c["gt"]), c["flags"], c["weights"], beta=beta,
                                         roughness=out["roughness"])
    return loss, terms, out


def _aux_render(stratified: bool):
    """The render's outputs and the loss's gradients of ``aux_inputs`` in
    both packages."""
    c = aux_inputs(stratified)
    jcfg = c["jcfg"]
    jw = {k: jnp.asarray(v) for k, v in c["weights"].items()}
    jflags = dataclasses.replace(jax_resolve(c["jopt"], 121).flags, **AUX_FLAGS)

    def loss_fn(p):
        # no march perturbation in either package; the key draws the jitter
        out = jax_render(p, jcfg, JaxRenderOptions(**c["kw"]), jnp.asarray(c["bits"]),
                         jnp.asarray(c["o"]), jnp.asarray(c["d"]), 1.0, jnp.asarray(AABB),
                         key=c["key"])
        beta = jax_laplace_beta(p["sdf_density"], jw["_beta_min"], jcfg.beta_max)
        loss, terms = jlosses.compute_losses(out, jnp.asarray(c["gt"]), jflags, jw, beta=beta,
                                             roughness=out["roughness"])
        return loss, (terms, out)

    (jl, (jterms, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, c["params"]))
    tl, tterms, tout = aux_port_loss(c["net"], c)
    tl.backward()
    return dict(jl=float(jl), jterms=jterms, jout=jout, jgrads=jax.tree.map(np.asarray, jgrads),
                tl=float(tl.detach()), tterms=tterms, tout=tout, net=c["net"],
                stratified=stratified, inputs=c)


def test_aux_render_outputs_match(aux_render):
    j, t = aux_render["jout"], aux_render["tout"]
    np.testing.assert_array_equal(t["point_mask"].numpy(), np.asarray(j["point_mask"]))
    assert int(t["point_mask"].sum()) > 0
    for k in ("image", "relsdf", "est_relsdf", "cos", "sdf_weights", "sdf_dist", "sdfs"):
        np.testing.assert_allclose(t[k].detach().numpy(), np.asarray(j[k]), rtol=0,
                                   atol=RENDER_ATOL, err_msg=k)


def test_aux_render_loss_and_gradients_match(aux_render):
    c = aux_render
    assert set(c["tterms"]) == set(c["jterms"]) >= {"relsdf", "dist_bound", "backsdf",
                                                    "orientation", "cauchy", "entropy",
                                                    "eikonal"}
    for k, v in c["jterms"].items():
        assert float(c["tterms"][k]) == pytest.approx(float(v), rel=TERM_RTOL, abs=1e-9), k
    ours = export_jax_layout(c["net"], grads=True)
    tol = RELU_FLIP_RTOL if c["stratified"] else GRAD_RTOL
    for leaf in ("encoder", "sdf_density", "sdf_net", "color_net", "env_net", "diffuse_net"):
        mine = dict(jax.tree_util.tree_leaves_with_path(ours[leaf]))
        for path, a in jax.tree_util.tree_leaves_with_path(c["jgrads"][leaf]):
            assert rel_err(a, mine[path]) <= tol, (leaf, path)


def test_stratified_jitter_moves_samples_within_half_a_step():
    """The jitter alone: roll-differenced noise within +-0.5 dt_base on dts
    and along the ray on the positions; off at eval."""
    (_, _, _), (topt, tcfg, net) = _cp_models(REF_INI, seed=26)
    o, d = camera_rays(16, seed=27)
    bits = torch.ones((1, 128 ** 3), dtype=torch.bool)
    kw = dict(max_steps=512, num_samples=16, early_stop_steps=64, training=True,
              stratified_sampling=True)
    noise = torch.rand((16, 16), generator=torch.Generator().manual_seed(0))
    args = (bits, torch.from_numpy(o), torch.from_numpy(d), 1.0, torch.tensor(AABB))
    with torch.no_grad():
        plain = render_scene(net, SceneRenderOptions(**{**kw, "stratified_sampling": False}),
                             *args)
        jit = render_scene(net, SceneRenderOptions(**kw), *args, strat_noise=noise)
        off = render_scene(net, SceneRenderOptions(**{**kw, "training": False}), *args,
                           strat_noise=noise)
    dt_base = 2.0 * 3**0.5 / 512
    assert torch.equal(off["sdfs"], plain["sdfs"])
    moved = (jit["sdfs"] - plain["sdfs"]).abs()
    assert float(moved.max()) > 0 and torch.equal(jit["mask"], plain["mask"])
    strat = torch.roll((noise * 2 - 1) * 0.5 * dt_base, 1, dims=1) - (noise * 2 - 1) * 0.5 * dt_base
    assert float(strat.abs().max()) <= dt_base + 1e-9


# ----------------------------------------------------- beta_cap_sched

def test_beta_cap_projection_and_traced_cap_across_epochs(tmp_path, monkeypatch):
    """r4_laplace_cue.ini over epochs 1-2 (two views, two steps an epoch):
    at each epoch start the port projects beta under the epoch's cap as the
    JAX trainer does (the JAX step is replaced by one that records what it
    is given), and each step hands the cap to the render and the loss as a
    device tensor."""
    (jopt, jcfg, params), (topt, tcfg, net) = _cp_models(CUE_INI, seed=31, tmp_path=tmp_path)
    net.sdf_density.beta.data.fill_(0.5)                 # above every cap
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    seen = {"render": [], "loss": [], "beta": []}
    render, losses = ttrainer.render_scene, ttrainer.compute_losses

    def spy_render(net_, *a, beta_cap=None, **k):
        seen["render"].append(beta_cap)
        seen["beta"].append(float(net_.sdf_density.beta))
        return render(net_, *a, beta_cap=beta_cap, **k)

    def spy_losses(*a, beta=None, **k):
        seen["loss"].append(beta.detach().clone())
        return losses(*a, beta=beta, **k)

    monkeypatch.setattr(ttrainer, "render_scene", spy_render)
    monkeypatch.setattr(ttrainer, "compute_losses", spy_losses)
    ds = SynthSpheres("train", size=24, n=2, scale=topt.scale)
    betas_before_epoch = []
    for step in range(4):
        if step % 2 == 0:
            betas_before_epoch.append(float(tr.net.sdf_density.beta))
        tr.train_step(ds)
    assert tr.epoch == 2

    jt = JaxTrainer(jopt, jcfg, params=jax.tree.map(jnp.asarray, params), workspace=str(tmp_path))
    jseen = []

    def fake_step(state, batch, key, weights):
        jseen.append((np.float32(weights["_beta_cap"]),
                      np.float32(state["params"]["sdf_density"]["beta"])))
        return state, {"loss": jnp.zeros(()), "mean_count": jnp.ones(())}

    jt._get_train_step = lambda *a, **k: fake_step
    jt.update_extra_state = lambda *a, **k: None
    stub = SimpleNamespace(epoch_order=lambda rng: np.arange(2), device_images=jnp.zeros(
        (2, 1, 1, 4), jnp.uint8), device_poses=jnp.zeros((2, 4, 4)), intrinsics=(1, 1, 0, 0),
        H=1, W=1, C=4)
    for epoch, beta in enumerate(betas_before_epoch, start=1):
        sd = dict(jt.state["params"]["sdf_density"], beta=jnp.float32(beta))
        jt.state["params"] = dict(jt.state["params"], sdf_density=sd)
        jt.train_one_epoch(stub)
        cap, projected = jseen[-1]
        assert np.float32(seen["beta"][2 * (epoch - 1)]) == projected      # the projection
        assert projected <= cap < np.float32(beta)
        for step in (2 * epoch - 2, 2 * epoch - 1):                        # the traced cap
            t = seen["render"][step]
            assert isinstance(t, torch.Tensor) and t.dim() == 0
            assert np.float32(t) == cap
            want = min(np.float32(seen["beta"][step]), cap)                  # loss-side beta
            assert np.float32(seen["loss"][step]) == want
    assert jseen[0][0] > jseen[-1][0]                                        # annealing


# ------------------------------------------------------- geometric cue

def test_geometric_cue_three_steps_on_the_same_points(tmp_path):
    """Three cue steps of r4_laplace_cue.ini on the JAX run's own points:
    the losses, then the parameters after three steps of the main Adam (its
    counters advance), and the EMA set to the cued parameters."""
    c = cue_case(tmp_path)
    tr, losses = c["tr"], c["losses"]
    assert len(losses) == 3 and losses[0] > losses[-1]
    assert losses[-1] == pytest.approx(c["jloss"], rel=CUE_LOSS_RTOL)
    assert c["param_gap"] <= CUE_PARAM_ATOL
    assert c["unchanged"], "a net without cue gradients moved"
    assert int(tr.applied_steps) == 3 and int(c["jt"].state["opt_state"].total_notfinite) == 0
    for e, p in zip(tr.ema_net.parameters(), tr.net.parameters()):
        assert torch.equal(e, p)


def cue_case(tmp_path, P=4096):
    with f32_cp_encoder():
        (jopt, jcfg, params), (topt, tcfg, net) = _cp_models(CUE_INI, seed=41, tmp_path=tmp_path)
        jt = JaxTrainer(jopt, jcfg, params=jax.tree.map(jnp.asarray, params),
                        workspace=str(tmp_path))
        key, pts = jt.key, []
        for _ in range(3):                     # trainer.py:285-287's draws
            key, sub = jax.random.split(key)
            pts.append(np.asarray(jax.random.uniform(sub, (P, 3), minval=-jcfg.bound,
                                                     maxval=jcfg.bound)))
        jloss = jt.train_geometric_cue(steps=3, points=P)
        tr = Trainer(topt, tcfg, device="cpu", net=net)
        losses = tr.train_geometric_cue(steps=3, points=P, given_points=pts)
    ours = export_jax_layout(tr.net)
    jp = jax.tree.map(np.asarray, jt.state["params"])
    gap = max(float(np.abs(a - b).max()) for leaf in ("encoder", "sdf_net")
              for a, b in zip(jax.tree_util.tree_leaves(jp[leaf]),
                              jax.tree_util.tree_leaves(ours[leaf])))
    unchanged = all(np.array_equal(a, b) for name in ("color_net", "env_net", "diffuse_net",
                                                      "sdf_density")
                    for a, b in zip(jax.tree_util.tree_leaves(jp[name]),
                                    jax.tree_util.tree_leaves(ours[name])))
    return dict(jt=jt, tr=tr, jloss=float(jloss), losses=losses, param_gap=gap,
                unchanged=unchanged)


# ------------------------------------------------------- density field

def test_density_config_step_matches():
    """One step of synth_spheres_density.ini (use_sdf=False: a trunc_exp
    sigma head, normals from -grad sigma, sdfs = -sigma) on the hash path."""
    kw = {**SMALL}
    jopt, topt = jax_load(DENSITY_INI, **kw), torch_load(DENSITY_INI, **kw)
    jcfg, tcfg = jax_netcfg(jopt), torch_netcfg(topt)
    assert not jcfg.use_sdf and not tcfg.use_sdf
    params = _nonzero_head_biases(
        jax.tree.map(np.asarray, init_network_params(jax.random.PRNGKey(51), jcfg)), 51)
    emb = params["encoder"]["embeddings"]
    params["encoder"]["embeddings"] = np.random.default_rng(51).uniform(
        -0.1, 0.1, emb.shape).astype(np.float32)
    net = load_jax_params(NeRFNetwork(tcfg), params)
    o, d = camera_rays(64, seed=52)
    rng = np.random.default_rng(53)
    gt = rng.uniform(size=(64, 3)).astype(np.float32)
    alpha = (rng.uniform(size=64) > 0.4).astype(np.float32)
    bits = np.random.default_rng(54).uniform(size=(1, 128 ** 3)) < 0.6
    jsched = jax_resolve(jopt, 1)
    jw = {k: jnp.asarray(v) for k, v in jsched.weights.items()}
    ropts = dict(max_steps=jsched.max_steps, num_samples=K,
                 early_stop_steps=jsched.early_stop_steps, T_thresh=jopt.T_thresh,
                 min_near=jopt.min_near, training=True)

    def loss_fn(p):
        out = jax_render(p, jcfg, JaxRenderOptions(**ropts), jnp.asarray(bits), jnp.asarray(o),
                         jnp.asarray(d), 1.0, jnp.asarray(AABB))
        loss, terms = jlosses.compute_losses(out, jnp.asarray(gt), jsched.flags, jw,
                                             alpha_mask=jnp.asarray(alpha))
        return loss, (terms, out["sdfs"], out["normal_image"])

    (jl, (jterms, jsdfs, jnormals)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    tr.grid = tr.grid._replace(bitfield=torch.from_numpy(bits))
    tl, out, tterms = tr.forward_loss(
        *(torch.from_numpy(a) for a in (o, d, gt, np.ones((64, 3), np.float32), alpha)),
        K=K, sched=resolve(topt, 1))
    tl.backward()
    assert set(tterms) == set(jterms) == {"color", "mask"}
    for k, v in jterms.items():
        assert float(tterms[k]) == pytest.approx(float(v), rel=TERM_RTOL), k
    assert int(out["counts"].sum()) > 0
    for k, ref in (("sdfs", jsdfs), ("normal_image", jnormals)):      # sdfs = -sigma
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=RENDER_ATOL, err_msg=k)
    ours = export_jax_layout(tr.net, grads=True)
    for leaf in ("encoder", "sdf_net", "color_net", "env_net", "diffuse_net"):
        mine = dict(jax.tree_util.tree_leaves_with_path(ours[leaf]))
        for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                        jgrads[leaf])):
            assert np.abs(a).max() > 0, (leaf, path)
            assert rel_err(a, mine[path]) <= GRAD_RTOL, (leaf, path)
    # the grid's density is the sigma head itself
    x = torch.rand(100, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.no_grad():
        sig = tr.net.forward_geometry(x)["sigma"]
    assert (sig > 0).all() and "sdf" not in tr.net.forward_geometry(x)

"""Sphere mode of the port (``render/sphere.py``, material conditioning, the
stack of env nets, ``train_renv``) against the JAX package on the same
parameters, rays and materials, at small size:
``configs/neural_renderer_cp.ini`` cut to 4 CP levels of rank 8, width-16
MLPs and 2 env nets.

* ``render_sphere`` with the frequency and the CP encoder (f32): every
  output, and the gradients of a loss through the eikonal term's double
  backward and the sphere-surface samples;
* one sphere train step's loss at epoch 0 (``diffuse_only``: no roughness,
  no specular) and at epoch 5 (every term: colour, back-face, eikonal,
  sdf), the f32 step against the jitted JAX step and the bf16 CP step
  against the JAX step run op by op (under ``jit`` XLA drops the bf16
  roundings, trap C3);
* two Adam updates whose steps choose env net 1 and then 0: env net 1 takes
  a zero gradient in the second and moves by its first moment, as optax
  moves it;
* a ``train_renv`` step: ``renv_net`` alone moves, as optax moves it.

The readings behind the tolerances: ``python tests/sphere_readings.py``."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.models.network import init_network_params
from envidr_tpu.ops.density import laplace_beta
from envidr_tpu.render.sphere import SphereRenderOptions as JaxSphereOptions
from envidr_tpu.render.sphere import render_sphere as jax_render_sphere
from envidr_tpu.train.losses import compute_losses
from envidr_tpu.train.schedules import resolve as jax_resolve
from envidr_tpu.train.trainer import make_optimizer
from envidr_tpu_torch.config import load_options as torch_load, network_config as torch_netcfg
from envidr_tpu_torch.io.jax_params import load_jax_params, module_arrays
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.render.sphere import SphereRenderOptions, render_sphere
from envidr_tpu_torch.render.sphere_probe import (PROBE_MATERIAL, fit_sphere_sdf, probe_rays,
                                                 shell)
from envidr_tpu_torch.train.schedules import resolve
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import (ROOT, export_jax_layout, f32_cp_encoder,
                                one_torch_thread_fixture, rel_err)

one_torch_thread = one_torch_thread_fixture()
SPHERE_INI = os.path.join(ROOT, "configs", "neural_renderer_cp.ini")
RENV_INI = os.path.join(ROOT, "configs", "neural_renderer_renv.ini")
# neural_renderer_cp.ini cut to test size; two env nets
SPHERE_SMALL = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16,
                    hidden_dim_color=16, hidden_dim_env=16, num_envs=2, num_rays=64)
FREQ = dict(encoding_pos="frequency", multires=6)
N = 96
MATERIAL = PROBE_MATERIAL     # roughness, metallic, colour
# f32 outputs of the same expressions, rel. to each output's max; readings
# (tests/sphere_readings.py): surf_sdfs 6.8e-5 (CP), normal_image 4.9e-5
# (frequency), the rest below 4e-5; 2e-4 leaves 3x room
OUT_RTOL = 2e-4
GRAD_RTOL = 1.3e-3     # f32 double backward, rel. to max (ROADMAP C-5)
# the env nets' gradients of the frequency render: a ReLU pre-activation of
# the 160-wide layers within f32 noise of zero flips between the packages.
# Readings (tests/sphere_readings.py): 1.35e-3 with 4 torch threads, 1e-5 to
# 1e-3 with others; 5e-3 as tests/test_torch_ours.py's RELU_FLIP_RTOL
RELU_FLIP_RTOL = 5e-3
TERM_RTOL = 1e-4       # f32 loss terms
# the back-face term sums the samples whose SDF rises along the ray
# (relsdf > 0); a sample within f32 noise of 0 enters in one package and not
# the other.  Reading at epoch 5 (tests/sphere_readings.py): |port - JAX|
# 8.9e-8 on a term of 8.3e-7; 2e-7 leaves 2x room
BACKSDF_ATOL = 2e-7
# the bf16 CP step against the op-by-op JAX step (tests/test_torch_neus.py's
# bound for the scene step); reading (tests/sphere_readings.py): encoder
# 9.6e-3, the rest below 1.1e-6
BF16_STEP_RTOL = 2.0**-6
# one Adam update, rel. to its max (tests/test_torch_indir_ckpt.py)
UPDATE_RTOL = 5e-3
# an Adam update from the same gradients: f32 arithmetic in another order
# (reading, tests/sphere_readings.py: 6.9e-7)
SAME_GRAD_UPDATE_RTOL = 1e-5


def sphere_model(config=SPHERE_INI, seed=0, **extra):
    """The cut config in both packages with equal parameters: JAX's init,
    its SDF then fitted to the sphere (:func:`fit_sphere_sdf`)."""
    kw = {**SPHERE_SMALL, **extra}
    jopt, topt = jax_load(config, **kw), torch_load(config, **kw)
    jcfg, tcfg = jax_netcfg(jopt), torch_netcfg(topt)
    params = _fitted_params(config, seed, tuple(sorted(kw.items())))
    return (jopt, jcfg, params), (topt, tcfg, load_jax_params(NeRFNetwork(tcfg), params))


@functools.lru_cache(maxsize=None)
def _fitted_params(config, seed, kw):
    topt = torch_load(config, **dict(kw))
    jcfg = jax_netcfg(jax_load(config, **dict(kw)))
    params = jax.tree.map(np.asarray, init_network_params(jax.random.PRNGKey(seed), jcfg))
    net = load_jax_params(NeRFNetwork(torch_netcfg(topt)), params)
    fit_sphere_sdf(net, seed)
    return jax.tree.map(np.copy, export_jax_layout(net))


def model_rays(tcfg, seed, inside=True):
    """N probe rays for the port's config ``tcfg``: none grazes the sphere,
    none has a shell sample near a CP cell edge, and with ``inside`` none
    has one outside the bound [-1, 1]^3 (there the SDF gradient is the zero
    vector, whose norm's gradient is NaN in JAX:
    test_out_of_bound_samples_match_jax_outside_the_encoder).  With grazing
    rays the env nets' gradients of the frequency render differ by 3.0e-3
    of their max, without them by 1e-5 (tests/sphere_readings.py)."""
    scales = tcfg.cp_spec.scales if tcfg.encoding_pos == "cp" else ()
    return probe_rays(N, seed, inside=inside, cp_scales=scales)


def _jax_material(m):
    return {"roughness": float(m[0]), "metallic": float(m[1]), "color": jnp.asarray(m[2:5])}


def test_bridge_carries_the_env_net_stack():
    (_, _, params), (_, _, net) = sphere_model(seed=1)
    assert net.env_nets[0].weight.shape == (2, 16, 38)
    back = export_jax_layout(net)
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(a, dict(jax.tree_util.tree_leaves_with_path(back))[path])


RENDER_KEYS = ("image", "depth", "weights_sum", "normal_image", "diffuse_image",
               "specular_image", "roughness_image", "sdfs", "sigmas", "surf_sdfs", "relsdf",
               "sdf_weights", "sdf_dist", "cos", "sdf_gradients")


def _render_pair(encoder: dict, training: bool, seed: int = 2):
    """The same sphere render in both packages: (JAX outputs, port outputs,
    JAX gradients, port net) of ``sum(image * w) + 0.05 eikonal +
    sum(surf_sdfs)``."""
    (_, jcfg, params), (_, tcfg, net) = sphere_model(seed=seed, **encoder)
    o, d = model_rays(tcfg, seed)
    w = np.random.default_rng(seed).normal(size=(N, 3)).astype(np.float32)
    kw = dict(num_step=12, step_size=0.002, radius=0.95, training=training,
              with_surf_sdf=True, with_backsdf=True)

    def loss_of(out, norm, total, wt):
        eik = ((norm(out["sdf_gradients"]) - 1.0) ** 2).mean()
        return total(out["image"] * wt) + 0.05 * eik + total(out["surf_sdfs"])

    def jloss(p):
        out = jax_render_sphere(p, jcfg, JaxSphereOptions(**kw), jnp.asarray(o), jnp.asarray(d),
                                1.0, material=_jax_material(MATERIAL), env_index=1)
        return loss_of(out, lambda g: jnp.linalg.norm(g, axis=-1), jnp.sum, jnp.asarray(w)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tout = render_sphere(net, SphereRenderOptions(**kw), torch.from_numpy(o), torch.from_numpy(d),
                         1.0, material=torch.from_numpy(MATERIAL), env_index=1)
    loss_of(tout, lambda g: torch.linalg.vector_norm(g, dim=-1), torch.sum,
            torch.from_numpy(w)).backward()
    return jout, tout, jax.tree.map(np.asarray, jgrads), net


@pytest.fixture(scope="module", params=["frequency", "cp"])
def render_pair(request):
    if request.param == "frequency":
        return _render_pair(FREQ, True)
    with f32_cp_encoder():
        return _render_pair({}, True)


def test_render_sphere_outputs_match(render_pair):
    jout, tout, _, _ = render_pair
    # normals are compared where the surface contributes (a near-zero
    # weight's composite normal is normalised noise), the SDF's differences
    # against the SDF's own scale
    solid = tout["weights_sum"].detach().numpy() > 1e-3
    for key in RENDER_KEYS:
        a, b = np.asarray(jout[key]), tout[key].detach().numpy()
        assert a.shape == b.shape, key
        if key == "normal_image":
            a, b = a[solid], b[solid]
        scale = np.abs(np.asarray(jout["sdfs"])).max() if key == "relsdf" else np.abs(a).max()
        err = np.abs(a - b).max() / scale
        assert err <= OUT_RTOL, (key, err)
    mask = tout["mask"].numpy()
    np.testing.assert_array_equal(np.asarray(jout["mask"]), mask)
    assert mask.any() and not mask.all()


def test_render_sphere_gradients_match(render_pair):
    _, _, jgrads, net = render_pair
    ours = export_jax_layout(net, grads=True)
    errs = {}
    for path, a in jax.tree_util.tree_leaves_with_path(jgrads):
        b = dict(jax.tree_util.tree_leaves_with_path(ours))[path]
        assert np.isfinite(a).all() and np.isfinite(b).all(), path
        errs[jax.tree_util.keystr(path)] = rel_err(a, b)
    for k, e in errs.items():
        assert e <= (RELU_FLIP_RTOL if k.startswith("['env_nets']") else GRAD_RTOL), (k, errs)
    # the env net this render did not choose takes an exactly-zero gradient
    assert all(float(layer.weight.grad[0].abs().max()) == 0.0 for layer in net.env_nets)
    assert all(float(layer.weight.grad[1].abs().max()) > 0.0 for layer in net.env_nets)


def _step_inputs(seed, tcfg):
    o, d = model_rays(tcfg, seed)
    rng = np.random.default_rng(seed)
    pix = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=N) > 0.4).astype(np.float32)
    bg = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    gt = (pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])).astype(np.float32)
    r_img = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return o, d, gt, bg, pix[:, 3].copy(), r_img


def jax_sphere_loss(jopt, jcfg, jsched, inputs, env_index, material=MATERIAL, with_r=False):
    """The sphere branch of the JAX train step's loss (``trainer.py:506-534``)
    on given rays, without the shell's jitter."""
    o, d, gt, bg, alpha, r_img = (jnp.asarray(a) for a in inputs)
    cfg = dataclasses.replace(jcfg, diffuse_only=True) if jsched.diffuse_only else jcfg
    flags = jsched.flags
    ropts = JaxSphereOptions(num_step=12, step_size=0.002, radius=jopt.env_sph_radius,
                             perturb=True, training=True, with_surf_sdf=flags.use_sdf_loss,
                             with_backsdf=flags.use_backsdf_loss or flags.use_eikonal_loss)
    weights = {k: jnp.asarray(v) for k, v in jsched.weights.items()}

    def loss_fn(p):
        out = jax_render_sphere(p, cfg, ropts, o, d, bg, material=_jax_material(material),
                                env_index=env_index, r_images=r_img if with_r else None)
        beta = laplace_beta(p["sdf_density"], weights["_beta_min"], cfg.beta_max)
        return compute_losses(out, gt, flags, weights, beta=beta, alpha_mask=alpha,
                              roughness=out.get("roughness"))
    return loss_fn


def _sphere_step(epoch: int, jit):
    (jopt, jcfg, params), (topt, tcfg, net) = sphere_model(seed=5)
    inputs = _step_inputs(5, tcfg)
    jsched = jax_resolve(jopt, epoch, 0)
    loss_fn = jax_sphere_loss(jopt, jcfg, jsched, inputs, env_index=1)
    (jl, jterms), jgrads = jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    sched = resolve(topt, epoch, 0)
    t = [torch.from_numpy(a) for a in inputs]
    tl, out, tterms = tr.forward_loss(*t[:5], K=0, sched=sched,
                                      material=torch.from_numpy(MATERIAL),
                                      env_index=torch.tensor(1))
    tl.backward()
    return dict(jl=float(jl), jterms=jterms, jgrads=jax.tree.map(np.asarray, jgrads), tr=tr,
                tl=float(tl.detach()), tterms=tterms, out=out, sched=sched,
                dtype=tcfg.cp_spec.compute_dtype)


def sphere_step_case(epoch: int, dtype: str):
    if dtype == "float32":
        with f32_cp_encoder():
            return _sphere_step(epoch, jax.jit)
    with jax.disable_jit():
        return _sphere_step(epoch, lambda f: f)


@pytest.fixture(scope="module", params=[(0, "float32"), (5, "float32"), (5, "bfloat16")],
                ids=lambda p: f"epoch{p[0]}-{p[1]}")
def sphere_step(request):
    return sphere_step_case(*request.param)


def test_sphere_step_loss_terms_match(sphere_step):
    c = sphere_step
    # epoch 0 renders the diffuse term alone: no specular image
    assert c["sched"].diffuse_only == ("specular_image" not in c["out"])
    assert set(c["tterms"]) == set(c["jterms"]) == {"color", "backsdf", "eikonal", "sdf"}
    tol = TERM_RTOL if c["dtype"] == "float32" else BF16_STEP_RTOL
    for k, v in c["jterms"].items():
        atol = BACKSDF_ATOL if k == "backsdf" else 0.0
        assert float(c["tterms"][k]) == pytest.approx(float(v), rel=tol, abs=atol), k
    assert c["tl"] == pytest.approx(c["jl"], rel=tol)


def test_sphere_step_gradients_match(sphere_step):
    c = sphere_step
    ours = export_jax_layout(c["tr"].net, grads=True)
    tol = GRAD_RTOL if c["dtype"] == "float32" else BF16_STEP_RTOL
    errs = {}
    for path, a in jax.tree_util.tree_leaves_with_path(c["jgrads"]):
        b = dict(jax.tree_util.tree_leaves_with_path(ours))[path]
        assert np.isfinite(a).all() and np.isfinite(b).all(), path
        errs[jax.tree_util.keystr(path)] = rel_err(a, b)
    assert max(errs.values()) <= tol, errs
    # diffuse_only: the colour net takes no gradient in either package
    spec = max(float(np.abs(l["w"]).max()) for l in c["jgrads"]["color_net"])
    assert (spec == 0.0) == c["sched"].diffuse_only


def _updates(config, extra, env_order, with_r=False, jax_grads=False):
    """Adam updates of the port's trainer and of the JAX package's optax
    chain, one per entry of ``env_order`` (the step's env net), each from its
    own package's gradients or, with ``jax_grads``, both from JAX's:
    [(JAX params after, port params after)] in the JAX layout."""
    (jopt, jcfg, params), (topt, tcfg, net) = sphere_model(config, seed=7, **extra)
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    tx = make_optimizer(params, jopt)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    out = []
    for i, env in enumerate(env_order):
        inputs = _step_inputs(10 + i, tcfg)
        jsched = jax_resolve(jopt, 5, i)
        loss_fn = jax_sphere_loss(jopt, jcfg, jsched, inputs, env_index=env, with_r=with_r)
        grads = jax.jit(jax.grad(lambda p: loss_fn(p)[0]))(jp)
        upd, state = tx.update(grads, state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        if jax_grads:
            with torch.no_grad():
                for name, module in tr.net.named_children():
                    for p, g in zip(module.parameters(), module_arrays(module, grads[name])):
                        p.grad = torch.from_numpy(np.array(g, np.float32))
        else:
            t = [torch.from_numpy(a) for a in inputs]
            loss, _, _ = tr.forward_loss(*t[:5], K=0, sched=resolve(topt, 5, i),
                                         material=torch.from_numpy(MATERIAL),
                                         env_index=torch.tensor(env),
                                         r_images=t[5] if with_r else None)
            loss.backward()
        tr._apply_update()
        out.append((jax.tree.map(np.asarray, jp), jax.tree.map(np.copy, export_jax_layout(tr.net))))
    return params, out, tr


def test_an_env_net_not_chosen_moves_by_its_first_moment_as_in_optax():
    """Both optimizers take JAX's gradients: Adam turns each entry's gradient
    into a step of about its learning rate whatever its size, so entries
    whose gradients are at f32 noise would step in noise's direction."""
    with f32_cp_encoder():
        params, steps, tr = _updates(SPHERE_INI, {}, [1, 0], jax_grads=True)
    (j1, t1), (j2, t2) = steps
    for i in range(len(params["env_nets"])):
        for k in ("w", "b"):
            # step 2 chose env 0: env 1's gradient is zero, its moment not
            ju = j2["env_nets"][i][k][1] - j1["env_nets"][i][k][1]
            tu = t2["env_nets"][i][k][1] - t1["env_nets"][i][k][1]
            assert np.abs(ju).max() > 0.0
            assert rel_err(ju, tu) <= SAME_GRAD_UPDATE_RTOL, (i, k, rel_err(ju, tu))
            # step 1 chose env 1: env 0 had no moment and stayed
            np.testing.assert_array_equal(t1["env_nets"][i][k][0], params["env_nets"][i][k][0])
    assert int(tr.applied_steps) == 2 and int(tr.notfinite) == 0


def test_train_renv_step_moves_renv_net_alone_as_in_optax():
    with f32_cp_encoder():
        params, [(jnew, tnew)], tr = _updates(RENV_INI, dict(encoding_pos="cp", color_mlp_path=""), [1],
                                              with_r=True)
    assert tr.optimizer.frozen_names == {n for n, _ in tr.net.named_children()} - {"renv_net"}
    for name in params:
        for path, a in jax.tree_util.tree_leaves_with_path(params[name]):
            j = dict(jax.tree_util.tree_leaves_with_path(jnew[name]))[path]
            t = dict(jax.tree_util.tree_leaves_with_path(tnew[name]))[path]
            if name != "renv_net":
                np.testing.assert_array_equal(t, a)
                np.testing.assert_array_equal(j, a)
            else:
                assert np.abs(j - a).max() > 0.0
                assert rel_err(j - a, t - a) <= UPDATE_RTOL, (path, rel_err(j - a, t - a))
    for name in tr.optimizer.frozen_names:      # the EMA net keeps the frozen modules too
        for a, b in zip(getattr(tr.net, name).parameters(),
                        getattr(tr.ema_net, name).parameters()):
            assert torch.equal(a, b), name


def out_of_bound_step():
    """The f32 CP step at epoch 5 on probe rays of which some have shell
    samples outside the bound, in both packages: (JAX loss, terms and
    gradients; the port's trainer after backward, loss and terms)."""
    with f32_cp_encoder():
        (jopt, jcfg, params), (topt, tcfg, net) = sphere_model(seed=5)
        o, d = model_rays(tcfg, 5, inside=False)
        assert (np.abs(shell(o, d)) > 1.0).any()
        inputs = (o, d) + _step_inputs(5, tcfg)[2:]
        loss_fn = jax_sphere_loss(jopt, jcfg, jax_resolve(jopt, 5, 0), inputs, env_index=1)
        (jl, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, params))
        tr = Trainer(topt, tcfg, device="cpu", net=net)
        t = [torch.from_numpy(a) for a in inputs]
        loss, _, tterms = tr.forward_loss(*t[:5], K=0, sched=resolve(topt, 5, 0),
                                          material=torch.from_numpy(MATERIAL),
                                          env_index=torch.tensor(1))
        loss.backward()
    return jl, jterms, jax.tree.map(np.asarray, jgrads), tr, loss, tterms


def test_out_of_bound_samples_match_jax_outside_the_encoder():
    """A shell sample outside the bound (a ray that misses the sphere far
    from the origin) encodes to 0, so its SDF gradient is the zero vector.
    The eikonal term's norm then has a NaN gradient in JAX, which reaches the
    CP tables, and JAX's ``apply_if_finite`` skips the step; the port keeps
    torch's finite gradient there (the divergence of
    tests/test_torch_aux.py::test_zero_vector_gradient).  A batch of the
    env-sphere set holds such rays on most views (PERF.md), so every other
    leaf's gradient and every loss term of such a batch is held to JAX."""
    jl, jterms, jgrads, tr, loss, tterms = out_of_bound_step()
    assert set(tterms) == set(jterms) == {"color", "backsdf", "eikonal", "sdf"}
    for k, v in jterms.items():
        atol = BACKSDF_ATOL if k == "backsdf" else 0.0
        assert float(tterms[k]) == pytest.approx(float(v), rel=TERM_RTOL, abs=atol), k
    assert float(loss.detach()) == pytest.approx(float(jl), rel=TERM_RTOL)
    ours = dict(jax.tree_util.tree_leaves_with_path(export_jax_layout(tr.net, grads=True)))
    bad, errs = set(), {}
    for path, a in jax.tree_util.tree_leaves_with_path(jgrads):
        k, a, b = jax.tree_util.keystr(path), np.asarray(a), ours[path]
        assert np.isfinite(b).all(), k
        if not np.isfinite(a).all():
            bad.add(k)
        else:
            errs[k] = rel_err(a, b)
    assert bad and all(k.startswith("['encoder']") for k in bad)
    for k, e in errs.items():
        assert e <= (RELU_FLIP_RTOL if k.startswith("['env_nets']") else GRAD_RTOL), (k, errs)
    tr._apply_update()
    assert int(tr.notfinite) == 0 and int(tr.applied_steps) == 1


def test_sphere_checkpoint_round_trips_and_loads_in_jax(tmp_path):
    """A sphere trainer's checkpoint (the env_nets stack in the JAX layout)
    read back by the port, parameters and Adam moments, and by the JAX
    trainer."""
    from envidr_tpu.train.trainer import Trainer as JaxTrainer
    from envidr_tpu_torch.data.env_dataset import generate_env_sphere
    (jopt, jcfg, _), (topt, tcfg, net) = sphere_model(seed=9)
    topt = dataclasses.replace(topt, workspace=str(tmp_path))
    data = generate_env_sphere("train", 2, size=24, env_res=8, n_envs=2, device="cpu")
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    for _ in range(2):
        tr.train_step(data)
    path = tr.save_checkpoint()
    again = Trainer(topt, tcfg, device="cpu")
    again.load_checkpoint(path)
    for a, b in zip([*tr.net.parameters(), *tr.ema_net.parameters(), *tr.optimizer.m],
                    [*again.net.parameters(), *again.ema_net.parameters(), *again.optimizer.m]):
        assert torch.equal(a, b)
    jt = JaxTrainer(dataclasses.replace(jopt, workspace=str(tmp_path)), jcfg,
                    workspace=str(tmp_path))
    assert jt.load_checkpoint(path)
    ours = export_jax_layout(tr.net)
    for path_, a in jax.tree_util.tree_leaves_with_path(jt.state["params"]):
        np.testing.assert_array_equal(np.asarray(a),
                                      dict(jax.tree_util.tree_leaves_with_path(ours))[path_])

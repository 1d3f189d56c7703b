"""The port's interreflection model held to the benchmark's plain PyTorch
reference (``benchmark/reference/indirect.py``) on the CPU, in float32:
``render_scene_indirect``'s three passes and their gradients, one
``Trainer.train_step`` with grad rays, the learned blend and the frozen
colour heads (its loss, its first gradient leaf by leaf, the parameters
after it, the frozen leaves bit-equal), the reference's untrained-cell
marking against the port's, and the spans and counters of an indirect step.

The model is the benchmark's ``synth_shiny3_indir`` configuration cut to
test size (4 CP levels up to resolution 64, rank 8, width-16 MLPs, IDE
degree 4, 64 rays) on the program's 128^3 grid, which the reference's march
reads as the program's.  Random weights are nowhere opaque, so the renv gate
would stay shut: the SDF of two spheres is fitted into the small model, the
grid holds the cells near their surfaces, the roughness channel's bias puts
every sample below the gate's 0.1, and the rays look at the big sphere's side
that mirrors the small one, so that reflected rays hit it, their visibility
passes 0.9 and ``renv_net`` takes a gradient.

Both sides compute the same float32 expressions op by op on the CPU; the
readings (the largest over the leaves) are written beside each
tolerance."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import indirect as ref
from benchmark.reference import model as M
from envidr_tpu_torch import obs
from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.ops.grid import GridSpec, OccupancyGrid, init_grid, mark_untrained
from envidr_tpu_torch.render.indirect import IndirectOptions, render_scene_indirect
from envidr_tpu_torch.render.scene import SceneRenderOptions
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import ROOT, one_torch_thread_fixture

one_torch_thread = one_torch_thread_fixture()

CONFIG = os.path.join(ROOT, "benchmark", "configs", "synth_shiny3_indir.json")
SMALL = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16,
             hidden_dim_color=16, hidden_dim_env=16, hidden_dim_diffuse=16, sh_degree=4,
             num_rays=64)
SPHERES = ((np.float32([0.0, 0.0, 0.0]), 0.35), (np.float32([0.62, 0.0, 0.0]), 0.22))
CAMERA, TARGET = np.float32([-0.3, 0.0, 2.5]), np.float32([0.24, 0.0, 0.2])
K = 64                      # the main passes' budget: early_stop_steps
ROUGH_BIAS = -4.0           # roughness 0.2 softplus(-5 + w.h): below the gate's 0.1
OUT_RTOL = 1e-6             # of a tensor's max; reading 0 (bit-equal)
GRAD_RTOL = 1e-5            # of a leaf's max gradient; readings 6.5e-8 (the render's,
                            # encoder.axes.1.1) and 7.1e-8 (the step's, encoder.axes.3.2)
LOSS_RTOL = 1e-6            # reading 0
PARAM_ATOL = 1e-7           # after one Adam step of lr 3e-3; reading 4.7e-10


def _options(**extra):
    with open(CONFIG) as f:
        o = json.load(f)["options"]
    return {**o, **SMALL, **extra}


def _sdf(x):
    return np.min([np.linalg.norm(x - c, axis=-1) - r for c, r in SPHERES], axis=0)


_FIT = {}


def fitted():
    """(options, the small network with the spheres' SDF fitted, the grid's
    bitfield [1, 128^3]); the fit, 300 Adam steps, once a process."""
    if not _FIT:
        opts = _options()
        opt = load_options("", **{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in opts.items()})
        net = NeRFNetwork(network_config(opt), generator=torch.Generator().manual_seed(3))
        net.cp_spec = dataclasses.replace(net.cp_spec, compute_dtype="float32")
        adam = torch.optim.Adam(net.parameters(), lr=1e-2)
        rng = np.random.default_rng(0)
        for _ in range(300):
            centers = np.stack([c for c, _ in SPHERES])[rng.integers(0, 2, 4096)]
            x = np.concatenate([rng.uniform(-1, 1, (4096, 3)),
                                centers + rng.normal(0, 0.3, (4096, 3))]).astype(np.float32)
            pred = net.forward_geometry(torch.from_numpy(x))["sdf"]
            loss = ((pred - torch.from_numpy(_sdf(x))) ** 2).mean()
            adam.zero_grad()
            loss.backward()
            adam.step()
        g = opt.geo_feat_dim
        with torch.no_grad():
            net.sdf_density.variance.fill_(0.5)
            net.sdf_net[-1].bias[1 + g] = ROUGH_BIAS
            gen = torch.Generator().manual_seed(4)
            for mlp in (net.env_net, net.renv_net):
                mlp[-1].bias.copy_(torch.rand(mlp[-1].bias.shape, generator=gen) * 0.2 - 0.1)
        H = 128
        cells = np.stack(np.meshgrid(*[np.arange(H)] * 3, indexing="ij"), -1).reshape(-1, 3)
        world = ((2.0 * cells / (H - 1) - 1.0) * (1.0 - 1.0 / H)).astype(np.float32)
        _FIT.update(opts=opts, opt=opt, net=net,
                    bits=torch.from_numpy((np.abs(_sdf(world)) < 0.03)[None]))
    return _FIT["opts"], _FIT["opt"], copy.deepcopy(_FIT["net"]), _FIT["bits"].clone()


def spec_of(opts):
    return ref.make_spec({**opts, "cp_compute_dtype": "float32"})


def _rays(n=48, seed=0):
    rng = np.random.default_rng(seed)
    tgt = np.stack([rng.uniform(0.15, 0.33, n), rng.uniform(-0.1, 0.1, n),
                    np.full(n, 0.2)], -1).astype(np.float32)
    d = tgt - CAMERA
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(np.tile(CAMERA, (n, 1))), torch.from_numpy(d.astype(np.float32))


def _leaves(net):
    return {n: p.detach().clone().requires_grad_(True) for n, p in net.named_parameters()}


@pytest.fixture(scope="module")
def renders():
    """The port's and the reference's three-pass renders of 48 rays, and
    the gradients of one weighted sum of their outputs."""
    opts, opt, net, bits = fitted()
    spec = spec_of(opts)
    o, d = _rays()
    n = o.shape[0]
    gen = torch.Generator().manual_seed(1)
    noise = torch.rand((3, n), generator=gen)
    bg = torch.ones((n, 3))
    weights = {k: torch.rand(shape, generator=gen) for k, shape in
               (("image", (n, 3)), ("r_images", (n, 4)), ("normal_image", (n, 3)),
                ("depth", (n,)), ("weights_sum", (n,)))}
    ropts = SceneRenderOptions(max_steps=opt.max_steps, num_samples=K,
                               early_stop_steps=opt.early_stop_steps, T_thresh=opt.T_thresh,
                               min_near=opt.min_near, perturb=True, training=True,
                               grid_size=128, coarse_march=True)
    iopts = IndirectOptions(indir_max_steps=opt.indir_max_steps,
                            indir_early_stop_steps=opt.indir_early_stop_steps,
                            indir_num_samples=ref.secondary_budget(spec, K), grad_rays=True,
                            grad_rays_scale=opt.grad_rays_scale)
    aabb = torch.tensor([-1.0] * 3 + [1.0] * 3)
    port = render_scene_indirect(net, ropts, iopts, bits, o, d, bg, aabb, noise=noise)
    P = _leaves(net)
    mine = ref.render_indirect(spec, P, bits, o, d, bg, K, noise)
    out = {}
    for side, res, params in (("port", port, dict(net.named_parameters())), ("ref", mine, P)):
        total = sum((res[k] * w).sum() for k, w in weights.items())
        names = list(params)
        gs = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
        out[side] = (res, {k: (torch.zeros_like(params[k]) if g is None else g)
                           for k, g in zip(names, gs)})
    return out


def _close(a, b, rtol):
    a, b = a.detach().double(), b.detach().double()
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) <= rtol * scale, float((a - b).abs().max()) / scale


@pytest.mark.parametrize("key", ["normal_image", "depth", "r_images", "image", "weights_sum"])
def test_three_pass_render_matches_the_reference(renders, key):
    (port, _), (mine, _) = renders["port"], renders["ref"]
    assert torch.equal(port["ref_mask"], mine["ref_mask"])
    ok, err = _close(port[key], mine[key], OUT_RTOL)
    assert ok, (key, err)


MODULES = ["encoder", "sdf_density", "sdf_net", "env_net", "diffuse_net", "color_net",
           "renv_net"]


@pytest.mark.parametrize("module", MODULES)
def test_three_pass_render_gradients_match_the_reference(renders, module):
    (_, gp), (_, gr) = renders["port"], renders["ref"]
    leaves = [k for k in gr if k.split(".", 1)[0] == module]
    assert leaves
    for k in leaves:
        assert torch.isfinite(gp[k]).all(), k
        ok, err = _close(gp[k], gr[k], GRAD_RTOL)
        assert ok, (k, err)


def test_the_gate_opens_and_renv_net_takes_a_gradient(renders):
    (port, gp), (mine, gr) = renders["port"], renders["ref"]
    assert bool(port["renv_mask"].any()) and bool(mine["renv_gate"].any())
    assert torch.equal(port["renv_mask"], mine["renv_gate"])
    assert bool((port["r_images"][:, 3] > 0.9).any())
    for g in (gp, gr):
        assert any(bool(v.abs().max() > 0) for k, v in g.items() if k.startswith("renv_net."))


class _View:
    """One 8x8 RGBA view whose camera looks at the big sphere's side that
    mirrors the small one: what ``Trainer.train_step`` and the reference
    read of a scene."""

    H = W = 8
    C = 4

    def __init__(self, seed=0):
        f = TARGET - CAMERA
        f = f / np.linalg.norm(f)
        r = np.cross(f, np.float32([0.0, 1.0, 0.0]))
        r = r / np.linalg.norm(r)
        u = np.cross(f, r)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, u, f, CAMERA
        self.poses = pose[None]
        self.intrinsics = (80.0, 80.0, 4.0, 4.0)
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (1, 8, 8, 4)).astype(np.uint8)
        img[..., 3] = np.where(rng.random((1, 8, 8)) < 0.7, 255, 0)
        self.images = img

    def __len__(self):
        return 1

    def device_images(self, device):
        return torch.from_numpy(self.images.reshape(1, 64, 4)).to(device)

    def epoch_order(self, rng):
        idx = np.arange(1)
        rng.shuffle(idx)
        return idx


EPOCH, STEP = 10, 1001       # the indirect pass and grad rays on; no grid refresh


def trainer_at_start():
    """(trainer, view, start params, start EMA) of the fitted model with the
    spheres' grid at epoch 10, step 1001."""
    opts, opt, net, bits = fitted()
    tr = Trainer(opt, network_config(opt), device="cpu", net=net)
    density = torch.where(bits, 1.0, 0.0).float()
    tr.grid = OccupancyGrid(density=density, bitfield=bits.clone(),
                            mean_density=torch.tensor(0.0), iter_density=20)
    tr.epoch, tr.global_step = EPOCH, STEP
    tr.generator.manual_seed(11)
    start = {k: p.detach().clone() for k, p in tr.net.named_parameters()}
    start_ema = {k: p.detach().clone() for k, p in tr.ema_net.named_parameters()}
    return tr, _View(), start, start_ema


@pytest.fixture(scope="module")
def steps():
    """One train step of the program and of the reference from one start."""
    opts, _, _, _ = fitted()
    spec = spec_of(opts)
    tr, view, start, start_ema = trainer_at_start()
    density, bits = tr.grid.density.clone(), tr.grid.bitfield.clone()
    m = tr.train_step(view)
    opt_ = tr.optimizer
    first = {opt_.names[id(p)]: (mv / (1.0 - opt_.B1)).detach()
             for p, mv in zip(opt_.params, opt_.m)}
    st = M.State(params={k: v.clone() for k, v in start.items()},
                 ema={k: v.clone() for k, v in start_ema.items()}, density=density,
                 bitfield=bits, iter_density=20, global_step=STEP, epoch=EPOCH,
                 mean_count=-1.0, generator=torch.Generator().manual_seed(11),
                 seed=tr.opt.seed, sched_count=0)
    names = ref.trainable(spec, st.params)
    st.m = {k: torch.zeros_like(st.params[k]) for k in names}
    st.v = {k: torch.zeros_like(st.params[k]) for k in names}
    out = ref.train_step(spec, st, view)
    return dict(tr=tr, m=m, first=first, start=start, start_ema=start_ema, st=st, out=out,
                spec=spec)


def test_train_step_loss_matches_the_reference(steps):
    assert steps["tr"]._sched.indir_ref and steps["tr"]._sched.grad_rays
    a, b = float(steps["m"]["loss"]), float(steps["out"]["loss"])
    assert abs(a - b) <= LOSS_RTOL * abs(b), (a, b)


@pytest.mark.parametrize("module", ["encoder", "sdf_density", "sdf_net", "env_net",
                                    "renv_net"])
def test_train_step_first_gradient_matches_the_reference(steps, module):
    st, first = steps["st"], steps["first"]
    leaves = [k for k in st.m if k.split(".", 1)[0] == module]
    assert leaves and set(first) == set(st.m)
    for k in leaves:
        ok, err = _close(first[k], st.m[k] / (1.0 - M.B1), GRAD_RTOL)
        assert ok, (k, err)


def test_train_step_parameters_after_match_the_reference(steps):
    tr, st = steps["tr"], steps["st"]
    for (k, p), e in zip(tr.net.named_parameters(), tr.ema_net.parameters()):
        assert float((p.detach() - st.params[k]).abs().max()) <= PARAM_ATOL, k
        assert float((e - st.ema[k]).abs().max()) <= PARAM_ATOL, k


def test_train_step_keeps_the_frozen_heads_bit_equal_and_moves_renv_net(steps):
    tr, start, start_ema, st = steps["tr"], steps["start"], steps["start_ema"], steps["st"]
    frozen = ref.frozen_modules(steps["spec"])
    assert frozen == {"color_net", "diffuse_net"} == set(tr.optimizer.frozen_names)
    for (k, p), e in zip(tr.net.named_parameters(), tr.ema_net.parameters()):
        if k.split(".", 1)[0] in frozen:
            assert torch.equal(p, start[k]) and torch.equal(e, start_ema[k]), k
            assert torch.equal(st.params[k], start[k]) and torch.equal(st.ema[k], start_ema[k])
    assert steps["out"]["renv_open"] > 0 and float(steps["m"]["renv_open"]) > 0
    for k in start:
        if k.startswith("renv_net."):
            assert not torch.equal(tr.net.get_parameter(k), start[k]), k
            assert bool(steps["first"][k].abs().max() > 0), k


def test_reference_marks_the_untrained_cells_as_the_port():
    view = _View()
    spec = GridSpec(grid_size=128, bound=1.0, density_thresh=0.01, density_scale=1.0)
    grid = init_grid(spec, "cpu")
    grid = grid._replace(density=torch.rand(grid.density.shape, generator=torch.Generator()
                                            .manual_seed(2)))
    port = mark_untrained(grid, spec, torch.from_numpy(view.poses), view.intrinsics).density
    mine = ref.mark_untrained(grid.density, view.poses, view.intrinsics, 1.0)
    assert torch.equal(port, mine)
    assert 0 < float((mine < 0).float().mean()) < 1


INDIRECT_CHILDREN = ["rays", "indirect.geometry", "indirect.reflect", "indirect.main", "loss",
                     "backward", "update"]


def test_traced_indirect_step_spans_nest_and_counters_add_up():
    tr, view, _, _ = trainer_at_start()
    with obs.recording():
        tr.train_step(view)
    snap = obs.snapshot()
    (root,) = snap.roots("train_step")
    assert [s.name for s in snap.spans if s.parent == root] == INDIRECT_CHILDREN
    for name in ("indirect.geometry", "indirect.reflect", "indirect.main"):
        (i,) = [j for j, s in enumerate(snap.spans) if s.name == name]
        assert [s.name for s in snap.spans if s.parent == i] == ["render"]
    (renv,) = [j for j, s in enumerate(snap.spans) if s.name == "renv"]
    assert snap.path(renv) == ("train_step", "indirect.main", "render", "color", "renv")
    c = snap.counters
    n, k2 = tr.opt.num_rays, tr.indirect_options(tr._K, tr._sched).indir_num_samples
    assert c["indirect.rays"] == n and c["indirect.reflect.slots"] == n * k2
    assert 0 < c["indirect.ref_rays"] <= c["indirect.rays"]
    assert 0 < c["indirect.reflect.samples"] <= c["indirect.reflect.slots"]
    assert 0 < c["indirect.geometry.samples"] <= n * tr._K
    assert c["renv.samples"] == n * tr._K and 0 < c["renv.open"] <= c["renv.samples"]
    assert c["march.slots"] == n * tr._K and 0 < c["march.samples"] <= c["march.slots"]


def test_untraced_indirect_step_records_nothing_and_reads_nothing(monkeypatch):
    tr, view, _, _ = trainer_at_start()
    tr.train_step(view)                  # starts the epoch: reads the mean count once
    tr._order = [0]                      # the next step stays in the epoch
    with obs.recording():
        pass
    before = dict(obs.COUNTERS)

    def read(*a, **k):
        raise AssertionError("a host read inside an untraced step")
    for attr in ("item", "tolist", "numpy", "__bool__", "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, attr, read)
    tr.train_step(view)
    monkeypatch.undo()
    snap = obs.snapshot()
    assert snap.spans == [] and snap.counters == {}
    assert obs.COUNTERS["indirect.rays"] - before.get("indirect.rays", 0) == tr.opt.num_rays

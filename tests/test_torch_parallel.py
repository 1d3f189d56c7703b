"""Ray-data-parallel training in the port (envidr_tpu_torch/parallel/): two
worker processes under gloo on the CPU against the port's one-process step
on the same global batch, the one-process tiny step against the JAX
package's ``run_tiny_step``, the two-rank eval render against the one-rank
render, and the pieces: ``shard_rays`` / ``global_from_local``,
``NeRFDataset(process_shard=True)`` and ``fp16_preload``.  Every worker
process has a ``communicate(timeout=...)`` of its own, and all are killed
when one overruns (``tiny_step.run_group``)."""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envidr_tpu.data import nerf_dataset as jds
from envidr_tpu_torch.data import nerf_dataset as tds
from envidr_tpu_torch.parallel import mesh
from envidr_tpu_torch.parallel.tiny_step import (
    run_group, run_tiny_step, state_arrays, tiny_batch, tiny_options, tiny_trainer, TinyView,
)
from test_torch_helpers import (
    ROOT, export_jax_layout, f32_cp_encoder, one_torch_thread_fixture, rel_err,
)

WORKER_TIMEOUT_S = 300
THREADS = 1                  # CPU threads a worker process, as this one's
one_torch_thread = one_torch_thread_fixture()
LOSS_RTOL = 1e-6             # the same sums in two parts; readings 0 (f32), 7.4e-8 (bf16)
# Adam's first moment after one step is 0.1 x the summed gradient, of each
# tensor's max.  With the CP encoder in f32 only the order of the sums
# differs: reading 7.6e-7 (encoder.proj.4).  In bf16 (the configs' default)
# its casts round each rank's partial table gradient before the sum, where
# one process rounds the whole: a bf16 ulp of each partial, which the sum's
# cancellation may enlarge; reading 4.4e-3 (encoder.axes.7.2)
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 2.0**-6}
# a parameter whose gradient is above this share of its tensor's max moves by
# the same Adam step on one rank and on two (readings 7.5e-9); below it the
# step may flip sign with the gradient's (a move of 2 lr; bf16), or, where
# the gradient is near Adam's eps of 1e-15, change in size (f32: 6.5e-7 at a
# first moment of 2.5e-17)
SIGNIFICANT = 1e-3
PARAM_ATOL = 1e-6
EVAL_ATOL = 2e-5             # tests/test_trainer.py's sharded-eval bound
# the port's one-process step against JAX's jitted one, the CP encoder in f32
# (trap C3): loss reading 0; parameters 1.9e-7 of their max; first moments
# (gradients) 7.1e-5 of their max
JAX_LOSS_RTOL = 1e-6
JAX_PARAM_RTOL = 1e-6
JAX_GRAD_RTOL = 1.3e-3       # f32 double backward (ROADMAP C-5)


# the f32 case also draws its rays from the error map, jitters its samples
# (stratified_sampling) and updates the error map from every rank's rays
OPTIONS = {"float32": dict(error_map=True, stratified_sampling=True), "bfloat16": {}}
ERROR_MAP_ATOL = 1e-6        # per-ray |error| of the same render; reading 0, 32 cells


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def step_runs(request, tmp_path_factory):
    """Rank 0 and 1 of the 2-process tiny step (32 rays, 16 a rank), and
    the one-process step on the same 32 rays, the CP encoder in f32 and
    in bf16."""
    options = OPTIONS[request.param]
    sets = [a for k, v in options.items() for a in ("--set", f"{k}={v}")]
    with ThreadPoolExecutor(1) as pool:     # the workers run while this process steps
        workers = pool.submit(run_group, 2, "step", str(tmp_path_factory.mktemp("step")),
                              "--device", "cpu", "--cp-dtype", request.param, *sets,
                              timeout=WORKER_TIMEOUT_S, threads=THREADS)
        metrics, trainer, delta = run_tiny_step(None, 2, "cpu", request.param, **options)
        ranks = workers.result()
    one = state_arrays(trainer)
    one.update(loss=float(metrics["loss"]), delta=delta)
    return ranks, one, trainer, request.param


def test_two_process_ranks_are_bit_equal(step_runs):
    ranks, _, _, _ = step_runs
    assert str(ranks[0]["backend"]) == "gloo"
    assert ranks[0].keys() == ranks[1].keys()
    for k in ranks[0]:
        if k != "backend":
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    assert ranks[0]["delta"] > 0


def test_two_process_step_matches_one_process_step(step_runs):
    ranks, one, trainer, cp_dtype = step_runs
    r = ranks[0]
    assert float(r["loss"]) == pytest.approx(one["loss"], rel=LOSS_RTOL)
    for k in ("grid/density", "grid/bitfield", "mean_count", "adam/count"):
        np.testing.assert_array_equal(r[k], one[k], err_msg=k)
    # the grid's mean, over another number of CPU threads: reading 1 ulp
    np.testing.assert_allclose(r["grid/mean_density"], one["grid/mean_density"], rtol=1e-6)
    assert ("error_map" in r) == ("error_map" in one) == bool(OPTIONS[cp_dtype])
    if "error_map" in one:
        assert (one["error_map"] != 0.1).sum() > 0
        np.testing.assert_allclose(r["error_map"], one["error_map"], rtol=0, atol=ERROR_MAP_ATOL)
    lr = max(lr for lr, _ in trainer.optimizer.groups)
    names = [k[len("adam/m/"):] for k in one if k.startswith("adam/m/")]
    assert len(names) == len(list(trainer.net.parameters()))
    for name in names:
        m_one = one[f"adam/m/{name}"]
        assert rel_err(m_one, r[f"adam/m/{name}"]) <= GRAD_RTOL[cp_dtype], name
        big = np.abs(m_one) > SIGNIFICANT * np.abs(m_one).max()
        d = np.abs(r[f"param/{name}"].astype(np.float64) - one[f"param/{name}"])
        assert d[big].max(initial=0.0) <= PARAM_ATOL, name
        assert d.max() <= 2.0 * lr * (1 + 1e-6), name


@functools.lru_cache(maxsize=1)
def _jax_tiny_step():
    """JAX's ``run_tiny_step(None, 1)`` (jitted; the CP encoder in f32, trap
    C3): its metrics, its new state and its initial parameters."""
    from envidr_tpu.config import network_config as jax_netcfg
    from envidr_tpu.parallel.tiny_step import run_tiny_step as jax_run_tiny_step
    from envidr_tpu.parallel.tiny_step import tiny_options as jax_tiny_options
    from envidr_tpu.train.trainer import Trainer as JaxTrainer

    with f32_cp_encoder():
        metrics, new_state, _, _ = jax_run_tiny_step(None, 1)
        jopt = jax_tiny_options(1)
        params0 = jax.tree.map(np.asarray, JaxTrainer(jopt, jax_netcfg(jopt)).state["params"])
    return metrics, new_state, params0


def test_one_process_tiny_step_matches_jax():
    """JAX's ``run_tiny_step(None, 1)`` (jitted; the CP encoder in f32, trap
    C3) against the port's step on its draws: the same initial parameters,
    its grid, its rays, background and march noise."""
    _tiny_step_against_jax(pack=False)


def test_one_process_packed_tiny_step_matches_jax():
    """The same step with its render packed (``Trainer.packs`` forced on: a
    fresh trainer has no fill to read yet): its 128 slots are all filled, so
    the encode, the networks and their backward run on them and 3968
    padding rows, and the loss, its terms, the updated parameters and
    Adam's first moments must match JAX's dense step within the same
    tolerances.  ``test_torch_neus.py``'s packed CP step leaves empty slots
    out."""
    _tiny_step_against_jax(pack=True)


def _tiny_step_against_jax(pack: bool):
    from envidr_tpu.geometry.rays import sampled_rays as jax_sampled_rays
    from envidr_tpu_torch import obs
    from envidr_tpu_torch.config import network_config
    from envidr_tpu_torch.io.jax_params import load_jax_params, module_tree
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.ops.grid import OccupancyGrid
    from envidr_tpu_torch.ops.marching import PACK_ROWS
    from envidr_tpu_torch.train.schedules import resolve
    from envidr_tpu_torch.train.trainer import Trainer

    metrics, new_state, params0 = _jax_tiny_step()
    with f32_cp_encoder():
        opt = tiny_options(1)
        cfg = network_config(opt)
        tr = Trainer(opt, cfg, device="cpu", net=load_jax_params(NeRFNetwork(cfg), params0))
    tr.packs = lambda flags: pack
    g = jax.tree.map(np.asarray, new_state["grid"])        # the step leaves the grid
    tr.grid = OccupancyGrid(torch.from_numpy(g.density), torch.from_numpy(g.bitfield),
                            torch.tensor(float(g.mean_density)), int(g.iter_density))
    sched = resolve(opt, 1, 0)
    N = opt.num_rays
    b = tiny_batch()
    k_rays, k_bg, k_perturb = jax.random.split(jax.random.PRNGKey(1), 3)
    rays = jax_sampled_rays(k_rays, jnp.asarray(b["pose"])[None], jnp.asarray(b["intrinsics"]),
                            16, 16, N)
    pix = b["image"][np.asarray(rays["inds"][0])].astype(np.float32) / 255.0
    bg = np.asarray(jax.random.uniform(k_bg, (N, 3)))
    gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    before = dict(obs.COUNTERS)
    loss, out, terms = tr.forward_loss(
        t(rays["rays_o"][0]), t(rays["rays_d"][0]), t(gt), t(bg), t(pix[:, 3]),
        K=tr.sample_budget(sched), sched=sched,
        noise=t(jax.random.uniform(k_perturb, (N,))))
    packed = obs.COUNTERS.get("march.pack.rows", 0) - before.get("march.pack.rows", 0)
    assert int(out["mask"].sum()) == out["mask"].numel() == 128
    assert packed == (PACK_ROWS if pack else 0)
    loss.backward()
    tr._apply_update()
    assert float(loss) == pytest.approx(float(metrics["loss"]), rel=JAX_LOSS_RTOL)
    for k, v in terms.items():
        assert float(v) == pytest.approx(float(metrics[k]), rel=JAX_LOSS_RTOL), k
    ours = dict(jax.tree_util.tree_leaves_with_path(export_jax_layout(tr.net)))
    for path, a in jax.tree_util.tree_leaves_with_path(new_state["params"]):
        assert rel_err(a, ours[path]) <= JAX_PARAM_RTOL, jax.tree_util.keystr(path)
    m_of = {id(p): m for p, m in zip(tr.optimizer.params, tr.optimizer.m)}
    moments = dict(jax.tree_util.tree_leaves_with_path(
        {name: module_tree(mod, [m_of.get(id(p), torch.zeros_like(p)) for p in mod.parameters()])
         for name, mod in tr.net.named_children()}))
    checked = 0
    for label, masked in new_state["opt_state"].inner_state.inner_states.items():
        adam = [s for s in getattr(masked, "inner_state", ()) if hasattr(s, "mu")]
        for path, a in (jax.tree_util.tree_leaves_with_path(adam[0].mu) if adam else ()):
            if getattr(a, "shape", None) is None:          # another group's leaf
                continue
            assert rel_err(a, moments[path]) <= JAX_GRAD_RTOL, (label, path)
            checked += 1
    assert checked == len(list(tr.net.parameters()))


def test_two_rank_eval_and_shards_match_one_rank(tmp_path):
    with ThreadPoolExecutor(1) as pool:
        workers = pool.submit(run_group, 2, "eval", str(tmp_path), "--device", "cpu",
                              timeout=WORKER_TIMEOUT_S, threads=THREADS)
        trainer = tiny_trainer(None, 2, "cpu")
        view = TinyView()
        one = trainer.render_image(view.poses[0], view.intrinsics, view.H, view.W)
        ranks = workers.result()
    rows = np.arange(36, dtype=np.float32).reshape(12, 3)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["image"], one["image"], rtol=0, atol=EVAL_ATOL)
        np.testing.assert_allclose(r["depth"], one["depth"], rtol=0, atol=EVAL_ATOL)
        np.testing.assert_array_equal(r["shard_local"], rows[6 * rank:6 * rank + 6])
        np.testing.assert_array_equal(r["shard_back"], rows)
        assert tuple(r["process_rank"]) == (rank, 2)


def test_shard_rays_without_a_process_group():
    rows = torch.arange(12.0).reshape(6, 2)
    assert mesh.shard_rays(None, rows) is rows
    assert mesh.global_from_local(None, rows) is rows
    one = mesh.make_mesh("cpu")
    assert (one.rank, one.world, one.sharded) == (0, 1, False)
    second = mesh.Group(1, 2, "gloo", torch.device("cpu"))
    a, b = mesh.shard_rays(second, rows, rows[:, 0])
    np.testing.assert_array_equal(a.numpy(), rows[3:].numpy())
    np.testing.assert_array_equal(b.numpy(), rows[3:, 0].numpy())
    assert mesh.shard_rays(second, None) is None
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_rays(second, rows[:5])


def test_process_shard_keeps_this_ranks_frames(monkeypatch):
    root = os.path.join(ROOT, "data", "synth_shiny3")
    full = tds.NeRFDataset(root, "val", scale=0.8, downscale=4)
    for rank in (0, 1):
        monkeypatch.setattr(tds, "process_rank", lambda rank=rank: (rank, 2))
        part = tds.NeRFDataset(root, "val", scale=0.8, downscale=4, process_shard=True)
        np.testing.assert_array_equal(part.images, full.images[rank::2])
        np.testing.assert_array_equal(part.poses, full.poses[rank::2])


def test_fp16_preload_matches_jax_and_skips_the_division():
    root = os.path.join(ROOT, "data", "synth_shiny3")
    ours = tds.NeRFDataset(root, "val", scale=0.8, downscale=4, fp16_preload=True)
    ref = jds.NeRFDataset(root, "val", scale=0.8, downscale=4, fp16_preload=True)
    dev = ours.device_images("cpu")
    want = np.asarray(ref.device_images)
    assert dev.dtype == torch.float16 and want.dtype == np.float16
    np.testing.assert_array_equal(dev.numpy().view(np.uint16), want.view(np.uint16))
    from envidr_tpu_torch.config import network_config
    from envidr_tpu_torch.train.trainer import Trainer
    opt = tiny_options(1)
    tr = Trainer(opt, network_config(opt), device="cpu")
    np.testing.assert_array_equal(tr._pixels(dev[0]).numpy(), dev[0].float().numpy())

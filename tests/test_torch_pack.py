"""Packed training renders (``render/scene.py``, ``ops/marching.py:SlotPacking``)
on the CPU: a packed render against the same render forced dense, and the
trainer's gate and counters.

A training render whose epoch fills under ``PACK_FILL`` of its slots runs the
per-sample work on the march's filled slots alone, packed into one flat
batch of a multiple of ``PACK_ROWS`` rows, and scatters the outputs back.
Each case renders the same rays on the same draws twice, packed and dense,
and compares the loss and every parameter's gradient (the sums over the
points run in another order: the GEMMs' weight gradients and the tables'
scatters), and the per-sample outputs at the filled slots, which are the
same expressions on the same values and must be equal.
"""

import numpy as np
import pytest
import torch

from envidr_tpu_torch import obs
from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from envidr_tpu_torch.ops.grid import OccupancyGrid, all_cell_coords
from envidr_tpu_torch.ops.marching import PACK_ROWS
from envidr_tpu_torch.train.schedules import resolve
from envidr_tpu_torch.train.trainer import PACK_FILL, Trainer
from test_torch_helpers import CP_SMALL, ROOT, SMALL, camera_rays, one_torch_thread_fixture

one_torch_thread = one_torch_thread_fixture()

CP_INI = f"{ROOT}/configs/synth_spheres_cp.ini"
HASH_INI = f"{ROOT}/configs/synth_spheres.ini"
LOSS_RTOL = 1e-6        # of the loss; reading 0 (bit-equal)
GRAD_RTOL = 1e-5        # of a leaf's largest gradient; readings up to 1.8e-6 (the
                        # indirect case's sdf_density.variance), 0 in the full case
# the auxiliary terms, which read the consecutive-sample relations
AUX = dict(relsdf_loss_weight=0.1, dist_bound_weight=0.1, backsdf_loss_weight=0.01,
           orientation_loss_weight=0.01, entropy_loss_weight=0.01)


def _bits(kind: str, H: int = 128) -> torch.Tensor:
    """A [1, H^3] occupancy: a thin spherical shell, nothing or everything."""
    if kind == "empty":
        return torch.zeros((1, H ** 3), dtype=torch.bool)
    if kind == "full":
        return torch.ones((1, H ** 3), dtype=torch.bool)
    world = (2.0 * all_cell_coords(H).float() / (H - 1) - 1.0) * (1.0 - 1.0 / H)
    r = world.norm(dim=-1)
    return ((r > 0.3) & (r < 0.36))[None]


def _trainer(ini, extra, bits, K, epoch=1):
    opt = load_options(ini, **extra)
    tr = Trainer(opt, network_config(opt), device="cpu")
    tr.grid = OccupancyGrid(density=bits.float(), bitfield=bits, mean_density=torch.tensor(0.0),
                            iter_density=20)
    tr._sched, tr._K = resolve(opt, epoch, 0), K
    return tr


def _indirect_trainer():
    """The interreflection model of ``test_torch_indirect_reference`` (the
    SDF of two spheres fitted, the renv gate open on some rays), grad rays
    on, with its rays."""
    from test_torch_indirect_reference import EPOCH, K, STEP, _rays, fitted
    _, opt, net, bits = fitted()
    tr = Trainer(opt, network_config(opt), device="cpu", net=net)
    tr.grid = OccupancyGrid(density=bits.float(), bitfield=bits, mean_density=torch.tensor(0.0),
                            iter_density=20)
    tr._sched, tr._K = resolve(opt, EPOCH, STEP), K
    assert tr._sched.indir_ref and tr._sched.grad_rays
    return tr, _rays(48)


# name -> (trainer, rays): each a training render the gate may pack
def _case(name):
    if name == "indirect":
        return _indirect_trainer()
    if name == "cp":                 # the cp_train configuration: NeuS, coarse march, bf16 CP
        return _trainer(CP_INI, CP_SMALL, _bits("shell"), 32), camera_rays(64)
    if name == "laplace_dense":      # Laplace, the dense march, the auxiliary terms, jitter
        return (_trainer(HASH_INI, dict(SMALL, stratified_sampling=True, **AUX),
                         _bits("shell"), 32), camera_rays(64))
    if name == "no_sample":
        return _trainer(CP_INI, CP_SMALL, _bits("empty"), 32), camera_rays(64)
    if name == "full":               # every slot filled: 4096 rows, no padding
        return _trainer(CP_INI, CP_SMALL, _bits("full"), 16), camera_rays(256)
    if name == "two_blocks":         # 4800 filled slots: 8192 rows, 3392 of them padding
        return _trainer(CP_INI, CP_SMALL, _bits("full"), 16), camera_rays(300)
    raise KeyError(name)


def _draws(tr, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    sched, K = tr._sched, tr._K
    strat = None
    if tr.opt.stratified_sampling:
        strat = torch.rand((n, K), generator=g)
    noise = torch.rand((3, n) if sched.indir_ref else (n,), generator=g)
    return dict(gt=torch.rand((n, 3), generator=g), bg=torch.ones((n, 3)),
                alpha=(torch.rand((n,), generator=g) > 0.5).float(), noise=noise, strat=strat)


def _render(tr, pack, o, d, draws):
    """(loss, outputs, gradients by leaf, what the pack's counters and
    ``host_sync`` gained) of one training render and its loss, packed or
    dense."""
    tr.packs = lambda flags: pack
    before = dict(obs.COUNTERS)
    loss, out, _ = tr.forward_loss(o, d, draws["gt"], draws["bg"], draws["alpha"], K=tr._K,
                                   sched=tr._sched, noise=draws["noise"],
                                   strat_noise=draws["strat"])
    leaves = {k: p for k, p in tr.net.named_parameters() if p.requires_grad}
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(leaves.items(), gs)}
    gained = {k: obs.COUNTERS.get(k, 0) - before.get(k, 0)
              for k in ("host_sync", "march.pack.rows", "march.pack.slots", "march.pack.dense")}
    return loss.detach(), out, grads, gained


CASES = ["cp", "indirect", "laplace_dense", "no_sample", "full", "two_blocks"]


@pytest.mark.parametrize("name", CASES)
def test_packed_render_matches_the_dense_render(name):
    tr, (o, d) = _case(name)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    n = o.shape[0]
    draws = _draws(tr, n)
    passes = 3 if tr._sched.indir_ref else 1
    loss_d, out_d, g_d, c_d = _render(tr, False, o, d, draws)
    loss_p, out_p, g_p, c_p = _render(tr, True, o, d, draws)

    assert c_d == {"host_sync": 0, "march.pack.rows": 0, "march.pack.slots": 0,
                   "march.pack.dense": passes}
    assert c_p["host_sync"] == passes and c_p["march.pack.dense"] == 0
    assert tr.step_pack_reads() == passes        # what chip_smoke's check expects a step
    mask = out_d["mask"]
    filled = int(mask.sum())
    if passes == 1:      # the filled count rounded up to PACK_ROWS, one block at least
        assert c_p["march.pack.rows"] == max(1, -(-filled // PACK_ROWS)) * PACK_ROWS
        assert c_p["march.pack.slots"] == mask.numel()
    want_filled = {"no_sample": 0, "full": 4096, "two_blocks": 4800}
    if name in want_filled:
        assert filled == want_filled[name]
    else:
        assert 0 < filled < mask.numel() and filled % PACK_ROWS
    assert torch.equal(out_p["mask"], mask) and torch.equal(out_p["counts"], out_d["counts"])

    assert abs(float(loss_p) - float(loss_d)) <= LOSS_RTOL * abs(float(loss_d)), \
        (float(loss_p), float(loss_d))
    worst = {}
    for k, gd in g_d.items():
        scale = float(gd.abs().max())
        worst[k] = float((g_p[k] - gd).abs().max()) / max(scale, 1e-30) if scale else \
            float(g_p[k].abs().max())
    assert max(worst.values()) <= GRAD_RTOL, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    # the per-sample outputs at the filled slots: the same expressions on the same values
    for key in ("sigmas", "sdfs", "sdf_gradients", "roughness", "weights"):
        if key in out_d:
            assert torch.equal(out_p[key][mask], out_d[key][mask]), key
    for key in ("image", "weights_sum", "depth", "normal_image"):
        assert torch.allclose(out_p[key], out_d[key], rtol=1e-6, atol=1e-7), key


def _stepping(ini, extra, bits):
    """A trainer past its first step (which starts the epoch and reads the
    mean count while it is still unset, so it renders dense) with the next
    step starting an epoch, which reads the count the first step left; two
    40 px views; no grid refresh falls on these steps."""
    opt = load_options(ini, **extra)
    tr = Trainer(opt, network_config(opt), device="cpu")
    tr.grid = OccupancyGrid(density=bits.float(), bitfield=bits, mean_density=torch.tensor(0.0),
                            iter_density=20)
    tr.global_step = 1
    data = SynthSpheres("train", size=40, n=2, scale=opt.scale)
    tr.train_step(data)
    tr._order = []
    return tr, data


def _recorded_step(tr, data):
    with obs.recording():
        m = tr.train_step(data)
    return m, obs.snapshot().counters


def test_a_packed_step_reads_once_a_render_and_counts_its_rows():
    tr, data = _stepping(CP_INI, CP_SMALL, _bits("shell"))
    for epoch_start in (True, False):
        m, c = _recorded_step(tr, data)
        assert tr.step_pack_reads() == 1       # the next step's, with the epoch's fill read
        fill = tr.host_mean_count / tr._K
        assert 0.0 < fill < PACK_FILL and tr.packs(tr._sched.flags), fill
        # the epoch's read of the mean count, then the render's of its filled count
        assert c["host_sync"] == 1 + epoch_start
        filled = round(c["march.samples"])
        assert 0 < filled < c["march.slots"]
        assert c["march.pack.rows"] == -(-filled // PACK_ROWS) * PACK_ROWS
        assert c["march.pack.slots"] == c["march.slots"] and "march.pack.dense" not in c
        assert np.isfinite(float(m["loss"]))


def test_full_slots_stay_dense_and_read_nothing_more():
    """The hash configuration at full fill: the step renders dense, as
    before, with no read beyond the epoch's."""
    tr, data = _stepping(HASH_INI, SMALL, _bits("full"))
    _, c = _recorded_step(tr, data)
    assert tr.host_mean_count >= PACK_FILL * tr._K and not tr.packs(tr._sched.flags)
    assert c["host_sync"] == 1 and c["march.pack.dense"] == 1
    assert "march.pack.rows" not in c and "march.pack.slots" not in c
    assert tr.step_pack_reads() == 0


def test_cauchy_reads_every_slot_so_its_step_stays_dense():
    tr, data = _stepping(CP_INI, dict(CP_SMALL, cauchy_loss_weight=0.1), _bits("shell"))
    _, c = _recorded_step(tr, data)
    assert tr._sched.flags.use_cauchy_loss and 0.0 <= tr.host_mean_count < PACK_FILL * tr._K
    assert not tr.packs(tr._sched.flags)
    assert c["host_sync"] == 1 and c["march.pack.dense"] == 1 and "march.pack.rows" not in c


def test_eval_render_stays_dense():
    tr, data = _stepping(CP_INI, CP_SMALL, _bits("shell"))
    tr.train_step(data)                  # the epoch's read: the fill is under PACK_FILL
    assert tr.packs(tr._sched.flags)
    o, d = (torch.as_tensor(t) for t in camera_rays(32))
    before = dict(obs.COUNTERS)
    out = tr.render_rays(o, d)
    assert out["image"].shape == (32, 3)
    assert {k: v for k, v in obs.COUNTERS.items() if k.startswith("march.pack")} == \
        {k: v for k, v in before.items() if k.startswith("march.pack")}

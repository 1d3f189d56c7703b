"""Plain PyTorch reference of ENVIDR's interreflection model and its train
step: the ``use_renv`` block of ENVIDR's ``configs/scenes/toaster.ini``
(the three-pass render of ``nerf/renderer.py:437-513``, ``renv_net`` of
``nerf/network.py:303-310``, the renv branch and the learned blend of
``nerf/network.py:586-691``, the specular and diffuse heads frozen), for the
configuration ``synth_shiny3_indir``.

It reuses the scene model's functions of ``model.py`` (the CP encoder, the
SDF, IDE, env, diffuse and colour MLPs, NeuS alpha, the occupancy-grid march
and refresh, the loss, the pixel rays) and adds what the interreflection
model needs.  Like ``model.py`` it imports neither JAX nor the program under
test.  One train step:

  pass 1  geometry only: march, SDF and normals, composite the normals, the
          depth and the opacity of each ray; ``depth - dt`` with
          ``dt = 2 sqrt(3) / indir_max_steps``; ``ref_mask`` = the depth is
          not 0 and the opacity above 0.9 (``ray_mask``, above 0.3, is not
          used by the step);
  reflect ``ref_o = o + depth d``, ``ref_d = reflect(-d, n)``;
  pass 2  the reflected rays marched from ``ref_o`` at the secondary budget
          ``min(K, max(indir_early_stop_steps, 16))`` on the ladder of
          ``indir_max_steps`` steps, ``min_near = 2 dt``, on black; the
          samples re-attached to ``ref_o`` with ``grad_rays_scale`` (grad
          rays); ``r_images = [rgb, opacity]``, zero where ``ref_mask`` is off;
  pass 3  the main render with ``r_images``: per sample the gate
          ``roughness < indir_roughness_thresh`` and visibility above 0.9,
          ``renv_net`` on (the reflected colour times the visibility, the
          remapped roughness ``sqrt(roughness / roughness_scale / 0.75)``),
          a second pass of the colour head on that feature, blended into the
          specular colour with ``0.98 blend_weight`` (the SDF net's extra
          channel, a sigmoid) where the gate is open;
  loss    L1 colour against the linearised sRGB ground truth, mask BCE and
          the eikonal term of pass 3, as ``model.loss_fn``;
  update  Adam with per-group clipping and the decayed lr over the trainable
          leaves alone: a frozen group (``frozen_mlps``: specular is the
          colour head, diffuse the diffuse head) takes no update, has no
          moments and no share of a clip norm, but its gradient enters the
          finite check; the EMA covers the trainable leaves alone.

The draws are the program's: the grid refresh's jitter, the pixels, the
background where it is random, then one march offset a pass, ``[3, N]``.

Departures from a straight transcription, each for a reason:
  * the masks stay dense per-ray tensors (every ray marches in pass 2, a
    masked one carries zeros), as the program keeps them, where ENVIDR
    gathers the masked rays: the values are the same;
  * the step may compute in blocks of rays (``block_rays``) where a whole
    batch does not fit through autograd: each ray's three passes depend on
    that ray alone, and each block's loss is its share of the batch's loss
    (each mean's denominator that of the whole batch; the eikonal term's,
    the batch's marched samples of pass 3, from one march of all rays
    without gradients), so the blocks' losses and gradients sum to the
    batch's, up to the order of the sums;
  * the grid refresh reads the SDF through ``model.geometry``, which leaves
    the blend channel of the SDF net's output unread.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import model as M

# what this reference implements of the options it does not read for sizes:
# the scene model's, with the interreflection model's own settings
REQUIRED = {**M.REQUIRED, "learn_indir_blend": True, "color_space": "linear",
            "use_renv": True, "indir_only": False, "frozen_mlps": ["specular", "diffuse"],
            "resume_mlps": [], "color_mlp_path": "", "train_renv": False,
            "use_neus_sdf": True, "coarse_march": True, "encoding_pos": "cp",
            "alpha_bg_mode": "white", "obj_aabb": None}
MODULE_OF = {"specular": "color_net", "diffuse": "diffuse_net", "renv": "renv_net"}


def make_spec(options: dict, precision: str = "float32") -> M.Spec:
    """The configuration as this reference reads it: ``model.Spec``'s level
    sizes, with the options checked against :data:`REQUIRED` here."""
    o = dict(options)
    wrong = {k: o.get(k) for k, v in REQUIRED.items() if o.get(k) != v}
    if wrong:
        raise ValueError(f"reference: options it does not implement: {wrong}")
    spec = M.Spec({**o, "learn_indir_blend": False, "color_space": "srgb"}, precision)
    spec.options, spec.o = o, dict(o)
    return spec


def frozen_modules(spec: M.Spec) -> set:
    return {MODULE_OF[n] for n in spec["frozen_mlps"]}


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


# ------------------------------------------------------------ the networks

def geometry(spec: M.Spec, P, xyz: torch.Tensor) -> Dict[str, torch.Tensor]:
    """SDF, geometry feature, roughness and blend weight at world points."""
    b = spec["bound"]
    x01 = ((xyz + b) / (2.0 * b)).reshape(-1, 3)
    h = M.cp_encode(spec, P, x01).reshape(*xyz.shape[:-1], -1)
    h = M.mlp(spec, P, "sdf_net", spec["num_layers"], h)
    g = spec["geo_feat_dim"]
    return {"sdf": h[..., 0], "geo_feat": M.unit_norm(h[..., 1:1 + g]),
            "roughness": spec["roughness_act_scale"] * F.softplus(h[..., 1 + g:2 + g] - 1.0)
            * spec["roughness_scale"],
            "blend_weight": torch.sigmoid(h[..., 2 + g:3 + g])}


def color(spec: M.Spec, P, geo, normals, dirs, r_images: Optional[torch.Tensor]):
    """Diffuse plus specular colour; with ``r_images`` [N, 4] the renv
    branch blends ``renv_net``'s reading of the reflected ray into the
    specular colour where the gate is open.  -> (rgb, gate or None)."""
    w_o = -dirs
    w_r = 2.0 * (w_o * normals).sum(dim=-1, keepdim=True) * normals - w_o
    rough = geo["roughness"]
    n_env = M.ide(spec, normals, spec["diffuse_kappa_inv"])
    w_r_enc = M.ide(spec, w_r, rough)
    n_env_l = spec["num_layers_env"]
    nenv = M.unit_norm(M.mlp(spec, P, "env_net", n_env_l, n_env))
    c_diffuse = torch.sigmoid(M.mlp(spec, P, "diffuse_net", spec["num_layers_diffuse"],
                                    torch.cat([geo["geo_feat"], nenv], dim=-1)))
    env_feat = M.unit_norm(M.mlp(spec, P, "env_net", n_env_l, w_r_enc))
    n_dot = (normals * w_o).sum(dim=-1, keepdim=True)

    def head(feat):
        return torch.sigmoid(M.mlp(spec, P, "color_net", spec["num_layers_color"],
                                   torch.cat([geo["geo_feat"], normals, feat, n_dot], dim=-1)))

    c_spec = head(env_feat)
    gate = None
    if r_images is not None:
        r = r_images[:, None, :].expand(*normals.shape[:-1], r_images.shape[-1])
        vis = r[..., 3]
        r_rgb = r[..., :3] * vis.detach()[..., None]
        gate = (rough[..., 0] < spec["indir_roughness_thresh"]) & (vis > 0.9)
        remap = torch.sqrt(torch.clamp(rough / spec["roughness_scale"] / 0.75, min=0.0))
        blend = 0.98 * geo["blend_weight"]
        feat = M.unit_norm(M.mlp(spec, P, "renv_net", 4, torch.cat([r_rgb, remap], dim=-1)))
        c_renv = head(feat)
        c_spec = torch.where(gate[..., None], c_spec * blend + c_renv * (1.0 - blend), c_spec)
    return c_diffuse + c_spec, gate


# -------------------------------------------------------------------- march

def march(spec: M.Spec, bitfield, rays_o, rays_d, nears, fars, K: int, T: int, ess: int,
          noise=None):
    """``model.march`` (the coarse march) on a ladder of ``T`` steps capped
    at ``ess`` samples, also returning each slot's ``t``:
    (xyz, dts, ts, mask, counts)."""
    H, b = 128, spec["bound"]
    N, dev = rays_o.shape[0], rays_o.device
    dt_min = 2.0 * M.SQRT3 / T
    k_eff = K if ess <= 0 else min(K, ess)
    o, d = rays_o.detach(), rays_d.detach()
    nears, fars = nears.detach(), fars.detach()
    t0 = nears if noise is None else nears + dt_min * noise
    occ_grid = bitfield[0]
    S = min(8, int(2.0 * b / (H // 4) / dt_min - 1e-6))
    Hc = H // 4
    Tc = -(-T // S)
    Mseg = min(Tc, max(16, -(-2 * k_eff // S), -(-K // S)))
    g = F.max_pool3d(occ_grid.reshape(1, 1, H, H, H).float(), 4)
    coarse = (F.max_pool3d(g, 3, stride=1, padding=1)[0, 0] > 0.0).reshape(-1)
    jc = torch.arange(Tc, dtype=torch.float32, device=dev)
    ts_seg = t0[:, None] + jc[None] * (S * dt_min)
    xyz_p = torch.clamp(o[:, None] + ts_seg[..., None] * d[:, None], -b, b)
    cell_p = torch.clamp((0.5 * (xyz_p / b + 1.0) * Hc).int(), 0, Hc - 1).long()
    occ_seg = coarse[M._cell(cell_p, Hc)] & (ts_seg < fars[:, None])
    order_c = torch.cumsum(occ_seg.int(), dim=-1) - 1
    sel_c = occ_seg & (order_c < Mseg)
    jci = torch.arange(Tc, dtype=torch.int32, device=dev)[None]
    top_c, seg = torch.topk(torch.where(sel_c, Tc - jci, torch.zeros_like(jci)), Mseg, dim=-1,
                            sorted=True)
    js = torch.arange(S, dtype=torch.float32, device=dev)
    ts = t0[:, None, None] + (seg.float() * S)[..., None] * dt_min + js[None, None] * dt_min
    valid = ((top_c > 0)[..., None] & (ts < fars[:, None, None])).reshape(N, Mseg * S)
    ts = ts.reshape(N, Mseg * S)
    lad = (seg[..., None] * S + torch.arange(S, device=dev)[None, None]).reshape(N, Mseg * S)
    valid = valid & (lad < T)
    dts = torch.full((N, Mseg * S), dt_min, device=dev)
    xyz = torch.clamp(o[:, None] + ts[..., None] * d[:, None], -b, b)
    cell = torch.clamp((0.5 * (xyz / b + 1.0) * H).int(), 0, H - 1).long()
    sel = occ_grid[M._cell(cell, H)] & valid
    xyz_c, dts_c, mask, counts = M._first_k(sel, ts, dts, xyz, K, k_eff)
    _, ts_c, _, _ = M._first_k(sel, ts, ts, xyz, K, k_eff)
    return xyz_c, dts_c, ts_c, mask, counts


# ------------------------------------------------------------------- render

def render_pass(spec: M.Spec, P, bitfield, rays_o, rays_d, bg, K: int, *, T: int, ess: int,
                min_near: float, noise=None, geometry_only=False, grad_ray=False,
                r_images=None, cos_anneal_ratio=1.0) -> Dict[str, torch.Tensor]:
    """One pass: march, geometry with normals (differentiable for the
    eikonal term and, under ``grad_ray``, with the samples re-attached to
    ``rays_o``), NeuS alpha, and the composite of the normals, depth and
    opacity (``geometry_only``) or of the colour on ``bg`` [N, 3]."""
    nears, fars = M.near_far(rays_o, rays_d, spec["bound"], min_near)
    xyzs, dts, ts, mask, counts = march(spec, bitfield, rays_o, rays_d, nears, fars, K, T, ess,
                                        noise)
    if grad_ray:
        s = spec["grad_rays_scale"]
        xyzs = xyzs - s * rays_o.detach()[:, None, :] + s * rays_o[:, None, :]
    dirs = rays_d[:, None, :].expand_as(xyzs)
    with torch.enable_grad():
        pts = xyzs if xyzs.requires_grad else xyzs.detach().requires_grad_(True)
        geo = geometry(spec, P, pts)
        (grads,) = torch.autograd.grad(geo["sdf"].sum(), pts, create_graph=True)
    normals = M.safe_normalize(grads)
    zero = torch.zeros((), device=xyzs.device)
    alphas = torch.where(mask, M.neus_alpha(P, geo["sdf"], dirs, dts, normals, cos_anneal_ratio),
                         zero)
    one_minus = 1.0 - alphas + 1e-15
    Tr = torch.cumprod(torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]],
                                 dim=-1), dim=-1)
    w = alphas * Tr
    w = torch.where(Tr > spec["T_thresh"], w, torch.zeros_like(w))
    w = torch.where(mask, w, zero)
    ws = w.sum(dim=-1)
    z_vals = torch.where(mask, ts + dts - nears.detach()[:, None], zero)
    depth = (w * z_vals).sum(dim=-1)
    depth = (depth + nears) * (depth != 0.0)
    out = {"weights_sum": ws, "depth": depth, "mask": mask, "counts": counts,
           "sdf_gradients": torch.where(mask[..., None], grads, zero)}
    if geometry_only:
        out["normal_image"] = M.safe_normalize((w[..., None] * normals).sum(dim=-2))
        return out
    rgb, gate = color(spec, P, geo, normals, dirs, r_images)
    out["image"] = (w[..., None] * rgb).sum(dim=-2) + (1.0 - ws[..., None]) * bg
    if gate is not None:
        out["renv_gate"] = gate & mask
    return out


def secondary_budget(spec: M.Spec, K: int) -> int:
    return min(K, max(spec["indir_early_stop_steps"], 16))


def render_indirect(spec: M.Spec, P, bitfield, rays_o, rays_d, bg, K: int, noise,
                    cos_anneal_ratio=1.0) -> Dict[str, torch.Tensor]:
    """The three passes over N rays, ``noise`` [3, N] one march offset a
    pass: pass 3's outputs with pass 1's ``normal_image`` and ``depth``
    (less ``dt``), ``ref_mask``, ``r_images`` and pass 1's and pass 2's
    sample counts."""
    dt = 2.0 * M.SQRT3 / spec["indir_max_steps"]
    main = dict(T=spec["max_steps"], ess=spec["early_stop_steps"], min_near=spec["min_near"],
                cos_anneal_ratio=cos_anneal_ratio)
    geo = render_pass(spec, P, bitfield, rays_o, rays_d, bg, K, noise=noise[0],
                      geometry_only=True, **main)
    depth = geo["depth"] - dt
    ref_mask = (depth != 0.0) & (geo["weights_sum"] > 0.9)
    ref_o = rays_o + depth[:, None] * rays_d
    w_o = -rays_d
    n = geo["normal_image"]
    ref_d = 2.0 * (w_o * n).sum(dim=-1, keepdim=True) * n - w_o
    sec = render_pass(spec, P, bitfield, ref_o, ref_d, torch.zeros_like(bg),
                      secondary_budget(spec, K), T=spec["indir_max_steps"],
                      ess=spec["indir_early_stop_steps"], min_near=2.0 * dt, noise=noise[1],
                      grad_ray=True, cos_anneal_ratio=cos_anneal_ratio)
    r_images = torch.cat([sec["image"], sec["weights_sum"][:, None]], dim=-1)
    r_images = torch.where(ref_mask[:, None], r_images, torch.zeros((), device=r_images.device))
    out = render_pass(spec, P, bitfield, rays_o, rays_d, bg, K, noise=noise[2],
                      r_images=r_images, **main)
    out.update(normal_image=n, depth=depth, ref_mask=ref_mask, r_images=r_images,
               geometry_counts=geo["counts"], reflect_counts=sec["counts"])
    return out


# -------------------------------------------------------------- the trainer

def mark_untrained(density: torch.Tensor, poses, intrinsics, bound: float,
                   chunk: int = 2 ** 17) -> torch.Tensor:
    """The grid's density [1, 128^3] with -1 at each cell whose centre no
    camera of ``poses`` [B, 4, 4] (NGP c2w) sees: in front of the camera and
    inside its field of view widened by two half cells on each side
    (ENVIDR's ``nerf/renderer.py:200-263``)."""
    H = 128
    fx, fy, cx, cy = intrinsics
    dev = density.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    r = torch.arange(H, device=dev)
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    coords = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)
    half = bound / H
    seen = []
    for s in range(0, coords.shape[0], chunk):
        world = (2.0 * coords[s:s + chunk].float() / (H - 1) - 1.0) * (bound - half)
        cam = (world[None] - poses[:, None, :3, 3]) @ poses[:, :3, :3]
        seen.append(((cam[..., 2] > 0)
                     & (cam[..., 0].abs() < cx / fx * cam[..., 2] + half * 2)
                     & (cam[..., 1].abs() < cy / fy * cam[..., 2] + half * 2)).any(dim=0))
    return torch.where(torch.cat(seen)[None], density, -1.0)


def adam_step(spec: M.Spec, st: M.State, grads: Dict[str, torch.Tensor]) -> bool:
    """``model.adam_step`` over the trainable leaves: a frozen module's
    leaves take no update and have no moments and no share of a clip norm;
    every gradient, the frozen ones' too, enters the finite check; the EMA
    covers the trainable leaves."""
    frozen = frozen_modules(spec)
    names = [n for n in st.params if n.split(".")[0] not in frozen]
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        return False
    lrs = {"net": spec["lr"], "grid": spec["plr"] or spec["lr"],
           "scalar": spec["slr"] or spec["lr"], "env": spec["elr"] or spec["lr"]}
    count = st.count + 1
    dev = next(iter(st.params.values())).device
    cnt = torch.tensor(count, dtype=torch.float32, device=dev)
    bc1, bc2 = 1.0 - M.B1 ** cnt, 1.0 - M.B2 ** cnt
    decay = 0.1 ** torch.clamp(torch.tensor(st.sched_count, dtype=torch.float32, device=dev)
                               / spec["iters"], max=1.0)
    with torch.no_grad():
        for grp, lr in lrs.items():
            members = [n for n in names if M.GROUP_OF.get(n.split(".")[0], "net") == grp]
            if not members:
                continue
            norm = torch.linalg.vector_norm(torch.stack([grads[n].norm() for n in members]))
            scale = torch.where(norm < M.CLIP, 1.0, M.CLIP / norm)
            for n in members:
                g = grads[n] * scale
                m = g * (1.0 - M.B1) + st.m[n] * M.B1
                v = g * g * (1.0 - M.B2) + st.v[n] * M.B2
                upd = (m / bc1) / (torch.sqrt(v / bc2) + M.EPS) * decay * (-lr)
                st.params[n] = (st.params[n] + upd).detach()
                st.m[n], st.v[n] = m, v
        for n in names:
            st.ema[n] = st.ema[n] + (st.params[n] - st.ema[n]) * (1.0 - M.EMA)
    st.count, st.sched_count = count, st.sched_count + 1
    return True


def trainable(spec: M.Spec, names) -> list:
    frozen = frozen_modules(spec)
    return [n for n in names if n.split(".")[0] not in frozen]


def train_step(spec: M.Spec, st: M.State, scene, *, half_batch: bool = False,
               block_rays: int = 0) -> Dict:
    """One step on the next view of the epoch's shuffled order, drawing as
    the program's trainer draws (``model.train_step``'s order, then one march
    offset a pass).  ``half_batch`` (a fault) takes the loss over the first
    half of the rays; ``block_rays`` > 0 computes in blocks of that many
    rays.  Returns the loss, the gradients, K, and the number of pass-3
    samples whose renv gate opened."""
    if not st.order:
        st.epoch += 1
        if st.mean_count_t is not None:
            st.mean_count = float(st.mean_count_t)
        st.K = M.sample_budget(spec, st.mean_count)
        st.cos_anneal = (min(1.0, st.global_step / spec["cos_anneal_steps"])
                         if spec["cos_anneal_steps"] > 0 else spec["cos_anneal_ratio"])
        idx = np.arange(len(scene))
        np.random.default_rng(st.seed * 100003 + st.epoch).shuffle(idx)
        st.order = [int(i) for i in idx]
    start = spec["indir_ref_start_iter"]
    if not (0 < start <= st.epoch and st.epoch - start > spec["grad_rays_start_iter"] > 0):
        raise ValueError(f"reference: epoch {st.epoch} runs without the indirect pass or "
                         "grad rays, which this reference does not implement")
    view = st.order.pop(0)
    every = spec["update_extra_interval"]
    if every > 0 and st.global_step % every == 0:
        M.update_grid(spec, st)
    dev = st.density.device
    N, H, W = spec["num_rays"], scene.H, scene.W
    pose = torch.as_tensor(scene.poses[view], device=dev)[None]
    inds = torch.randint(0, H * W, (N,), generator=st.generator, device=dev)
    rays_o, rays_d = M.pixel_rays(pose, scene.intrinsics, W, inds[None])
    rays_o, rays_d = rays_o[0], rays_d[0]
    pix = torch.as_tensor(scene.images[view].reshape(H * W, 4), device=dev)[inds].float() / 255
    pix = torch.cat([srgb_to_linear(pix[:, :3]), pix[:, 3:]], dim=-1)
    bg = torch.ones((N, 3), device=dev)
    gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
    alpha = pix[:, 3]
    noise = torch.rand((3, N), generator=st.generator, device=dev)
    P = {n: p.detach().requires_grad_(True) for n, p in st.params.items()}
    K = st.K

    # pass 3's march of every ray: the mean count, and the eikonal term's
    # denominator over the rays in the loss
    with torch.no_grad():
        nears, fars = M.near_far(rays_o, rays_d, spec["bound"], spec["min_near"])
        *_, mask3, counts3 = march(spec, st.bitfield, rays_o, rays_d, nears, fars, K,
                                   spec["max_steps"], spec["early_stop_steps"], noise[2])
    n_loss = N // 2 if half_batch else N
    n_eik = mask3[:n_loss].sum().clamp_min(1)
    block = block_rays if block_rays > 0 else n_loss
    grads = {n: torch.zeros_like(p) for n, p in P.items()}
    loss = torch.zeros((), device=dev)
    opened = 0
    for a in range(0, n_loss, block):
        s = slice(a, min(a + block, n_loss))
        out = render_indirect(spec, P, st.bitfield, rays_o[s], rays_d[s], bg[s], K, noise[:, s],
                              st.cos_anneal)
        part = spec["color_loss_weight"] * (out["image"] - gt[s]).abs().sum() / (3 * n_loss)
        ws = out["weights_sum"].clamp(1e-3, 1.0 - 1e-3)
        bce = -(alpha[s] * torch.log(ws) + (1.0 - alpha[s]) * torch.log(1.0 - ws)).sum()
        part = part + spec["mask_loss_weight"] * bce / n_loss
        norms = torch.linalg.vector_norm(out["sdf_gradients"], dim=-1)
        eik = torch.where(out["mask"], (norms - 1.0) ** 2, torch.zeros((), device=dev)).sum()
        part = part + spec["eikonal_loss_weight"] * eik / n_eik
        gs = torch.autograd.grad(part, list(P.values()), allow_unused=True)
        for n, g in zip(P, gs):
            if g is not None:
                grads[n] += g
        loss = loss + part.detach()
        opened += int(out["renv_gate"].sum())
        del out, part, gs
    adam_step(spec, st, grads)
    mc = counts3.float().mean().double()
    prev = st.mean_count_t if st.mean_count_t is not None else torch.tensor(
        st.mean_count, dtype=torch.float64, device=dev)
    st.mean_count_t = torch.where(prev < 0, mc, 0.9 * prev + 0.1 * mc)
    st.global_step += 1
    return {"loss": loss, "grads": grads, "K": K, "renv_open": opened}

"""Plain PyTorch reference of ENVIDR's scene model and train step, for the
two configurations the benchmark runs.

It follows the published model (NeuS/VolSDF SDF with a CP or tiled
hash-grid position encoder, IDE-encoded reflected direction into a neural
environment MLP, diffuse and specular colour MLPs, occupancy-grid march,
alpha compositing, L1 colour + mask BCE + eikonal loss, Adam with per-group
clipping and an exponential lr decay, a per-step EMA) as a handful of
functions over a flat dict of parameters.  It imports neither JAX nor the
program under test; where it has to round as the program's stated precision
rounds (the CP encoder's bf16 interpolation) it writes the rounding out.

Departures from a straight transcription, each for a reason:
  * the tiled hash grid reads its 8 corners with 8 ``index_select`` calls
    on the flat table (index ``(x + y*res + z*res^2) mod size`` of the
    corner), differentiated by autograd to second order: the program's
    corner-blocked table and hand-written VJP compute the same sums;
  * ``precision="tf32"`` rounds every matmul operand to TF32 (10 mantissa
    bits), the control that a lower precision has to fail.

All sizes and flags come from ``options``, the configuration file's dict;
a key the reference needs and the file lacks raises ``KeyError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

SQRT3 = 3.0 ** 0.5
TF32_DROP = 13                       # mantissa bits fp32 keeps beyond TF32's 10


def _tf32_bits(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().contiguous().view(torch.int32)
    i = (i + (1 << (TF32_DROP - 1))) & ~((1 << TF32_DROP) - 1)
    return i.view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """Rounds to TF32 (nearest, ties away from zero), kept as float32; the
    gradient that flows back through it is rounded alike, to any order, as
    the TF32 matmuls of a backward would read it."""

    @staticmethod
    def forward(ctx, x):
        return _tf32_bits(x)

    @staticmethod
    def backward(ctx, g):
        return _RoundTF32.apply(g)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    return _RoundTF32.apply(x)


# what the reference implements of the options it does not read for sizes
REQUIRED = {
    "use_sdf": True, "use_diffuse": True, "diffuse_with_env": True,
    "diffuse_env_fusion": "concat", "split_diffuse_env": False, "use_env_net": True,
    "use_reflected_dir": True, "use_n_dot_viewdir": True, "wo_viewdir": True,
    "normal_with_mlp": True, "multires_normal": 0, "encoding_dir": "frequency",
    "encoding_ref": "integrated_dir", "ensemble_mlp": True, "use_roughness": True,
    "learn_indir_blend": False, "geo_feat_act": "unitNorm", "env_feat_act": "unitNorm",
    "color_act": "sigmoid", "intensity_scale": 1.0, "light_intensity_scale": 1.0,
    "env_wo_bias": False, "mlp_bias": True, "detach_normal": False,
    "numerical_normals": False, "geometric_init": False, "color_net_start_iter": 0,
    "color_space": "srgb", "marching_aabb": [], "dt_gamma": 0.0,
    "stratified_sampling": False, "error_map": False, "patch_size": 1, "image_batch": 1,
    "enabled_levels": -1, "normal_anneal_iters": 0, "bg_radius": -1.0, "color_loss": "l1",
    "samples_budget": -1, "update_extra_before": -1, "beta_cap_sched": [],
    "beta_min_sched": [], "bound": 1.0, "mask_loss_start_iter": 0,
    "eikonal_loss_start_iter": 0,
}


@dataclass
class Spec:
    """The configuration as the reference reads it."""

    options: dict
    precision: str = "float32"        # "float32" | "tf32" (the control)
    o: dict = field(init=False)

    def __post_init__(self):
        self.o = dict(self.options)
        o = self.o
        wrong = {k: o.get(k) for k, v in REQUIRED.items() if o.get(k) != v}
        if wrong:
            raise ValueError(f"reference: options it does not implement: {wrong}")
        if o["encoding_pos"] not in ("cp", "rolled_tiled"):
            raise ValueError(f"reference: encoding_pos {o['encoding_pos']!r}")
        L, base, des = o["num_levels"], o["base_resolution"], o["desired_resolution"]
        s = float(np.exp2(np.log2(int(o["bound"] * des) / base) / max(L - 1, 1)))
        self.scales, self.res = [], []
        for lvl in range(L):
            sc = float(np.exp2(lvl * np.log2(s)) * base - 1.0)
            self.scales.append(sc)
            self.res.append(int(np.ceil(sc)) + 1)
        cap = 2 ** o["log2_hashmap_size"]
        self.sizes = [min(cap, r ** 3) for r in self.res]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).tolist()

    def __getitem__(self, k):
        return self.o[k]


def mm(spec: Spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if spec.precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def linear(spec: Spec, P, name: str, x: torch.Tensor) -> torch.Tensor:
    w = P[f"{name}.weight"]
    if spec.precision == "tf32":
        x, w = round_tf32(x), round_tf32(w)
    return F.linear(x, w, P.get(f"{name}.bias"))


def mlp(spec: Spec, P, name: str, n_layers: int, x: torch.Tensor) -> torch.Tensor:
    for i in range(n_layers):
        x = linear(spec, P, f"{name}.{i}", x)
        if i < n_layers - 1:
            x = F.relu(x)
    return x


def unit_norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def safe_normalize(v: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    return v * torch.rsqrt((v * v).sum(dim=-1, keepdim=True) + eps * eps)


# ------------------------------------------------------------------ encoders

def cp_encode(spec: Spec, P, x01: torch.Tensor) -> torch.Tensor:
    """CP encoder, [B, 3] in [0, 1] -> [B, L*C]; per level and axis a lerp
    of two table rows, the three axes multiplied, a [rank, C] projection.
    bf16: the weights ``w1 = bf16(frac)``, ``w0 = bf16(1 - w1)`` and the
    rows ``bf16(T)`` as the JAX two-hot bf16 matmul rounds them; each cast
    is in the autograd graph, so the gradients round there too."""
    bf16 = spec["cp_compute_dtype"] == "bfloat16"
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1, keepdim=True)
    feats = []
    for lvl in range(spec["num_levels"]):
        R, scale = spec.res[lvl], spec.scales[lvl]
        prod = None
        for a in range(3):
            table = P[f"encoder.axes.{lvl}.{a}"]
            pos = x01[:, a] * scale
            i0f = torch.clamp(torch.floor(pos.detach()), 0, R - 2)
            i0 = i0f.long()
            frac = pos - i0f
            if bf16:
                w1 = frac.to(torch.bfloat16)
                w0 = (1.0 - w1).float()
                w1 = w1.float()
                table = table.to(torch.bfloat16).float()
            else:
                w0, w1 = 1.0 - frac, frac
            f = w0[:, None] * table.index_select(0, i0) + w1[:, None] * table.index_select(0, i0 + 1)
            prod = f if prod is None else prod * f
        feats.append(mm(spec, prod, P[f"encoder.proj.{lvl}"]))
    out = torch.cat(feats, dim=-1)
    return torch.where(oob, torch.zeros((), device=out.device), out)


_CORNERS = [(c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8)]


def tiled_hash_encode(spec: Spec, P, x01: torch.Tensor) -> torch.Tensor:
    """Tiled hash grid with smoothstep weights, [B, 3] -> [B, L*C]: corner
    (cx, cy, cz) of a sample's cell reads row ``(x+cx + (y+cy)*res +
    (z+cz)*res^2) mod size`` of its level's slice of the flat table; the 8
    weighted rows are summed in one reduction over the corner axis."""
    emb = P["encoder.embeddings"]
    dev = x01.device
    L, C = spec["num_levels"], spec["level_dim"]
    B = x01.shape[0]
    scales = torch.tensor(spec.scales, dtype=x01.dtype, device=dev)[:, None, None]
    res = torch.tensor(spec.res, device=dev)[:, None, None]
    size = torch.tensor(spec.sizes, device=dev)[:, None, None]
    off = torch.tensor(spec.offsets[:-1], device=dev)[:, None, None]
    corner = torch.tensor(_CORNERS, device=dev)                         # [8, 3]
    pos = x01[None] * scales                                            # [L, B, 3]
    pg = torch.floor(pos)
    f = pos - pg
    s = f * f * (3.0 - 2.0 * f)
    c = pg.long()[:, :, None, :] + corner                               # [L, B, 8, 3]
    idx = torch.remainder(c[..., 0] + c[..., 1] * res + c[..., 2] * res * res, size) + off
    s4 = s[:, :, None, :]
    sel = torch.where(corner.bool(), s4, 1.0 - s4)                      # [L, B, 8, 3]
    w = sel[..., 0] * sel[..., 1] * sel[..., 2]                         # [L, B, 8]
    rows = emb.index_select(0, idx.reshape(-1)).reshape(L, B, 8, C)
    out = (w[..., None] * rows).sum(dim=2).transpose(0, 1).reshape(B, L * C)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1, keepdim=True)
    return torch.where(oob, torch.zeros((), device=dev), out)


# ------------------------------------------------------------ the networks

def geometry(spec: Spec, P, xyz: torch.Tensor) -> Dict[str, torch.Tensor]:
    """SDF, geometry feature and roughness at world points [..., 3]."""
    b = spec["bound"]
    x01 = ((xyz + b) / (2.0 * b)).reshape(-1, 3)
    enc = cp_encode if spec["encoding_pos"] == "cp" else tiled_hash_encode
    h = enc(spec, P, x01).reshape(*xyz.shape[:-1], -1)
    h = mlp(spec, P, "sdf_net", spec["num_layers"], h)
    g = spec["geo_feat_dim"]
    raw = h[..., 1 + g:2 + g]
    return {"sdf": h[..., 0], "geo_feat": unit_norm(h[..., 1:1 + g]),
            "roughness": spec["roughness_act_scale"] * F.softplus(raw - 1.0)
            * spec["roughness_scale"]}


def neus_alpha(P, sdf, dirs=None, dists=None, grads=None, cos_anneal_ratio=1.0):
    inv_s = torch.clamp(torch.exp(P["sdf_density.variance"] * 10.0), 1e-6, 1e6)
    if grads is not None:
        true_cos = (dirs * grads).sum(dim=-1)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                     + torch.relu(-true_cos) * cos_anneal_ratio)
        est_next = sdf + iter_cos * dists * 0.5
        est_prev = sdf - iter_cos * dists * 0.5
    else:
        est_next = sdf - dists * 0.5
        est_prev = sdf + dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)


def laplace_beta(spec: Spec, P):
    beta = P["sdf_density.beta"]
    b = beta.detach()
    return beta + (b.clamp(spec["beta_min"], spec["beta_max"]) - b)


def laplace_density(sdf, beta):
    return (1.0 / beta) * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() / beta))


def grid_density(spec: Spec, P, xyz: torch.Tensor) -> torch.Tensor:
    """The occupancy grid's density: NeuS's alpha of one default step
    (2 sqrt(3) / 1024, no normals) or the Laplace density."""
    sdf = geometry(spec, P, xyz)["sdf"]
    if spec["use_neus_sdf"]:
        return neus_alpha(P, sdf, dists=2.0 * SQRT3 / 1024.0)
    return laplace_density(sdf, laplace_beta(spec, P))


def _ide_tables(deg: int):
    ml = [(m, 2 ** i) for i in range(deg) for m in range(2 ** i + 1)]
    ml = np.array(ml, dtype=np.int64).T
    l_max = 2 ** (deg - 1)
    mat = np.zeros((l_max + 1, ml.shape[1]))
    for i, (m, l) in enumerate(ml.T):
        for k in range(l - m + 1):
            binom = np.prod(0.5 * (l + k + m - 1.0) - np.arange(l)) / math.factorial(l)
            legendre = ((-1) ** m * 2 ** l * math.factorial(l) / math.factorial(k)
                        / math.factorial(l - k - m) * binom)
            mat[k, i] = math.sqrt((2.0 * l + 1.0) * math.factorial(l - m)
                                  / (4.0 * math.pi * math.factorial(l + m))) * legendre
    return ml, mat, 0.5 * ml[1] * (ml[1] + 1)


def ide(spec: Spec, d: torch.Tensor, kappa_inv) -> torch.Tensor:
    """Integrated directional encoding (Ref-NeRF eqs. 6-8) of unit
    directions [..., 3], (x + iy)^m by the complex recurrence."""
    ml, mat, sigma = _ide_tables(spec["sh_degree"])
    dev, dt = d.device, d.dtype
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    y = y + ((x == 0) & (y == 0)).to(dt)
    zp = [torch.ones_like(z)]
    for _ in range(mat.shape[0] - 1):
        zp.append(zp[-1] * z)
    zc = mm(spec, torch.cat(zp, dim=-1), torch.tensor(mat, dtype=dt, device=dev))
    re, im = [torch.ones_like(x)], [torch.zeros_like(x)]
    for _ in range(int(ml[0].max())):
        re.append(re[-1] * x - im[-1] * y)
        im.append(re[-2] * y + im[-1] * x)
    m_idx = torch.tensor(ml[0], device=dev)
    vre = torch.cat(re, dim=-1).index_select(-1, m_idx)
    vim = torch.cat(im, dim=-1).index_select(-1, m_idx)
    kinv = kappa_inv if torch.is_tensor(kappa_inv) else torch.tensor(kappa_inv, dtype=dt,
                                                                     device=dev)
    scaled = zc * torch.exp(-torch.tensor(sigma, dtype=dt, device=dev) * kinv)
    return torch.cat([vre * scaled, vim * scaled], dim=-1)


def color(spec: Spec, P, geo_feat, normals, dirs, roughness):
    """Diffuse (env feature of the normal's IDE) plus specular (env feature
    of the reflected direction's IDE, normal, n.w_o) colour."""
    w_o = -dirs
    w_r = 2.0 * (w_o * normals).sum(dim=-1, keepdim=True) * normals - w_o
    n_env = ide(spec, normals, spec["diffuse_kappa_inv"])
    w_r_enc = ide(spec, w_r, roughness)
    env = spec["num_layers_env"]
    nenv = unit_norm(mlp(spec, P, "env_net", env, n_env))
    c_diffuse = torch.sigmoid(mlp(spec, P, "diffuse_net", spec["num_layers_diffuse"],
                                  torch.cat([geo_feat, nenv], dim=-1)))
    env_feat = unit_norm(mlp(spec, P, "env_net", env, w_r_enc))
    n_dot = (normals * w_o).sum(dim=-1, keepdim=True)
    c_spec = torch.sigmoid(mlp(spec, P, "color_net", spec["num_layers_color"],
                               torch.cat([geo_feat, normals, env_feat, n_dot], dim=-1)))
    return c_diffuse + c_spec


# -------------------------------------------------------------------- march

def near_far(rays_o, rays_d, bound: float, min_near: float):
    aabb = torch.tensor([-bound] * 3 + [bound] * 3, device=rays_o.device)
    tiny = torch.where(rays_d >= 0, 1e-15, -1e-15)
    inv_d = 1.0 / torch.where(rays_d.abs() > 1e-15, rays_d, tiny)
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = far < near
    big = torch.full_like(near, 1e10)
    near = torch.where(miss, big, near.clamp_min(min_near))
    far = torch.where(miss, big, torch.maximum(far, near))
    return near, far


def _cell(c, H):
    return (c[..., 0] * H + c[..., 1]) * H + c[..., 2]


def _first_k(sel, ts, dts, xyz, K: int, k_eff: int):
    """The first ``k_eff`` selected candidates of each ray, in order, in K slots."""
    order = torch.cumsum(sel.int(), dim=-1) - 1
    sel = sel & (order < k_eff)
    counts = sel.sum(dim=-1)
    C = sel.shape[1]
    j = torch.arange(C, dtype=torch.int32, device=sel.device)[None, :]
    keys = torch.where(sel, C - j, torch.zeros_like(j))
    top, idx = torch.topk(keys, min(K, C), dim=-1, sorted=True)
    if K > C:
        top, idx = F.pad(top, (0, K - C)), F.pad(idx, (0, K - C))
    mask = top > 0
    zero = torch.zeros((), device=sel.device)

    def take(src):
        return torch.where(mask, torch.gather(src, 1, idx), zero)

    xyz_c = torch.stack([take(xyz[..., i]) for i in range(3)], dim=-1)
    return xyz_c, take(dts), mask, counts


def march(spec: Spec, bitfield, rays_o, rays_d, nears, fars, K: int, noise=None):
    """Samples of the first K occupied cells along each ray of the fixed
    ``max_steps`` ladder (capped at ``early_stop_steps``); with
    ``coarse_march`` the candidates come from the first M positive segments
    of a stride-S probe of the dilated, 4x max-pooled grid.  One cascade."""
    H, T, b = 128, spec["max_steps"], spec["bound"]
    N, dev = rays_o.shape[0], rays_o.device
    dt_min = 2.0 * SQRT3 / T
    ess = spec["early_stop_steps"]
    k_eff = K if ess <= 0 else min(K, ess)
    o, d = rays_o.detach(), rays_d.detach()
    t0 = nears if noise is None else nears + dt_min * noise
    occ_grid = bitfield[0]
    S = min(8, int(2.0 * b / (H // 4) / dt_min - 1e-6))
    if not spec["coarse_march"]:
        if noise is not None:      # clip(t0 * 0, dt_min, dt_max) * noise
            t0 = nears + torch.clamp(nears * 0.0, dt_min, 2.0 * SQRT3 / H) * noise
        ts = t0[:, None] + torch.arange(T, dtype=torch.float32, device=dev)[None] * dt_min
        dts = torch.full((N, T), dt_min, device=dev)
        valid = ts < fars[:, None]
        xyz = torch.clamp(o[:, None] + ts[..., None] * d[:, None], -b, b)
        cell = torch.clamp((0.5 * (xyz / b + 1.0) * H).long(), 0, H - 1)
        sel = occ_grid[_cell(cell, H)] & valid
        return _first_k(sel, ts, dts, xyz, K, k_eff)
    Hc = H // 4
    Tc = -(-T // S)
    M = min(Tc, max(16, -(-2 * k_eff // S), -(-K // S)))
    g = F.max_pool3d(occ_grid.reshape(1, 1, H, H, H).float(), 4)
    coarse = (F.max_pool3d(g, 3, stride=1, padding=1)[0, 0] > 0.0).reshape(-1)
    jc = torch.arange(Tc, dtype=torch.float32, device=dev)
    ts_seg = t0[:, None] + jc[None] * (S * dt_min)
    xyz_p = torch.clamp(o[:, None] + ts_seg[..., None] * d[:, None], -b, b)
    cell_p = torch.clamp((0.5 * (xyz_p / b + 1.0) * Hc).int(), 0, Hc - 1).long()
    occ_seg = coarse[_cell(cell_p, Hc)] & (ts_seg < fars[:, None])
    order_c = torch.cumsum(occ_seg.int(), dim=-1) - 1
    sel_c = occ_seg & (order_c < M)
    jci = torch.arange(Tc, dtype=torch.int32, device=dev)[None]
    top_c, seg = torch.topk(torch.where(sel_c, Tc - jci, torch.zeros_like(jci)), M, dim=-1,
                            sorted=True)
    js = torch.arange(S, dtype=torch.float32, device=dev)
    ts = t0[:, None, None] + (seg.float() * S)[..., None] * dt_min + js[None, None] * dt_min
    valid = ((top_c > 0)[..., None] & (ts < fars[:, None, None])).reshape(N, M * S)
    ts = ts.reshape(N, M * S)
    lad = (seg[..., None] * S + torch.arange(S, device=dev)[None, None]).reshape(N, M * S)
    valid = valid & (lad < T)
    dts = torch.full((N, M * S), dt_min, device=dev)
    xyz = torch.clamp(o[:, None] + ts[..., None] * d[:, None], -b, b)
    cell = torch.clamp((0.5 * (xyz / b + 1.0) * H).int(), 0, H - 1).long()
    sel = occ_grid[_cell(cell, H)] & valid
    return _first_k(sel, ts, dts, xyz, K, k_eff)


# ------------------------------------------------------------------- render

def render(spec: Spec, P, bitfield, rays_o, rays_d, bg, K: int, *, noise=None,
           training=False, cos_anneal_ratio=1.0) -> Dict[str, torch.Tensor]:
    """March, geometry with normals (autograd; with ``training`` the
    gradient stays differentiable for the eikonal term), NeuS alpha or
    Laplace density, colour, composite on ``bg`` [N, 3]."""
    nears, fars = near_far(rays_o, rays_d, spec["bound"], spec["min_near"])
    xyzs, dts, mask, counts = march(spec, bitfield, rays_o, rays_d, nears, fars, K,
                                            noise)
    dirs = rays_d[:, None, :].expand_as(xyzs)
    with torch.enable_grad():
        pts = xyzs.detach().requires_grad_(True)
        geo = geometry(spec, P, pts)
        (grads,) = torch.autograd.grad(geo["sdf"].sum(), pts, create_graph=training)
    if not training:
        geo = {k: v.detach() for k, v in geo.items()}
        grads = grads.detach()
    normals = safe_normalize(grads)
    sdf = geo["sdf"]
    zero = torch.zeros((), device=sdf.device)
    if spec["use_neus_sdf"]:
        alphas = torch.where(mask, neus_alpha(P, sdf, dirs, dts, normals, cos_anneal_ratio), zero)
    else:
        sig = torch.where(mask, laplace_density(sdf, laplace_beta(spec, P)), zero)
        alphas = 1.0 - torch.exp(-dts * sig)
    one_minus = 1.0 - alphas + 1e-15
    T = torch.cumprod(torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]],
                                dim=-1), dim=-1)
    w = alphas * T
    w = torch.where(T > spec["T_thresh"], w, torch.zeros_like(w))
    w = torch.where(mask, w, zero)
    ws = w.sum(dim=-1)
    rgb = color(spec, P, geo["geo_feat"], normals, dirs, geo["roughness"])
    image = (w[..., None] * rgb).sum(dim=-2) + (1.0 - ws[..., None]) * bg
    return {"image": image, "weights_sum": ws,
            "sdf_gradients": torch.where(mask[..., None], grads, zero), "mask": mask,
            "counts": counts}


def loss_fn(spec: Spec, out, gt_rgb, alpha_mask):
    """L1 colour + mask BCE + eikonal (masked mean over marched samples)."""
    loss = spec["color_loss_weight"] * (out["image"] - gt_rgb).abs().mean()
    ws = out["weights_sum"].clamp(1e-3, 1.0 - 1e-3)
    bce = -(alpha_mask * torch.log(ws) + (1.0 - alpha_mask) * torch.log(1.0 - ws)).mean()
    loss = loss + spec["mask_loss_weight"] * bce
    norms = torch.linalg.vector_norm(out["sdf_gradients"], dim=-1)
    m = out["mask"]
    eik = (torch.where(m, (norms - 1.0) ** 2, torch.zeros((), device=norms.device)).sum()
           / m.sum().clamp_min(1))
    return loss + spec["eikonal_loss_weight"] * eik


def pixel_rays(poses, intrinsics, W: int, inds):
    fx, fy, cx, cy = intrinsics
    i = (inds % W).float() + 0.5
    j = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], dim=-1)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ poses[:, :3, :3].transpose(-1, -2)
    return poses[:, None, :3, 3].expand_as(rays_d), rays_d


# -------------------------------------------------------------- the trainer

GROUP_OF = {"encoder": "grid", "sdf_density": "scalar", "env_net": "env"}
B1, B2, EPS, CLIP, EMA = 0.9, 0.99, 1e-15, 10.0, 0.95


@dataclass
class State:
    """Everything a train step reads and writes."""

    params: Dict[str, torch.Tensor]
    ema: Dict[str, torch.Tensor]
    density: torch.Tensor           # [1, 128^3]
    bitfield: torch.Tensor          # [1, 128^3] bool
    iter_density: int
    global_step: int
    epoch: int
    mean_count: float               # < 0: none yet
    generator: torch.Generator
    seed: int
    m: Dict[str, torch.Tensor] = field(default_factory=dict)
    v: Dict[str, torch.Tensor] = field(default_factory=dict)
    count: int = 0                  # Adam's bias-correction count
    sched_count: int = 0            # the lr decay's count
    order: List[int] = field(default_factory=list)
    K: int = 0
    cos_anneal: float = 1.0
    mean_count_t: Optional[torch.Tensor] = None


def update_grid(spec: Spec, st: State, chunk: int = 2 ** 17):
    """The jittered re-sweep: whole grid for the first 16 updates, then a
    rotating quarter slab; EMA-max, threshold at min(mean, density_thresh)."""
    H, b = 128, spec["bound"]
    dev = st.density.device
    r = torch.arange(H, device=dev)
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    coords = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)
    fraction = 1 if st.iter_density < 16 else 4
    n_slab = coords.shape[0] // fraction
    slab = (st.iter_density % fraction) * n_slab if fraction > 1 else 0
    coords = coords[slab:slab + n_slab]
    half = b / H
    sig = []
    with torch.no_grad():
        for s in range(0, n_slab, chunk):
            c = coords[s:s + chunk]
            jit = torch.rand(c.shape, generator=st.generator, device=dev)
            xyz = (2.0 * c.float() / (H - 1) - 1.0) * (b - half) + (jit * 2.0 - 1.0) * half
            sig.append(grid_density(spec, st.params, xyz))
    tmp = torch.cat(sig)[None]
    if fraction == 1:
        old = st.density
        valid = (old >= 0) & (tmp >= 0)
        dens = torch.where(valid, torch.maximum(old * 0.95, tmp), old)
    else:
        dens = torch.where(st.density >= 0, st.density * 0.95, st.density)
        old = dens[:, slab:slab + n_slab]
        valid = (old >= 0) & (tmp >= 0)
        dens[:, slab:slab + n_slab] = torch.where(valid, torch.maximum(old, tmp), old)
    thresh = torch.clamp(dens.clamp_min(0.0).mean(), max=spec["density_thresh"])
    st.density, st.bitfield, st.iter_density = dens, dens > thresh, st.iter_density + 1


def sample_budget(spec: Spec, mean_count: float) -> int:
    cap = spec["early_stop_steps"]
    est = cap if mean_count <= 0 else int(mean_count * 1.5) + 8
    floor = min(max(16, spec["min_samples_budget"]), max(cap, 16))
    k = floor
    while k < min(est, cap):
        k *= 2
    return int(min(k, max(cap, floor), 1024))


def eval_budget(spec: Spec, mean_count: float) -> int:
    cap = spec["early_stop_steps"]
    K = min(spec["eval_samples_budget"], max(cap, 16))
    if mean_count > 0:
        est = min(int(mean_count * 1.5) + 8, cap)
        k = max(16, spec["min_samples_budget"])
        while k < est:
            k *= 2
        K = min(K, k)
    return int(K)


def adam_step(spec: Spec, st: State, grads: Dict[str, torch.Tensor]):
    """Per-group clip to norm 10, Adam(0.9, 0.99, 1e-15), lr decayed by
    0.1^(count/iters), skipped whole if a gradient is not finite; EMA."""
    lrs = {"net": spec["lr"], "grid": spec["plr"] or spec["lr"],
           "scalar": spec["slr"] or spec["lr"], "env": spec["elr"] or spec["lr"]}
    names = list(st.params)
    if not all(bool(torch.isfinite(grads[n]).all()) for n in names):
        return False
    count = st.count + 1
    dev = next(iter(st.params.values())).device
    cnt = torch.tensor(count, dtype=torch.float32, device=dev)
    bc1, bc2 = 1.0 - B1 ** cnt, 1.0 - B2 ** cnt
    decay = 0.1 ** torch.clamp(torch.tensor(st.sched_count, dtype=torch.float32, device=dev)
                               / spec["iters"], max=1.0)
    with torch.no_grad():
        for grp, lr in lrs.items():
            members = [n for n in names if GROUP_OF.get(n.split(".")[0], "net") == grp]
            if not members:
                continue
            norm = torch.linalg.vector_norm(torch.stack([grads[n].norm() for n in members]))
            scale = torch.where(norm < CLIP, 1.0, CLIP / norm)
            for n in members:
                g = grads[n] * scale
                m = g * (1.0 - B1) + st.m[n] * B1
                v = g * g * (1.0 - B2) + st.v[n] * B2
                upd = (m / bc1) / (torch.sqrt(v / bc2) + EPS) * decay * (-lr)
                st.params[n] = (st.params[n] + upd).detach()
                st.m[n], st.v[n] = m, v
        for n in names:
            st.ema[n] = st.ema[n] + (st.params[n] - st.ema[n]) * (1.0 - EMA)
    st.count, st.sched_count = count, st.sched_count + 1
    return True


def train_step(spec: Spec, st: State, scene, *, half_batch: bool = False) -> Dict:
    """One step on the next view of the epoch's shuffled order, drawing as
    the program's trainer draws: the epoch's order from
    ``default_rng(seed * 100003 + epoch)``, then from the step's generator
    the grid jitter (every ``update_extra_interval`` steps), the pixels,
    the background (``alpha_bg_mode = random``) and the march's offset.
    ``half_batch`` (a fault) takes the loss over the first half of the rays."""
    if not st.order:
        st.epoch += 1
        if st.mean_count_t is not None:
            st.mean_count = float(st.mean_count_t)
        st.K = sample_budget(spec, st.mean_count)
        st.cos_anneal = (min(1.0, st.global_step / spec["cos_anneal_steps"])
                         if spec["use_neus_sdf"] and spec["cos_anneal_steps"] > 0
                         else spec["cos_anneal_ratio"])
        idx = np.arange(len(scene))
        np.random.default_rng(st.seed * 100003 + st.epoch).shuffle(idx)
        st.order = [int(i) for i in idx]
    view = st.order.pop(0)
    every = spec["update_extra_interval"]
    if every > 0 and st.global_step % every == 0:
        update_grid(spec, st)
    dev = st.density.device
    N, H, W = spec["num_rays"], scene.H, scene.W
    pose = torch.as_tensor(scene.poses[view], device=dev)[None]
    inds = torch.randint(0, H * W, (N,), generator=st.generator, device=dev)
    rays_o, rays_d = pixel_rays(pose, scene.intrinsics, W, inds[None])
    rays_o, rays_d = rays_o[0], rays_d[0]
    pix = torch.as_tensor(scene.images[view].reshape(H * W, 4), device=dev)[inds].float() / 255
    if spec["alpha_bg_mode"] == "white":
        bg = torch.ones((N, 3), device=dev)
    else:
        bg = torch.rand((N, 3), generator=st.generator, device=dev)
    gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
    noise = torch.rand((N,), generator=st.generator, device=dev)
    P = {n: p.detach().requires_grad_(True) for n, p in st.params.items()}
    out = render(spec, P, st.bitfield, rays_o, rays_d, bg, st.K, noise=noise, training=True,
                 cos_anneal_ratio=st.cos_anneal)
    if half_batch:
        keep = slice(0, N // 2)
        out = {k: v[keep] for k, v in out.items()}
        gt, alpha = gt[keep], pix[keep, 3]
    else:
        alpha = pix[:, 3]
    loss = loss_fn(spec, out, gt, alpha)
    gs = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
    grads = {n: (g if g is not None else torch.zeros_like(P[n])) for n, g in zip(P, gs)}
    adam_step(spec, st, grads)
    mc = out["counts"].float().mean().double()
    prev = st.mean_count_t if st.mean_count_t is not None else torch.tensor(
        st.mean_count, dtype=torch.float64, device=dev)
    st.mean_count_t = torch.where(prev < 0, mc, 0.9 * prev + 0.1 * mc)
    st.global_step += 1
    return {"loss": loss.detach(), "grads": grads, "K": st.K}

"""Occupancy-accelerated ray marching with a fixed sample budget (dense form).

Counterpart of ``envidr_tpu/ops/marching.py:march_rays`` without
``coarse_march``.  The ``t`` ladder of the reference's march is fixed
whatever the occupancy, so the sample set is: the full T-step candidate
ladder per ray, one occupancy lookup per candidate, then the first K
occupied candidates per ray (capped at ``early_stop_steps``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from envidr_tpu_torch.ops.grid import cell_index

SQRT3 = 3.0**0.5


class MarchResult(NamedTuple):
    xyzs: torch.Tensor    # [N, K, 3] sample positions (0 where invalid)
    dirs: torch.Tensor    # [N, 3]
    dts: torch.Tensor     # [N, K] step sizes
    z_vals: torch.Tensor  # [N, K] t + dt - near
    ts: torch.Tensor      # [N, K] raw t of each sample
    mask: torch.Tensor    # [N, K] bool sample validity
    counts: torch.Tensor  # [N] samples per ray


def march_rays(rays_o, rays_d, nears, fars, bitfield, *, bound: float,
               grid_size: int = 128, dt_gamma: float = 0.0, max_steps: int = 1024,
               num_samples: int = 128, early_stop_steps: int = -1,
               noise: Optional[torch.Tensor] = None) -> MarchResult:
    """``noise`` [N] in [0, 1) shifts each ray's start by a fraction of one
    step (the reference's perturbation); None marches from ``nears``.
    Only the constant-step ladder (``dt_gamma == 0``) is ported."""
    if dt_gamma != 0.0:
        raise NotImplementedError("dt_gamma > 0 (growing march steps) is not ported yet")
    N = rays_o.shape[0]
    T, K, H = max_steps, num_samples, grid_size
    cascades = bitfield.shape[0]
    dt_min = 2.0 * SQRT3 / max_steps
    o, d = rays_o.detach(), rays_d.detach()
    nears, fars = nears.detach(), fars.detach()

    t0 = nears
    if noise is not None:
        t0 = t0 + dt_min * noise

    steps = torch.arange(T, dtype=torch.float32, device=o.device)
    ts = t0[:, None] + steps[None, :] * dt_min
    dts = torch.full((N, T), dt_min, dtype=torch.float32, device=o.device)

    valid = ts < fars[:, None]
    xyz = torch.clamp(o[:, None, :] + ts[..., None] * d[:, None, :], -bound, bound)
    if cascades > 1:
        mx = xyz.abs().amax(dim=-1)
        # frexp exponent: mx in [2^(e-1), 2^e) -> e  (raymarching.cu:42-47)
        exp_pos = torch.frexp(mx.clamp_min(1e-10)).exponent
        exp_dt = torch.frexp((dts * H * 0.5).clamp_min(1e-10)).exponent
        level = torch.clamp(torch.maximum(exp_pos, exp_dt), 0, cascades - 1).long()
    else:
        level = torch.zeros(ts.shape, dtype=torch.long, device=o.device)
    mip_bound = torch.clamp(2.0 ** level.float(), max=bound)
    cell = torch.clamp((0.5 * (xyz / mip_bound[..., None] + 1.0) * H).long(), 0, H - 1)
    flat = level * (H * H * H) + cell_index(cell, H)           # [N, T]
    occ = bitfield.reshape(-1)[flat]

    sel = occ & valid
    order = torch.cumsum(sel.int(), dim=-1) - 1                # rank among selected
    k_eff = K if early_stop_steps <= 0 else min(K, early_stop_steps)
    sel = sel & (order < k_eff)
    counts = sel.sum(dim=-1)

    # compact [N, T] -> [N, K]: key T - j for selected candidates, 0 else;
    # the K largest keys are the first K selected candidates in ray order
    j = torch.arange(T, dtype=torch.int32, device=o.device)[None, :]
    keys = torch.where(sel, T - j, torch.zeros_like(j))
    top_keys, top_idx = torch.topk(keys, min(K, T), dim=-1)
    if K > T:
        pad = (0, K - T)
        top_keys = torch.nn.functional.pad(top_keys, pad)
        top_idx = torch.nn.functional.pad(top_idx, pad)
    mask_c = top_keys > 0

    def compact(src):
        return torch.where(mask_c, torch.gather(src, 1, top_idx), torch.zeros((), device=o.device))

    ts_c = compact(ts)
    dts_c = compact(dts)
    xyz_c = torch.stack([compact(xyz[..., i]) for i in range(3)], dim=-1)
    z_vals = torch.where(mask_c, ts_c + dts_c - nears[:, None], torch.zeros((), device=o.device))
    return MarchResult(xyzs=xyz_c, dirs=d, dts=dts_c, z_vals=z_vals, ts=ts_c,
                       mask=mask_c, counts=counts)

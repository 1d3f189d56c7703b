"""Occupancy-accelerated ray marching with a fixed sample budget.

Counterpart of ``envidr_tpu/ops/marching.py``.  The ``t`` ladder of the
reference's march is fixed whatever the occupancy, so the dense march's
sample set is: the full T-step candidate ladder per ray, one occupancy lookup
per candidate, then the first K occupied candidates per ray (capped at
``early_stop_steps``).  ``coarse_march`` first probes a 4x max-pooled,
Chebyshev-1 dilated copy of the grid every S candidates and fine-probes only
the first M positive segments (:func:`_march_rays_coarse`); where its
conditions do not hold (among them ``dt_gamma > 0``, whose growing steps
only the dense march takes) it falls back to the dense march with a
one-time warning, as the JAX package does.

The march fills each ray's first ``counts`` slots of its K.  A render hands
the per-sample work either every slot (:class:`DenseSlots`) or the filled
slots alone, packed into one flat batch (:class:`SlotPacking`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import collections
import math

import torch
import torch.nn.functional as F

from envidr_tpu_torch import obs
from envidr_tpu_torch.ops.grid import cell_index

SQRT3 = 3.0**0.5
PACK_ROWS = 4096        # a packed batch's rows are a multiple of this
# marches taken by each path since the last reset, {"coarse": n, "dense": n}:
# shows that a run with coarse_march really marched the coarse grid
MARCH_PATHS: collections.Counter = collections.Counter()


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
               noise: Optional[torch.Tensor] = None, t_start: Optional[torch.Tensor] = None,
               coarse_march: bool = False) -> MarchResult:
    """``noise`` [N] in [0, 1) shifts each ray's start by a fraction of its
    first step (the reference's perturbation); None marches from ``nears``,
    or from ``t_start`` [N] where given (a continued march; ``nears`` still
    anchors ``z_vals``).  With ``dt_gamma > 0`` the step grows with the
    distance, ``t += clip(t * dt_gamma, dt_min, dt_max)``, on the dense
    march only: ``coarse_march`` then falls back to it with a warning."""
    cascades = bitfield.shape[0]
    if coarse_march:
        # the union coarse grid needs every cascade's downsample ratio
        # 4*bound/el to divide grid_size; one cascade spans [-bound, bound]
        # only when bound <= 1
        casc_ok = (cascades == 1 and bound <= 1.0) or (
            cascades > 1 and bound > 0 and float(math.log2(bound)).is_integer()
            and grid_size % int(4 * bound) == 0)
        # a coarse cell (the dilation's false-positive shell) small in world units
        cell_ok = (2.0 * bound / max(grid_size // 4, 1)) <= 0.25
        if dt_gamma == 0.0 and grid_size % 4 == 0 and cell_ok and casc_ok:
            # S fine steps stay inside one coarse cell; below 2 nothing is saved
            dt_min = 2.0 * SQRT3 / max_steps
            S = min(8, int(2.0 * bound / (grid_size // 4) / dt_min - 1e-6))
            if S >= 2:
                MARCH_PATHS["coarse"] += 1
                return _march_rays_coarse(
                    rays_o, rays_d, nears, fars, bitfield, bound=bound,
                    grid_size=grid_size, max_steps=max_steps, num_samples=num_samples,
                    early_stop_steps=early_stop_steps, noise=noise, stride=S,
                    t_start=t_start)
        _warn_coarse_fallback(bound, grid_size, dt_gamma, cascades)
    MARCH_PATHS["dense"] += 1
    N = rays_o.shape[0]
    T, K, H = max_steps, num_samples, grid_size
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cascades - 1)) / H
    o, d = rays_o.detach(), rays_d.detach()
    nears, fars = nears.detach(), fars.detach()

    t0 = nears if t_start is None else t_start.detach()
    if noise is not None:
        # clip(t0 * dt_gamma, dt_min, dt_max) as in JAX: dt_max where it is
        # below dt_min (fewer than grid_size max_steps on one cascade)
        t0 = t0 + torch.clamp(t0 * dt_gamma, dt_min, dt_max) * noise

    if dt_gamma == 0.0:
        steps = torch.arange(T, dtype=torch.float32, device=o.device)
        ts = t0[:, None] + steps[None, :] * dt_min
        dts = torch.full((N, T), dt_min, dtype=torch.float32, device=o.device)
    else:       # the ladder, one step at a time (the JAX package's scan)
        t, ts, dts = t0, [], []
        for _ in range(T):
            dt = torch.clamp(t * dt_gamma, dt_min, dt_max)
            ts.append(t)
            dts.append(dt)
            t = t + dt
        ts, dts = torch.stack(ts, dim=1), torch.stack(dts, dim=1)       # [N, T]

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

    return _compact(sel, counts, ts, dts, xyz, d, nears, K)


def _compact(sel, counts, ts, dts, xyz, d, nears, K: int) -> MarchResult:
    """[N, C] candidates -> the first K selected per ray, in ray order: key
    C - j for a selected candidate, 0 else; the K largest keys are the first K
    selected candidates (the JAX package's top_k, on the same unique keys)."""
    C = sel.shape[1]
    j = torch.arange(C, dtype=torch.int32, device=sel.device)[None, :]
    keys = torch.where(sel, C - j, torch.zeros_like(j))
    top_keys, top_idx = torch.topk(keys, min(K, C), dim=-1, sorted=True)
    if K > C:
        pad = (0, K - C)
        top_keys = F.pad(top_keys, pad)
        top_idx = F.pad(top_idx, pad)
    mask_c = top_keys > 0
    zero = torch.zeros((), device=sel.device)

    def compact(src):
        return torch.where(mask_c, torch.gather(src, 1, top_idx), zero)

    ts_c = compact(ts)
    dts_c = compact(dts)
    xyz_c = torch.stack([compact(xyz[..., i]) for i in range(3)], dim=-1)
    z_vals = torch.where(mask_c, ts_c + dts_c - nears[:, None], zero)
    return MarchResult(xyzs=xyz_c, dirs=d, dts=dts_c, z_vals=z_vals, ts=ts_c,
                       mask=mask_c, counts=counts)


class DenseSlots:
    """Every one of the N x K slots is a row of the per-sample work: the
    identity of :class:`SlotPacking`."""

    def __init__(self, N: int, K: int):
        self.N, self.K = N, K

    def gather(self, t):
        return t

    def per_ray(self, t, pad_zero: bool = False):
        return t[:, None].expand((self.N, self.K) + t.shape[1:])

    def slots(self, *vs):
        return vs


class SlotPacking:
    """The filled slots of a march's ``mask`` [N, K] as one flat batch of
    ``rows``, ray-major: row r < ``n`` is the r-th filled slot, and the rest,
    up to a multiple of :data:`PACK_ROWS`, pad the batch as empty slots do
    (position 0, ray 0's direction; their outputs are dropped).  ``n`` is
    read once on the host (``obs.host_sync``), so no filled slot is ever
    left out.  It counts ``march.pack.rows`` and ``march.pack.slots``
    (N x K); its read, gathers and scatters are the span ``march.pack``."""

    def __init__(self, mask: torch.Tensor):
        self.N, self.K = mask.shape
        with obs.span("march.pack"), obs.host_sync():       # the one read: the filled count
            self.filled = torch.nonzero(mask.reshape(-1)).squeeze(1)
            self.n = self.filled.shape[0]
            self.rows = max(1, -(-self.n // PACK_ROWS)) * PACK_ROWS
            # each row's slot and ray; a padding row reads slot 0 of ray 0
            self.slot = F.pad(self.filled, (0, self.rows - self.n))
            self.ray = self.slot // self.K
        obs.count("march.pack.rows", self.rows)
        obs.count("march.pack.slots", self.N * self.K)

    def _padded(self, t, index):
        g = t.index_select(0, index)
        if self.n < self.rows:
            g[self.n:] = 0
        return g

    def gather(self, t):
        """[N, K, ...] -> [rows, ...]: the filled slots, then zeros."""
        with obs.span("march.pack"):
            return self._padded(t.reshape((-1,) + t.shape[2:]), self.slot)

    def per_ray(self, t, pad_zero: bool = False):
        """[N, ...] -> [rows, ...]: each row's ray's; with ``pad_zero`` the
        padding rows read zeros instead of ray 0's."""
        with obs.span("march.pack"):
            return self._padded(t, self.ray) if pad_zero else t.index_select(0, self.ray)

    def slots(self, *vs):
        """Each of ``vs`` [rows, ...] back to [N, K, ...]: a filled slot takes
        its row, an empty one 0 (False); None and numbers pass as they are."""
        with obs.span("march.pack"):
            return tuple(v if not torch.is_tensor(v) else torch.index_put(
                v.new_zeros((self.N * self.K,) + v.shape[1:]), (self.filled,), v[:self.n]
            ).reshape((self.N, self.K) + v.shape[1:]) for v in vs)


_COARSE_FALLBACK_WARNED = set()


def _warn_coarse_fallback(bound, grid_size, dt_gamma, cascades):
    """Print once per configuration that ``coarse_march`` fell back to the
    dense march (the JAX package's message)."""
    key = (bound, grid_size, dt_gamma, cascades)
    if key not in _COARSE_FALLBACK_WARNED:
        _COARSE_FALLBACK_WARNED.add(key)
        print(f"[march] coarse_march requested but falling back to the dense "
              f"march (bound={bound}, grid_size={grid_size}, "
              f"dt_gamma={dt_gamma}, cascades={cascades}): needs dt_gamma==0,"
              f" grid_size%4==0, and power-of-2 bound dividing grid_size/4 "
              f"for multi-cascade")


def _coarse_union_grid(bitfield: torch.Tensor, H: int, Hc: int, bound: float) -> torch.Tensor:
    """Every cascade's occupancy on one [Hc^3] grid over [-bound, bound],
    max-pooled, then dilated by one cell (Chebyshev 1) -> bool [Hc^3].

    Cascade l covers [-el, el], el = min(2^l, bound), so its H^3 grid
    pools by r = 4*bound/el into the central (H/r)^3 block."""
    coarse = torch.zeros((Hc, Hc, Hc), device=bitfield.device)
    for lvl in range(bitfield.shape[0]):
        el = min(2.0 ** lvl, bound)
        r = int(round(4 * bound / el))
        n = H // r
        g = F.max_pool3d(bitfield[lvl].reshape(1, 1, H, H, H).float(), r)[0, 0]
        off = (Hc - n) // 2
        blk = coarse[off:off + n, off:off + n, off:off + n]
        coarse[off:off + n, off:off + n, off:off + n] = torch.maximum(blk, g)
    # 3x3x3 max, stride 1, SAME: max_pool3d pads with -inf
    coarse = F.max_pool3d(coarse[None, None], 3, stride=1, padding=1)[0, 0]
    return (coarse > 0.0).reshape(-1)


def _march_rays_coarse(rays_o, rays_d, nears, fars, bitfield, *, bound: float,
                       grid_size: int, max_steps: int, num_samples: int,
                       early_stop_steps: int, noise: Optional[torch.Tensor],
                       stride: int = 8, t_start: Optional[torch.Tensor] = None) -> MarchResult:
    """Two-level march: probe the coarse grid at every S-th candidate, keep
    each ray's first M positive segments, fine-probe their M*S candidates.

    Exact where M does not bind: the coarse grid is the one-cell dilation of
    the max-pool and S steps stay inside one coarse cell, so no occupied fine
    cell hides from its segment's probe.  Expressions follow the JAX
    package's order (``ts = t0 + (seg*S)*dt_min + j*dt_min``), which rounds
    differently from the dense ladder's ``t0 + (seg*S + j)*dt_min``."""
    N = rays_o.shape[0]
    T, K, H, S = max_steps, num_samples, grid_size, stride
    Hc = H // 4
    dev = rays_o.device
    dt_min = 2.0 * SQRT3 / max_steps
    assert S * dt_min < 2.0 * bound / Hc, (S, dt_min, bound, Hc)
    Tc = -(-T // S)
    k_eff = K if early_stop_steps <= 0 else min(K, early_stop_steps)
    cascades = bitfield.shape[0]
    # M*S covers the K slots with 2x headroom over k_eff for coarse false
    # positives; more cascades, more disjoint occupied regions per ray
    base_m = 16 if cascades == 1 else 24 * cascades
    M = min(Tc, max(base_m, -(-2 * k_eff // S), -(-K // S)))
    o, d = rays_o.detach(), rays_d.detach()
    nears, fars = nears.detach(), fars.detach()

    t0 = nears if t_start is None else t_start.detach()
    if noise is not None:
        t0 = t0 + dt_min * noise

    coarse = _coarse_union_grid(bitfield, H, Hc, bound)           # [Hc^3]

    # coarse probe at segment starts
    jc = torch.arange(Tc, dtype=torch.float32, device=dev)
    ts_seg = t0[:, None] + jc[None, :] * (S * dt_min)              # [N, Tc]
    xyz_p = torch.clamp(o[:, None, :] + ts_seg[..., None] * d[:, None, :], -bound, bound)
    cell_p = torch.clamp((0.5 * (xyz_p / bound + 1.0) * Hc).int(), 0, Hc - 1).long()
    occ_seg = coarse[cell_index(cell_p, Hc)] & (ts_seg < fars[:, None])

    # first M positive segments, in march order
    order_c = torch.cumsum(occ_seg.int(), dim=-1) - 1
    sel_c = occ_seg & (order_c < M)
    jci = torch.arange(Tc, dtype=torch.int32, device=dev)[None, :]
    keys_c = torch.where(sel_c, Tc - jci, torch.zeros_like(jci))
    top_c, seg_idx = torch.topk(keys_c, M, dim=-1, sorted=True)    # [N, M]
    seg_ok = top_c > 0

    # fine candidates of the kept segments: [N, M*S]
    js = torch.arange(S, dtype=torch.float32, device=dev)
    ts = (t0[:, None, None] + (seg_idx.float() * S)[..., None] * dt_min
          + js[None, None, :] * dt_min)
    valid = (seg_ok[..., None] & (ts < fars[:, None, None])).reshape(N, M * S)
    ts = ts.reshape(N, M * S)
    # ladder indices beyond T pad the last, partial segment
    lad = (seg_idx[..., None] * S + torch.arange(S, device=dev)[None, None, :]).reshape(N, M * S)
    valid = valid & (lad < T)
    dts = torch.full((N, M * S), dt_min, dtype=torch.float32, device=dev)

    xyz = torch.clamp(o[:, None, :] + ts[..., None] * d[:, None, :], -bound, bound)
    if cascades > 1:
        # per-candidate mip level, as the dense path picks it (dt is dt_min
        # throughout, so only the position moves the level)
        exp_pos = torch.frexp(xyz.abs().amax(dim=-1).clamp_min(1e-10)).exponent
        exp_dt = math.frexp(max(dt_min * H * 0.5, 1e-10))[1]
        level = torch.clamp(torch.clamp_min(exp_pos, exp_dt), 0, cascades - 1).long()
        mip_bound = torch.clamp(2.0 ** level.float(), max=bound)
        cell = torch.clamp((0.5 * (xyz / mip_bound[..., None] + 1.0) * H).int(), 0, H - 1)
        flat = level * (H * H * H) + cell_index(cell.long(), H)
        occ = bitfield.reshape(-1)[flat]
    else:
        cell = torch.clamp((0.5 * (xyz / bound + 1.0) * H).int(), 0, H - 1)
        occ = bitfield[0][cell_index(cell.long(), H)]                # [N, M*S]

    sel = occ & valid
    order = torch.cumsum(sel.int(), dim=-1) - 1
    sel = sel & (order < k_eff)
    counts = sel.sum(dim=-1)
    return _compact(sel, counts, ts, dts, xyz, d, nears, K)

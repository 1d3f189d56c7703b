"""Multi-cascade occupancy grid: state, EMA-max updates, bit packing.

Counterpart of ``envidr_tpu/ops/grid.py``: row-major cells, a bool occupancy
field beside the float density, and the jittered re-sweep of the reference
(renderer.py:265-358) with its rotating ``fraction`` slab after warm-up.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch


class OccupancyGrid(NamedTuple):
    density: torch.Tensor       # [CAS, H^3] float32; -1 marks untrained cells
    bitfield: torch.Tensor      # [CAS, H^3] bool (occupied)
    mean_density: torch.Tensor  # scalar f32
    iter_density: int           # number of updates so far (host int)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    grid_size: int = 128
    bound: float = 1.0
    density_thresh: float = 0.01
    density_scale: float = 1.0

    @property
    def cascades(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))


def init_grid(spec: GridSpec, device=None) -> OccupancyGrid:
    n = spec.grid_size**3
    return OccupancyGrid(
        density=torch.zeros((spec.cascades, n), dtype=torch.float32, device=device),
        bitfield=torch.zeros((spec.cascades, n), dtype=torch.bool, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=0)


def cell_index(coords: torch.Tensor, H: int) -> torch.Tensor:
    """Row-major flat index of integer cell coords [..., 3]."""
    return (coords[..., 0] * H + coords[..., 1]) * H + coords[..., 2]


def all_cell_coords(H: int, device=None) -> torch.Tensor:
    """[H^3, 3] int64 grid coordinates in row-major order."""
    r = torch.arange(H, device=device)
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def cascade_world_coords(coords: torch.Tensor, cas: int, spec: GridSpec,
                         jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cell coords -> world positions of cascade ``cas``; ``jitter`` in
    [0, 1) moves each point within +-half a cell (renderer.py:292-301)."""
    H = spec.grid_size
    xyzs = 2.0 * coords.float() / (H - 1) - 1.0
    bound = min(2.0**cas, spec.bound)
    half = bound / H
    xyzs = xyzs * (bound - half)
    if jitter is not None:
        xyzs = xyzs + (jitter * 2.0 - 1.0) * half
    return xyzs


def update_grid(grid: OccupancyGrid, spec: GridSpec,
                density_fn: Callable[[torch.Tensor], torch.Tensor],
                generator: Optional[torch.Generator], *, decay: float = 0.95,
                chunk: int = 2**17, fraction: int = 1) -> OccupancyGrid:
    """Jittered sweep + EMA-max + re-threshold.

    ``density_fn``: [M, 3] world xyz -> [M] sigma.  ``generator`` draws the
    jitter (None: cell centres).  With ``fraction > 1`` only a rotating
    1/fraction slab of cells is re-evaluated per call while the decay still
    applies to every trained cell.
    """
    H = spec.grid_size
    dev = grid.density.device
    coords = all_cell_coords(H, dev)
    n = coords.shape[0]
    n_slab = n // fraction
    slab_i = (grid.iter_density % fraction) * n_slab if fraction > 1 else 0
    coords = coords[slab_i:slab_i + n_slab]
    new_density = []
    for cas in range(spec.cascades):
        sigmas = []
        for start in range(0, n_slab, chunk):
            c = coords[start:start + chunk]
            jitter = (None if generator is None else
                      torch.rand(c.shape, generator=generator, device=dev))
            xyzs = cascade_world_coords(c, cas, spec, jitter)
            sigmas.append(density_fn(xyzs) * spec.density_scale)
        new_density.append(torch.cat(sigmas))
    tmp = torch.stack(new_density)                         # [CAS, n_slab]

    if fraction == 1:
        old = grid.density
        valid = (old >= 0) & (tmp >= 0)
        density = torch.where(valid, torch.maximum(old * decay, tmp), old)
    else:
        density = torch.where(grid.density >= 0, grid.density * decay, grid.density)
        old = density[:, slab_i:slab_i + n_slab]
        valid = (old >= 0) & (tmp >= 0)
        density[:, slab_i:slab_i + n_slab] = torch.where(valid, torch.maximum(old, tmp), old)
    mean_density = density.clamp_min(0.0).mean()
    thresh = torch.clamp(mean_density, max=spec.density_thresh)
    return OccupancyGrid(density, density > thresh, mean_density, grid.iter_density + 1)


def mark_untrained(grid: OccupancyGrid, spec: GridSpec, poses: torch.Tensor, intrinsics,
                   *, chunk: int = 2**17) -> OccupancyGrid:
    """Mark the cells that no training camera sees as -1 (renderer.py:200-263).

    ``poses`` [B, 4, 4] c2w, ``intrinsics`` (fx, fy, cx, cy).  The coverage
    test is the reference's axis-aligned field-of-view inequality
    ``|x_cam| < cx / fx * z_cam + 2 * half_cell``, not a projection of the
    cell's corners."""
    H = spec.grid_size
    fx, fy, cx, cy = intrinsics
    dev = grid.density.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    coords = all_cell_coords(H, dev)
    rows = []
    for cas in range(spec.cascades):
        bound = min(2.0**cas, spec.bound)
        half = bound / H
        covered = []
        for start in range(0, coords.shape[0], chunk):
            world = (2.0 * coords[start:start + chunk].float() / (H - 1) - 1.0) * (bound - half)
            # world to camera: subtract the translation, multiply by R
            cam = (world[None, :, :] - poses[:, None, :3, 3]) @ poses[:, :3, :3]
            seen = ((cam[..., 2] > 0)
                    & (cam[..., 0].abs() < cx / fx * cam[..., 2] + half * 2)
                    & (cam[..., 1].abs() < cy / fy * cam[..., 2] + half * 2))
            covered.append(seen.any(dim=0))
        rows.append(torch.where(torch.cat(covered), grid.density[cas], -1.0))
    return grid._replace(density=torch.stack(rows))


def mean_step_count(counts: torch.Tensor, prev_mean, momentum: float = 0.9):
    """Running mean of marched samples per ray (drives the K budget)."""
    return prev_mean * momentum + (1.0 - momentum) * counts.float().mean()


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] int -> Morton code (raymarching.cu:56-66)."""
    return (_part1by2(coords[..., 0]) | (_part1by2(coords[..., 1]) << 1)
            | (_part1by2(coords[..., 2]) << 2)).to(torch.int32)


def packbits(density: torch.Tensor, thresh) -> torch.Tensor:
    """[CAS, H^3] density -> uint8 bitfield [CAS*H^3/8] (raymarching.cu:268-289)."""
    occ = (density.reshape(-1, 8) > thresh).to(torch.uint8)
    weights = 1 << torch.arange(8, dtype=torch.uint8, device=density.device)
    return (occ * weights).sum(-1).to(torch.uint8)

"""Probe inputs for holding two runs of the sphere renderer against each
other (the card against the CPU, the port against the JAX package): rays
and an SDF fitted to the sphere on which the normals are well-conditioned,
so that what differs between the runs is the rounding of their arithmetic.

* A freshly drawn SDF's gradient is far below unit length, and the normal,
  its direction, then turns f32 rounding into gradient errors of a few
  percent; near a unit gradient (a trained SDF) the normal is
  well-conditioned (:func:`fit_sphere_sdf`).
* A ray that grazes the sphere (its discriminant near 0) has an entry
  point whose derivative in the discriminant, 1 / (2 sqrt(disc)), turns the
  rounding of the discriminant into a shift of its whole shell.
* The CP encoder's x gradient is constant in a cell and jumps at its edges:
  the normal of a sample near an edge depends on which side the ulps of its
  position fall.
"""

from __future__ import annotations

import numpy as np
import torch

RADIUS = 0.95                 # the shell of render_sphere's defaults
SHELL_STEPS, SHELL_STEP = 12, 0.002
GRAZE = 1e-2                  # least |discriminant| of a probe ray
CP_EDGE_MARGIN = 1e-4         # least distance of a shell sample to a CP cell edge, in cells
FIT_STEPS = 150
# roughness, metallic, colour
PROBE_MATERIAL = np.float32([0.3, 0.6, 0.7, 0.5, 0.3])


def shell(o: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The shell's sample positions [N, S, 3] of rays ``o``, ``d`` [N, 3]."""
    b = (o * d).sum(-1)
    near = -b - np.sqrt(np.clip(b * b - ((o * o).sum(-1) - RADIUS ** 2), 0, None))
    zr = SHELL_STEP * (SHELL_STEPS - 1) / 2.0
    z = np.linspace(-zr, zr, SHELL_STEPS)[None] + near[:, None]
    return o[:, None] + d[:, None] * z[..., None]


def probe_rays(n: int, seed: int, *, inside: bool = True, cp_scales=()):
    """``n`` rays (f32 numpy origins and directions) from distance 3.2
    towards points within 1.2 of the origin: most hit the sphere, some miss
    it.  None grazes the sphere, and with ``cp_scales`` (a CP encoder's level
    scales) none has a shell sample within ``CP_EDGE_MARGIN`` of a cell
    edge.  With ``inside`` every shell sample lies inside the bound
    [-1, 1]^3; without it some do not (a sample outside encodes to 0)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=3)
    o = np.broadcast_to(3.2 * c / np.linalg.norm(c), (4 * n, 3)) + rng.normal(0, 0.05, (4 * n, 3))
    d = rng.uniform(-1.2, 1.2, (4 * n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = shell(o, d)
    ok = (np.abs(x) < 0.999).all(axis=(1, 2)) if inside else np.ones(4 * n, bool)
    b = (o * d).sum(-1)
    ok &= np.abs(b * b - ((o * o).sum(-1) - RADIUS ** 2)) > GRAZE
    for scale in cp_scales:
        pos = (x + 1.0) / 2.0 * scale
        ok &= ~(np.abs(pos - np.round(pos)) < CP_EDGE_MARGIN).any(axis=(1, 2))
    if ok.sum() < n:
        raise ValueError(f"{int(ok.sum())} of {4 * n} drawn rays qualify, {n} asked for")
    return o[ok][:n].astype(np.float32), d[ok][:n].astype(np.float32)


def fit_sphere_sdf(net, seed: int) -> None:
    """Fit ``net``'s SDF (encoder and SDF net) to |x| - RADIUS in place:
    ``FIT_STEPS`` Adam steps on 4096 uniform points of the bound each, drawn
    from ``seed``, under ``PROBE_MATERIAL``; the gradients are cleared."""
    device = next(net.parameters()).device
    g = torch.Generator().manual_seed(seed)
    params = [p for n, p in net.named_parameters() if n.startswith(("encoder", "sdf_net"))]
    adam = torch.optim.Adam(params, lr=1e-2)
    mat = torch.from_numpy(PROBE_MATERIAL).to(device)
    for _ in range(FIT_STEPS):
        x = (torch.rand((4096, 3), generator=g) * 2.0 - 1.0).to(device)
        sdf = net.forward_geometry(x, material=mat)["sdf"]
        loss = ((sdf - (torch.linalg.vector_norm(x, dim=-1) - RADIUS)) ** 2).mean()
        adam.zero_grad()
        loss.backward()
        adam.step()
    net.zero_grad(set_to_none=True)

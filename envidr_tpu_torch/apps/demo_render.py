"""Render the pretrained neural sphere of the reference's ``demo.ipynb``
(counterpart of ``envidr_tpu/apps/demo_render.py``).

The sphere's SDF net, its diffuse and specular nets and the hash encoding of
one surface point are read from the tracked ``assets/demo_nets.npz``, the
env net ``env_{k}`` from ``assets/env_nets.npz``, or, with ``--ckpt-dir``,
from the reference's ``demo/*.pth`` files.  Every ray that hits the unit
sphere is shaded at its entry point (the normal is the position):

    python -m envidr_tpu_torch.apps.demo_render --theta 123 --phi 0 \\
        --roughness 0.0 --metallic 0.2 --color 20 70 160 --env 2 --size 400 \\
        --out demo.png [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

from envidr_tpu_torch import resolve_device
from envidr_tpu_torch.data.env_dataset import CAMERA_ANGLE_X
from envidr_tpu_torch.data.png import write_png
from envidr_tpu_torch.geometry.rays import (
    full_image_rays, linear_to_srgb, nerf_matrix_to_ngp, pose_spherical, reflect_dir,
    sphere_intersections,
)
from envidr_tpu_torch.io import torch_import
from envidr_tpu_torch.io.jax_params import mlp_from_tree
from envidr_tpu_torch.models.mlp import apply_mlp, unit_norm
from envidr_tpu_torch.ops.ide import ide_encode

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")
DEMO_NPZ = os.path.join(ASSETS, "demo_nets.npz")
ENV_NPZ = os.path.join(ASSETS, "env_nets.npz")
FEAT_DIM = 12


def load_demo_nets(env: int, ckpt_dir: str = "", device=None):
    """(nets, xyz_encoding [32]): nets a dict of ``sdf_net``, ``env_net``,
    ``diffuse_net`` and ``specular_net`` (``nn.ModuleList`` on ``device``),
    from the tracked assets or, with ``ckpt_dir``, the reference's files."""
    if ckpt_dir:
        trees = {name: torch_import.mlp_from_state(
            torch_import.load_state_dict(f"{ckpt_dir}/{name}.pth"))
            for name in ("sdf_net", "diffuse_net", "specular_net")}
        trees["env_net"] = torch_import.load_env_net(f"{ckpt_dir}/envs/env_net_{env}.pth")
        xyz = np.loadtxt(f"{ckpt_dir}/xyz_encoding.txt")
    else:
        trees = torch_import.load_npz_mlps(DEMO_NPZ, ("sdf_net", "diffuse_net", "specular_net"))
        trees["env_net"] = torch_import.load_npz_mlps(ENV_NPZ, (f"env_{env}",))[f"env_{env}"]
        with np.load(DEMO_NPZ) as z:
            xyz = z["xyz_encoding"]
    nets = {k: mlp_from_tree(v).to(device) for k, v in trees.items()}
    return nets, torch.as_tensor(np.asarray(xyz, np.float32), device=device)


def shade(nets, xyz_encoding: torch.Tensor, material_vec: torch.Tensor,
          dirs: torch.Tensor, normals: torch.Tensor):
    """The demo's shading of surface points with ``normals`` [N, 3] seen
    along ``dirs`` [N, 3] -> (kappa_inv, diffuse [N, 3], specular [N, 3]),
    linear radiance."""
    h = apply_mlp(nets["sdf_net"], torch.cat([xyz_encoding, material_vec])[None])
    geo_feat = unit_norm(h[..., 1:1 + FEAT_DIM]).expand(dirs.shape[0], FEAT_DIM)
    kappa_inv = torch.nn.functional.softplus(h[..., -1] - 1.0)[0]
    n_enc = ide_encode(normals, 0.64, deg_view=4)
    w_o = -dirs
    w_r_enc = ide_encode(reflect_dir(w_o, normals), kappa_inv, deg_view=4)
    n_dot_v = (normals * w_o).sum(dim=-1, keepdim=True)
    diffuse_env = unit_norm(apply_mlp(nets["env_net"], n_enc))
    diffuse = torch.sigmoid(apply_mlp(nets["diffuse_net"],
                                      torch.cat([geo_feat, diffuse_env], -1)))
    specular_env = unit_norm(apply_mlp(nets["env_net"], w_r_enc))
    specular = torch.sigmoid(apply_mlp(
        nets["specular_net"], torch.cat([geo_feat, normals, specular_env, n_dot_v], -1)))
    return kappa_inv, diffuse, specular


@torch.no_grad()
def render(nets, xyz_encoding, pose, intrinsics, material_vec, H: int, W: int) -> torch.Tensor:
    """[H, W, 3] sRGB in [0, 1], white where a ray misses the sphere."""
    rays_o, rays_d = full_image_rays(pose[None], intrinsics, H, W)
    rays_o, rays_d = rays_o[0], rays_d[0]
    nears, _, mask = sphere_intersections(rays_o, rays_d, 1.0)
    xyzs = rays_o + rays_d * nears
    _, diffuse, specular = shade(nets, xyz_encoding, material_vec, rays_d, xyzs)
    rgb = torch.clamp(linear_to_srgb(diffuse + specular), 0.0, 1.0)
    return torch.where(mask[:, None], rgb, 1.0).reshape(H, W, 3)


def camera(theta: float, phi: float, radius: float, size: int, device=None):
    """(pose [4, 4] on ``device``, intrinsics) of the demo's camera."""
    focal = size / (2 * np.tan(CAMERA_ANGLE_X / 2))
    pose = nerf_matrix_to_ngp(pose_spherical(theta, -phi, radius))
    return torch.as_tensor(pose, device=device), (focal, focal, size / 2, size / 2)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt-dir", default="",
                   help="the reference's demo/ directory (default: the tracked assets)")
    p.add_argument("--theta", type=float, default=123.0)
    p.add_argument("--phi", type=float, default=0.0)
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--roughness", type=float, default=0.0)
    p.add_argument("--metallic", type=float, default=0.2)
    p.add_argument("--color", type=int, nargs=3, default=[20, 70, 160])
    p.add_argument("--env", type=int, default=2, help="environment index 0..10")
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--out", default="demo.png")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    nets, xyz = load_demo_nets(args.env, args.ckpt_dir, dev)
    pose, intrinsics = camera(args.theta, args.phi, args.radius, args.size, dev)
    material = torch.tensor([args.roughness, args.metallic, *(c / 255.0 for c in args.color)],
                            dtype=torch.float32, device=dev)
    img = render(nets, xyz, pose, intrinsics, material, args.size, args.size).cpu().numpy()
    img8 = np.round(img * 255).astype(np.uint8)
    write_png(args.out, img8)
    print(f"device={dev} wrote {args.out} ({args.size}x{args.size}, mean={img.mean():.4f}, "
          f"fg_frac={(img8.min(-1) < 255).mean():.3f})")
    return img


if __name__ == "__main__":
    main()

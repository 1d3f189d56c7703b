"""Unwrap an env MLP into a lat-long environment image (counterpart of
``envidr_tpu/apps/unwrap.py``, the reference's ``unwrap_env_sphere``,
``nerf/render_func/sph_ray.py:223-309``).

One camera ray hits the sphere; its geometry feature and roughness are
broadcast to every light direction of the lat-long grid, and the colour
head shades each direction as the reflected one: the specular MLP *is* the
(neurally encoded) environment.

    python -m envidr_tpu_torch.apps.unwrap --config configs/neural_renderer_cp.ini \\
        --ckpt assets/env_sphere_pretrain_best.ckpt --env-index 3 --out env3.png
    python -m envidr_tpu_torch.apps.unwrap --env-net assets/env_ckpts/env_net_3.pth \\
        --out env3.png [--device cpu]

Without ``--config`` the sphere network is built from the reference's
pretrained MLPs as tracked in the repo (``assets/rendering_mlps.npz``, the
demo's SDF net and surface encoding in ``assets/demo_nets.npz``) with the
env net of ``--env-net`` or ``env_{--env-index}`` of ``assets/env_nets.npz``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from envidr_tpu_torch import resolve_device
from envidr_tpu_torch.data.png import write_png
from envidr_tpu_torch.geometry.lighting import gen_light_xyz
from envidr_tpu_torch.geometry.rays import linear_to_srgb
from envidr_tpu_torch.io import torch_import
from envidr_tpu_torch.io.jax_params import mlp_from_tree
from envidr_tpu_torch.models.mlp import feat_act
from envidr_tpu_torch.models.network import NeRFNetwork, NetworkConfig, material_tensor
from envidr_tpu_torch.ops.ide import ide_encode
from envidr_tpu_torch.train.trainer import to_uint8

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")
CHUNK = 65536
# the sphere network of the pretrained-MLP mode (envidr_tpu/apps/unwrap.py:155-158)
PRETRAINED_CFG = dict(env_sph_mode=False, in_roughness=1, in_metallic=1, in_base_color=3,
                      hidden_dim_env=160, roughness_act_scale=1.0, use_renv=True)


@torch.no_grad()
def unwrap_env(net: NeRFNetwork, *, env_h: int = 512, env_w: int = 1024,
               radius: float = 0.95, material=None, unwrap_roughness: Optional[float] = None,
               env_index=0, chunk: int = CHUNK,
               xyz_encoding: Optional[torch.Tensor] = None) -> np.ndarray:
    """[env_h, env_w, 3] linear-space environment image of ``net``'s env
    net ``env_index`` (sphere mode) or ``env_net``.  The camera stands at
    ``(0, 4, 0)`` (``get_pose(0, 0, 4)``, ``provider.py:69-93``) and looks at
    the sphere of ``radius``; with ``xyz_encoding`` the SDF net reads that
    encoding of a surface point and the material instead of the encoder
    (the demo's one-point trick: the sphere's material is uniform).
    ``unwrap_roughness`` replaces the roughness of the hit."""
    cfg = net.cfg
    dev = next(net.parameters()).device
    cam = torch.tensor([0.0, 4.0, 0.0], device=dev)
    d = -cam / torch.linalg.vector_norm(cam)
    surf = cam + (4.0 - radius) * d
    dirs = d[None, :]
    if xyz_encoding is not None:
        h = torch.cat([xyz_encoding.to(dev), material_tensor(material, dev)])[None]
        for l, layer in enumerate(net.sdf_net):
            h = layer(h)
            if l != len(net.sdf_net) - 1:
                h = F.relu(h)
        geo_feat = feat_act(h[..., 1:1 + cfg.geo_feat_dim], cfg.geo_feat_act)
        raw = h[..., 1 + cfg.geo_feat_dim:2 + cfg.geo_feat_dim]
        roughness = (cfg.roughness_act_scale * F.softplus(raw + cfg.roughness_bias)
                     * cfg.roughness_scale)
    else:
        geo = net.forward_geometry(surf[None, :], material=material)
        geo_feat, roughness = geo["geo_feat"], geo["roughness"]
    if unwrap_roughness is not None:
        roughness = torch.full((1, 1), float(unwrap_roughness), device=dev)
    normals = -dirs                                          # facing the camera

    lxyz, _ = gen_light_xyz(env_h, env_w, 1.0)
    lxyz = lxyz.reshape(-1, 3)[:, [1, 2, 0]]                 # sph_ray.py:251-252
    w_r = lxyz / np.linalg.norm(lxyz, axis=-1, keepdims=True)
    normals_enc, _, n_dot_w_o, n_env_enc = net.get_color_mlp_extra_params(
        normals, dirs, roughness)
    kappa = roughness[0, 0] if roughness is not None else 0.0
    out = []
    for s in range(0, w_r.shape[0], chunk):
        w = torch.as_tensor(w_r[s:s + chunk], dtype=torch.float32, device=dev)
        m = w.shape[0]

        def rows(t):
            return None if t is None else t.expand(m, t.shape[-1])

        w_r_enc = ide_encode(w, kappa, deg_view=cfg.sh_degree) * cfg.light_intensity_scale
        rgb, _ = net.forward_color(rows(geo_feat), rows(dirs), rows(normals_enc), w_r_enc,
                                   rows(n_dot_w_o), env_index=env_index,
                                   n_env_enc=rows(n_env_enc), roughness=rows(roughness))
        out.append(rgb)            # diffuse + specular, as sph_ray.py:299
    return torch.cat(out).reshape(env_h, env_w, 3).cpu().numpy()


def pretrained_net(env_net: str = "", env_index: int = 0, device=None):
    """(net, xyz_encoding): the pretrained-MLP sphere network, its
    rendering MLPs, SDF net and env net read from the tracked assets (or the
    env net from ``env_net``, an ``env_net_{i}.pth``)."""
    net = NeRFNetwork(NetworkConfig(**PRETRAINED_CFG), generator=torch.Generator().manual_seed(0))
    trees = torch_import.load_npz_mlps(os.path.join(ASSETS, "rendering_mlps.npz"))
    trees["sdf_net"] = torch_import.load_npz_mlps(os.path.join(ASSETS, "demo_nets.npz"),
                                                  ("sdf_net",))["sdf_net"]
    trees["env_net"] = (torch_import.load_env_net(env_net) if env_net else
                        torch_import.load_npz_mlps(os.path.join(ASSETS, "env_nets.npz"),
                                                   (f"env_{env_index}",))[f"env_{env_index}"])
    for name, tree in trees.items():
        setattr(net, name, mlp_from_tree(tree))
    with np.load(os.path.join(ASSETS, "demo_nets.npz")) as z:
        xyz = torch.as_tensor(np.asarray(z["xyz_encoding"], np.float32))
    return net.to(device), xyz.to(device)


def to_srgb8(img: np.ndarray) -> np.ndarray:
    """A linear image as the uint8 sRGB the app writes."""
    return to_uint8(linear_to_srgb(torch.from_numpy(img)).numpy())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="")
    p.add_argument("--ckpt", default="")
    p.add_argument("--env-net", default="", help=".pth env MLP to unwrap")
    p.add_argument("--roughness", type=float, default=0.7)
    p.add_argument("--metallic", type=float, default=0.9)
    p.add_argument("--color", type=float, nargs=3, default=[0.7, 0.7, 0.7])
    p.add_argument("--size", type=int, nargs=2, default=[256, 512])
    p.add_argument("--out", default="unwrap.png")
    p.add_argument("--env-index", type=int, default=None,
                   help="which env net to unwrap: of the stack (with --config; default "
                        "opt.unwrap_env_id) or of assets/env_nets.npz (default 0)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override Options fields (same dialect as the CLI)")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    material = {"roughness": args.roughness, "metallic": args.metallic,
                "color": [*args.color, 1.0]}
    xyz = None
    if args.config:
        from envidr_tpu_torch.config import _parse_value, load_options, network_config
        from envidr_tpu_torch.train.trainer import Trainer
        overrides = {k.strip(): _parse_value(v) for k, v in
                     (kv.split("=", 1) for kv in args.set)}
        opt = load_options(args.config, **overrides)
        if args.env_index is None:
            args.env_index = opt.unwrap_env_id if opt.unwrap_env_id >= 0 else 0
        cfg = network_config(opt)
        trainer = Trainer(opt, cfg, device=dev)
        trainer.load_checkpoint(args.ckpt or "latest")
        net = trainer.ema_net
        if not (cfg.in_roughness or cfg.in_metallic or cfg.in_base_color):
            material = None
        radius = opt.env_sph_radius
    else:
        args.env_index = args.env_index or 0
        net, xyz = pretrained_net(args.env_net, args.env_index, dev)
        radius = 0.95
    img = unwrap_env(net, env_h=args.size[0], env_w=args.size[1], material=material,
                     unwrap_roughness=args.roughness, radius=radius,
                     env_index=args.env_index if args.config else 0, xyz_encoding=xyz)
    write_png(args.out, to_srgb8(img))
    print(f"unwrapped env -> {args.out} ({args.size[0]}x{args.size[1]}, mean={img.mean():.4f})")
    return img


if __name__ == "__main__":
    main()

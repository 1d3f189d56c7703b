"""Offline turntable: a camera orbit, or a turning environment, rendered
frame by frame (counterpart of ``envidr_tpu/apps/turntable.py``; the
reference's GUI orbit and its ``test`` video, ``nerf/utils.py:996-1049``).

    python -m envidr_tpu_torch.apps.turntable --config configs/synth_spheres_cp.ini \\
        --ckpt assets/neus_cp_long_best.ckpt --n-frames 60 --out orbit/ \\
        [--env-rot] [--swap_env env_net_5.pth] [--device cpu]

The frames are PNGs: ``<out>/000.png, ...`` for a directory, or
``<base>_000.png, ...`` for an ``--out`` ending in ``.mp4`` or ``.gif`` (the
port writes no video; the JAX app falls back to the same numbered frames
when its video writer fails).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from envidr_tpu_torch.data.env_dataset import CAMERA_ANGLE_X
from envidr_tpu_torch.data.png import write_png


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default="latest")
    p.add_argument("--n-frames", type=int, default=60)
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--phi", type=float, default=-20.0)
    p.add_argument("--env-rot", action="store_true",
                   help="rotate the environment instead of the camera")
    p.add_argument("--roughness", type=float, default=0.2, help="sphere-mode material")
    p.add_argument("--metallic", type=float, default=0.9)
    p.add_argument("--color", type=float, nargs=3, default=[0.7, 0.7, 0.7])
    p.add_argument("--env-index", type=int, default=0)
    p.add_argument("--swap_env", default="")
    p.add_argument("--out", default="orbit.mp4")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    from envidr_tpu_torch import resolve_device
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.geometry.rays import nerf_matrix_to_ngp, pose_spherical
    from envidr_tpu_torch.train.trainer import Trainer, srgb_image, to_uint8

    opt = load_options(args.config)
    trainer = Trainer(opt, network_config(opt), device=resolve_device(args.device))
    trainer.load_checkpoint(args.ckpt)
    if args.swap_env:
        trainer.swap_env_net(args.swap_env, split_diffuse=opt.split_diffuse_env)
    trainer.update_extra_state()

    H = W = args.size
    focal = W / (2 * np.tan(CAMERA_ANGLE_X / 2))
    intr = (focal, focal, W / 2, H / 2)
    material = (dict(roughness=args.roughness, metallic=args.metallic, color=list(args.color))
                if opt.env_sph_mode or opt.render_env_on_sphere else None)
    frames, seconds = [], []
    for k in range(args.n_frames):
        t0 = time.perf_counter()
        if args.env_rot:
            pose = nerf_matrix_to_ngp(pose_spherical(120.0, args.phi, 4.0), scale=opt.scale)
            rot = 2 * np.pi * k / args.n_frames
        else:
            pose = nerf_matrix_to_ngp(pose_spherical(360.0 * k / args.n_frames, args.phi, 4.0),
                                      scale=opt.scale)
            rot = None
        res = trainer.render_image(pose, intr, H, W, env_rot_radian=rot, material=material,
                                   env_index=args.env_index)
        frames.append(to_uint8(srgb_image(res, opt)))     # read back: the render has ended
        seconds.append(time.perf_counter() - t0)
        print(f"frame {k + 1}/{args.n_frames}", end="\r", flush=True)

    if args.out.endswith((".mp4", ".gif")):
        base = os.path.splitext(args.out)[0]
        paths = [f"{base}_{k:03d}.png" for k in range(len(frames))]
    else:
        os.makedirs(args.out, exist_ok=True)
        paths = [os.path.join(args.out, f"{k:03d}.png") for k in range(len(frames))]
    for path, frame in zip(paths, frames):
        write_png(path, frame)
    print(f"\nwrote {args.out} ({len(frames)} frames @{args.size}px, "
          f"{1e3 * np.mean(seconds):.1f} ms a frame)")
    return frames, seconds


if __name__ == "__main__":
    main()

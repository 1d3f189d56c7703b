"""The training CLI (counterpart of ``envidr_tpu/apps/cli.py``, the
reference's ``main_nerf.py:13-204``): config, workspace, train / eval / test,
relighting, mesh and env-bank export.

    python -m envidr_tpu_torch.apps.cli --config configs/synth_spheres_cp.ini
    python -m envidr_tpu_torch.apps.cli --config ... --resume --max-epochs 80
    python -m envidr_tpu_torch.apps.cli --config ... --test [--swap_env env_net_5.pth]

The workspace (``opt.workspace``, or ``--workspace``) receives ``args.json``,
``log.txt``, ``checkpoints/`` (``ep*.ckpt``, ``best.ckpt``, and
``emergency_*.ckpt`` when an epoch raises), ``results/`` (the final render,
or ``test_0`` with ``--test``), ``<val_folder_name>/test/`` (the test split's
renders), ``mesh.obj`` (``--save-mesh``) and, after a sphere-mode run,
``env_ckpts/env_net_{i}.pth``.  Every image is a PNG.

The data are read from ``opt.path`` as the JAX package reads them.  The two
sets the repo's tools generate and does not track, ``data/synth_spheres``
(``tools/gen_synth_scene.py``) and ``data/env_sphere_synth``
(``tools/gen_env_dataset.py``), are made in memory by the port's copies of
the generators when their split file is absent; the log says so.

It runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from envidr_tpu_torch.data.png import write_png

GENERATED = {"synth_spheres": "scene", "env_sphere_synth": "env_sphere"}


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="", help=".ini config (reference dialect)")
    p.add_argument("--test", action="store_true")
    p.add_argument("--workspace", default=None)
    p.add_argument("--path", default=None, help="dataset root")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--eval-interval", type=int, default=None)
    p.add_argument("--swap_env", default="", help="relight: env net .pth to swap in")
    p.add_argument("--ckpt", default="latest")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--save-mesh", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest workspace checkpoint")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any Options field (repeatable), e.g. "
                        "--set hash_scatter_impl=mixed --set num_rays=8192")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; cpu runs the plain versions)")
    return p


def load_split(opt, split: str, *, downscale: int = 1, test_skip: int = 1, device=None,
               log=print):
    """One split of ``opt.path``: an env-sphere set in sphere mode, else a
    NeRF-format scene; a generated set made in memory when its split file is
    absent.  Any other missing split raises ``FileNotFoundError``."""
    sphere = opt.env_sph_mode or opt.render_env_on_sphere
    kind = GENERATED.get(os.path.basename(os.path.normpath(opt.path)))
    if not os.path.exists(os.path.join(opt.path, f"transforms_{split}.json")) and kind:
        if kind == "env_sphere" and sphere:
            from envidr_tpu_torch.data.env_dataset import generate_env_sphere
            ds = generate_env_sphere(split, scale=opt.scale, with_renv=opt.train_renv,
                                     device=device)
        elif kind == "scene" and not sphere:
            from envidr_tpu_torch.data.synth_scene import SynthSpheres
            ds = SynthSpheres(split, scale=opt.scale, offset=opt.offset, downscale=downscale)
            if split != "train" and test_skip > 1:
                ds.images, ds.poses = ds.images[::test_skip], ds.poses[::test_skip]
        else:
            kind = None
        if kind:
            log(f"[data] {opt.path}/transforms_{split}.json absent: the {split} split "
                f"made in memory ({len(ds)} views at {ds.H}x{ds.W})")
            return ds
    if sphere:
        from envidr_tpu_torch.data.env_dataset import EnvSphereDataset
        return EnvSphereDataset(opt.path, split, scale=opt.scale, offset=opt.offset,
                                with_renv=opt.train_renv)
    from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
    return NeRFDataset(opt.path, split, scale=opt.scale, offset=opt.offset,
                       downscale=downscale, test_skip=test_skip,
                       fp16_preload=opt.fp16 and opt.preload)


def main(argv=None):
    import faulthandler
    import signal
    faulthandler.register(signal.SIGUSR1)   # kill -USR1 <pid> dumps every stack
    args = build_argparser().parse_args(argv)

    from envidr_tpu_torch import resolve_device
    from envidr_tpu_torch.config import _parse_value, load_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer

    overrides = {k: getattr(args, k) for k in ("workspace", "path", "iters", "seed")
                 if getattr(args, k) is not None}
    if args.eval_interval is not None:
        overrides["eval_interval"] = args.eval_interval
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k.strip()] = _parse_value(v.strip())
    opt = load_options(args.config, **overrides)
    dev = resolve_device(args.device)

    trainer = Trainer(opt, network_config(opt), device=dev)
    os.makedirs(opt.workspace, exist_ok=True)
    with open(os.path.join(opt.workspace, "args.json"), "w") as f:
        json.dump({k: str(v) for k, v in dataclasses.asdict(opt).items()}, f, indent=1)
    # the env-sphere renders (JAX's CLI takes render_env_on_sphere's data,
    # cli.py:92, but renders it in scene mode, which fails without a material)
    mode = "sphere" if (opt.env_sph_mode or opt.render_env_on_sphere) else "scene"
    log_path = os.path.join(opt.workspace, "log.txt")

    def log(msg):
        print(msg, flush=True)
        with open(log_path, "a") as f:
            f.write(msg + "\n")

    def make_dataset(split, test_skip=1):
        return load_split(opt, split, downscale=args.downscale, test_skip=test_skip,
                          device=dev, log=log)

    def conditioning(ds):      # a sphere render's material and env (frame 0)
        return (dict(material=ds.material(0), env_index=int(ds.env_index[0]))
                if mode == "sphere" else {})

    if args.swap_env:
        trainer.load_checkpoint(args.ckpt)
        trainer.swap_env_net(args.swap_env, split_diffuse=opt.split_diffuse_env)

    if args.test:
        if not args.swap_env:
            trainer.load_checkpoint(args.ckpt)
        test_set = make_dataset(opt.test_split, opt.test_skip)
        trainer.update_extra_state(full=opt.extra_state_full_update)
        ids = [i for i in opt.test_ids if i < len(test_set)] or None   # main_nerf.py:129-134
        psnr = trainer.evaluate(test_set, max_images=len(test_set), track_best=False,
                                indices=ids,
                                dump_dir=os.path.join(opt.workspace, opt.val_folder_name, "test"))
        log(f"[test] PSNR = {psnr:.3f}")
        res = trainer.render_image(test_set.poses[0], test_set.intrinsics, test_set.H,
                                   test_set.W, **conditioning(test_set))
        save_images(res, os.path.join(opt.workspace, "results"), "test_0", opt)
        return psnr

    train_set = make_dataset("train")
    try:
        val_set = make_dataset("val")
    except FileNotFoundError:
        val_set = train_set

    resumed = False
    if args.resume:
        resumed = trainer.load_checkpoint(args.ckpt)
        if resumed and opt.extra_state_full_update:
            # one full-grid sweep right after a resume (main_nerf.py:113)
            trainer.update_extra_state(full=True)
    if opt.geometric_cue and not resumed:
        trainer.train_geometric_cue()
    max_epochs = args.max_epochs
    if max_epochs is None:
        max_epochs = int(np.ceil(opt.iters / max(len(train_set), 1)))
    log(f"[train] {len(train_set)} images, {max_epochs} epochs, mode={mode}, devices=[{dev}]")

    trainer.mark_untrained_grid(train_set.poses, train_set.intrinsics)
    best = -1.0
    for ep in range(trainer.epoch, max_epochs):
        try:
            stats = trainer.train_one_epoch(train_set)
        except Exception as e:
            # an emergency checkpoint on any failure (utils.py:970-983)
            path = trainer.save_checkpoint(name=f"emergency_ep{trainer.epoch:04d}")
            log(f"[error] {type(e).__name__}: {e}; saved {path}")
            raise
        nf = int(stats.get("notfinite", 0))
        K = (trainer.sample_budget(trainer._sched, trainer.host_mean_count)
             if mode == "scene" else 12)
        log(f"[ep {trainer.epoch:4d}] loss={stats['loss']:.5f} "
            f"color={stats.get('color', 0):.5f} rays/s={stats['rays_per_sec']:.0f} "
            f"K={K} mean_count={trainer.host_mean_count:.1f} t={stats['time']:.1f}s"
            + (f" NOTFINITE={nf}" if nf else ""))
        eval_int = opt.eval_interval if opt.eval_interval > 0 else 50
        if (ep + 1) % eval_int == 0 or ep == max_epochs - 1:
            trainer.save_checkpoint()     # before the eval: an eval failure loses no work
            psnr = trainer.evaluate(val_set)
            r = (trainer.stats.get("results") or [{}])[-1]
            extra = f" ssim={r['ssim']:.4f}" if r.get("ssim") is not None else ""
            if r.get("lpips") is not None:
                extra += f" lpips[{r.get('lpips_kind')}]={r['lpips']:.4f}"
            log(f"[eval ep {trainer.epoch}] PSNR = {psnr:.3f}{extra}")
            best = max(best, psnr)

    res = trainer.render_image(val_set.poses[0], val_set.intrinsics, val_set.H, val_set.W,
                               **conditioning(val_set))
    save_images(res, os.path.join(opt.workspace, "results"), "final", opt)
    if args.save_mesh:
        from envidr_tpu_torch.apps.mesh_extract import save_mesh
        save_mesh(trainer, os.path.join(opt.workspace, "mesh.obj"))
    if opt.env_sph_mode and hasattr(trainer.ema_net, "env_nets"):
        # the relighting export after a pretrain (main_nerf.py:194-198)
        from envidr_tpu_torch.io.jax_params import network_tree
        from envidr_tpu_torch.io.torch_export import extract_env_ckpts
        paths = extract_env_ckpts(network_tree(trainer.ema_net),
                                  os.path.join(opt.workspace, "env_ckpts"))
        log(f"[export] {len(paths)} env ckpts -> {opt.workspace}/env_ckpts")
    log(f"[done] best PSNR = {best:.3f}")
    return best


def save_images(res, outdir: str, tag: str, opt):
    """``{tag}_rgb.png`` (sRGB), ``{tag}_normal.png`` and ``{tag}_depth.png``
    (min-max normalised) of a render in ``outdir``."""
    from envidr_tpu_torch.train.trainer import srgb_image, to_uint8
    os.makedirs(outdir, exist_ok=True)
    write_png(os.path.join(outdir, f"{tag}_rgb.png"), to_uint8(srgb_image(res, opt)))
    if "normal_image" in res:
        write_png(os.path.join(outdir, f"{tag}_normal.png"),
                  to_uint8(res["normal_image"] * 0.5 + 0.5))
    if "depth" in res:
        d = res["depth"]
        d = (d - d.min()) / max(d.max() - d.min(), 1e-6)
        write_png(os.path.join(outdir, f"{tag}_depth.png"), to_uint8(d))


if __name__ == "__main__":
    main()

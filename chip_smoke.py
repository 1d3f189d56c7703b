"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one flushed line with its numbers and the elapsed
seconds:

  device   card name and power limit (nvidia-smi)
  build    nvcc build of every kernel source (one nvcc each, all started
           together), with the seconds of each or "cached"
  kernels  each kernel against its plain PyTorch version at the shape its
           path gives it (the train step for scatter_add_rows and the CP
           row pair, the micro-benchmarks' shapes for the others), with CUDA-event times of
           the kernel, the plain version and, where there is one, a single
           library call computing the same function, beside the bound (the
           kernel's median and mean of 20 launches), after the timer's floor
           (an empty launch and a zero_() of the gathers' output, same
           timer); then readings of the bf16 accumulator's summation-order
           noise and the scatters' and gathers' edge shapes
           (envidr_tpu_torch.tools.scatter_edges)
  parity   a small model, one train-step loss and its gradients on the card
           (through the kernels) against the same step on the CPU (plain
           versions), and the CPU f32 step against an f64 one, per tensor
  hash     the ``hash`` encoder's forward and first/second-order gradients
           and the ``sorted`` scatter on the card against the CPU, small size
  train    configs/synth_spheres.ini at full width (rolled_tiled hash grid,
           hash_scatter_impl=mixed, hand-written hash VJP) on the in-memory
           sphere scene: 20 train steps, each step that neither starts an
           epoch nor refreshes the grid under torch.cuda's sync debug mode
           "error"; launch counts are zeroed just before
  render   one 400x400 eval render of a val view, PSNR against the analytic
           ground truth; launch counts are read just after
  cp_parity  a small CP + NeuS + coarse-march model, one train-step loss and
           its gradients on the card against the same step on the CPU, per
           tensor: the CP encoder in f32 under PARITY_RTOL, and in bf16 (the
           production dtype) under CP_BF16_RTOL
  ours_parity  the same for configs/scenes/synth_spheres_ours.ini cut as
           small (its rendering MLPs keep the widths of the pretrain
           checkpoint they load; dense march): the card against the CPU,
           which tests/test_torch_ours.py holds against the JAX package
  train_cp configs/synth_spheres_cp.ini, the repo's main path, at full width
           (CP encoder 16 levels x rank 32, NeuS alpha, coarse march, 3x64
           SDF and colour MLPs, env net 64, 4096 rays): 20 train steps, each
           step that neither starts an epoch nor refreshes the grid under sync
           debug mode "error"; every march must take the coarse path; launch
           counts are zeroed just before
  render_cp the repo's trained CP checkpoint (assets/neus_cp_long_best.ckpt)
           loaded by the port, val view 0 rendered at 400x400, PSNR against the
           analytic ground truth (white background) above 22 dB; launch counts
           are read just after (of the csrc/ kernels the CP path runs only
           the CP row pair, counted apart)
  lpips    the port's LPIPS (untrained AlexNet trunk, F.conv2d) of that render
           and its ground truth on the card against the same module on the
           CPU (relative difference, TF32 off, under LPIPS_CARD_RTOL), ms of
           one 400x400 LPIPS on the card (median of 10); then evaluate of the
           checkpoint on val view 0 must fill lpips with kind alex_untrained
  fixtures ensure_synth_spheres into a temporary directory at 400 px and 50
           train views (seconds), then NeRFDataset on it (the port's decoder,
           seconds): the decoded train images must equal the in-memory
           SynthSpheres("train") images bit for bit
  train_ours configs/scenes/synth_spheres_ours.ini, ENVIDR's per-scene recipe,
           at its published width (CP 16 levels x rank 32, NeuS, dense march,
           3x64 SDF and colour MLPs, env net 160, 4096 rays) with the rendering
           MLPs of assets/env_sphere_pretrain_best.ckpt frozen: 20 train steps,
           the sync-free ones under sync debug mode "error"; the frozen MLPs
           must stay bit-equal to the checkpoint's in the net and the EMA net,
           and every trainable group must move
  relight  val view 0 at 400x400 from that trainer before and after
           swap_env_net(assets/env_ckpts/env_net_5.pth): both times and the
           mean absolute difference, which must not be 0
  render_laplace  assets/r4_laplace_cue_best.ckpt under r4_laplace_cue.ini,
           val view 0 at 400x400, PSNR above LAPLACE_PSNR_MIN_DB
  cue      the geometric cue of r4_laplace_cue.ini at its published 500 steps
           x 131,072 points, full width: first and last loss, seconds; then
           10 train steps of that recipe (the beta cap projected at the epoch's
           start and handed to the render and the loss as a device tensor),
           the sync-free ones under sync debug mode "error"
  train_aux  r4_laplace_ref.ini at epoch 121 (back-face, Cauchy and eikonal
           terms on) with stratified_sampling: 10 steps, every loss term at
           the last one
  train_density  configs/synth_spheres_density.ini (use_sdf=False) through
           card_options, so on the scatter_add_rows kernel: 10 steps; launch
           counts are zeroed just before and read just after
  indir_parity  one indirect train step (epoch 76 of
           configs/scenes/shiny3_indir.ini: the three-pass render with grad
           rays, the renv branch, the learned blend) of the trained shiny3
           scene (assets/shiny3_backsdf_ep40.ckpt) on 256 rays of a train view,
           the card against the CPU per tensor, the CP encoder in f32 under
           PARITY_RTOL and in bf16 under CP_BF16_RTOL, and the error map's EMA
           of the step
  render_shiny3  that checkpoint (with its optimizer state) under
           shiny3_indir.ini, val view 0 of data/synth_shiny3 (decoded by the
           port's PNG decoder; the decode's seconds printed) at 400x400 through
           the three passes: PSNR as the trainer's evaluate reads it, above
           SHINY3_PSNR_MIN_DB, and the share of pixels the renv gate opens on
  train_shiny3  shiny3_indir.ini at full width (CP 16 levels x rank 32, NeuS,
           3x64 SDF and colour MLPs, env net 160, renv 4 -> 64x3 -> 12, 4096
           rays) resumed from that checkpoint, the grid's unseen cells marked,
           from epoch 76 (indirect pass and grad rays on, error-map sampling):
           20 steps, the sync-free ones under sync debug mode "error"; the
           frozen colour and diffuse nets bit-equal in the net and the EMA net,
           renv_net moved, the error map changed, the renv gate open on some
           samples; then save_checkpoint and load_checkpoint into a fresh
           trainer, which must give back the parameters, the Adam moments and
           both counts
  train_stack  configs/scenes/shiny2_stack.ini (rolled_tiled hash grid, the
           toaster schedule stack) through card_options on data/synth_shiny2
           from epoch 18 (every term, the indirect pass and grad rays on): 10
           steps, scatter_add_rows launched; launch counts are zeroed just
           before and read just after
  bench_torch  bench_torch.py's function on the default config, with the
           data-parallel probe (envidr_tpu_torch/tools/bench_scaling.py: 1 and 2
           ranks as processes sharing the card): its JSON line with
           gspmd_overhead_ratio and weak_rays_per_sec_per_vdev
  parallel configs/synth_spheres_cp.ini at full width (4096 rays in all) as two
           gloo worker processes on the one card (envidr_tpu_torch/parallel/
           tiny_step.py, each with a timeout) against one process in this one,
           same seed, same draws: after step 1 and (bf16) after 3 + PARALLEL_STEPS
           more the two ranks' parameters, EMA, grid and Adam state must be bit-equal;
           step 1's loss within PARALLEL_LOSS_RTOL and its Adam first moments
           (the summed gradient) within PARALLEL_F32_RTOL (the CP encoder in
           f32) and CP_BF16_RTOL (in bf16, as configured) per tensor of the
           one-process step's, and each parameter whose gradient is above
           PARALLEL_SIGNIFICANT of its tensor's max within PARALLEL_PARAM_ATOL
           (below it Adam's first step may flip sign with the gradient's: 2 lr
           apart at most); ms a step at 2 ranks and at 1 (bf16); then the
           checkpoint's val view 0 at 400x400 rendered by 2 ranks against 1
           (max abs difference under PARALLEL_EVAL_ATOL); then a
           world of 1 under nccl (init and an all-reduce on the card).  Gloo
           copies through the host, so no step here runs under sync debug mode
           "error"
  bench    the three micro-benchmarks of envidr_tpu_torch.tools at their full
           shapes with few iterations (every table row, hash_encode of both
           indexings included); launch counts are zeroed just before and read
           just after
  sphere_parity  a small sphere-mode step (neural_renderer_cp.ini cut small:
           CP encoder, material, 2 env nets, the sdf, back-face and eikonal
           terms) on the card against the CPU, per tensor: the encoder in f32
           under PARITY_RTOL, in bf16 under CP_BF16_RTOL
  train_sphere  neural_renderer_cp.ini at its published width (CP 16 x 32,
           SDF 37 -> 64 -> 64 -> 14, colour 3 x 64, diffuse 2 layers, 11 env
           nets 38 -> 160 x 3 -> 12, 16384 rays x 12 samples) on the env-sphere
           set generated on the card (SPHERE_TRAIN_VIEWS views at 400x400): 2
           steps of the diffuse term alone, then 20 from epoch 5, all after
           the first under sync debug mode "error"; every env net a step chose
           moves; launch counts are zeroed just before and read just after
  train_sphere_hash  neural_renderer_synth.ini as shipped (hashgrid_diff, the
           hash indexing, a 2^19 table) at full width: 5 steps
  render_pretrain  assets/env_sphere_pretrain_best.ckpt (EMA) on generated val
           views at 400x400 with their materials and env indices: PSNR of
           view 0 above PRETRAIN_PSNR_MIN_DB
  train_renv  neural_renderer_renv.ini with RENV_OVERRIDES on the decoded
           data/env_sphere_renv (the decode's seconds printed): 10 steps;
           every frozen module bit-equal in the net and the EMA net, renv_net
           moved
  render_renv  assets/renv_pretrain_best.ckpt on the renv set's val views at
           400x400 with their mirror images and without: both PSNRs and the
           largest change, which must be above 0
  cli      the training CLI (envidr_tpu_torch.apps.cli.main, in process) on
           configs/synth_spheres_cp.ini at full width in a temporary
           workspace: --max-epochs 2 --eval-interval 2, then --resume
           --max-epochs 3 (it must start at epoch 3 from global step 100),
           then --test --ckpt best; the files it writes (ep0002.ckpt,
           ep0003.ckpt, best.ckpt, args.json, results/final_rgb.png read back
           at 400x400), each epoch's seconds, rays/s and loss from its log,
           the eval and test PSNRs; each epoch's loss must be at most
           CLI_LOSS_FALL of the one before; the second epoch runs under sync
           debug mode "warn", and more than one host sync beyond the steps
           step_may_sync names fails the phase
  cli_hash the CLI for one epoch of configs/synth_spheres.ini on the kernel's
           path (--set hash_scatter_impl=mixed --set hash_custom_grad=on):
           scatter_add_rows must launch; counts zeroed just before, read after
  mesh     the field of assets/neus_cp_long_best.ckpt on a 256^3 grid (on the
           card) and marching tetrahedra in C++ (envidr_tpu_torch/native,
           built by g++): the seconds of each, the vertex and face counts, the
           vertices' mean and largest |analytic SDF| against the three spheres
           of data/synth_scene.py in world units; the C++ and the numpy
           marching tetrahedra on a 64^3 crop of the field must give the same
           welded vertex set
  demo     the reference's demo golden (tests/golden/demo_render.npz) through
           apps/demo_render.py on the card, at tests/test_demo_parity.py's
           tolerances, then its CLI at 400x400: mean and foreground share
  unwrap   tests/golden/unwrap_env.npz through apps/unwrap.py on the card
           (atol UNWRAP_ATOL), then the CLI's 512x1024 unwrap of env 3 of
           assets/env_sphere_pretrain_best.ckpt, timed
  turntable  apps/turntable.py: 8 frames at 400x400 of the CP checkpoint with
           --env-rot, ms a frame; frames 0 and 4 must differ (the rotation
           moves the specular term)
  viewer   apps/viewer.py's HTTP server on an ephemeral localhost port in a
           thread: one GET /render at 256 must return a PNG that the port's
           decoder reads
  volsdf_parity  one VolSDF error-bound step of configs/synth_spheres_cp_laplace.ini
           cut small (error_bound_sample, num_steps VOLSDF_PARITY_STEPS, the
           SDF fitted to a sphere, the draws made on the CPU) on the card
           against the CPU, per tensor: the CP encoder in f32 under
           PARITY_RTOL, in bf16 under CP_BF16_RTOL
  train_volsdf  synth_spheres_cp_laplace.ini with error_bound_sample at full
           width (CP 16 x 32, SDF and colour 3x64, env net 64, 4096 rays,
           num_steps 512: 4 rounds to 2560 samples a ray, 50 kept): 10 steps
           after the grid refresh, the sync-free ones under sync debug mode
           "error"; ms a step, the sampler's share of it (CUDA events around
           each call), peak GiB, samples a ray; no march in a step
  train_volsdf_hash  synth_spheres.ini (rolled_tiled hash grid) with
           HASH_KERNEL_PATH and error_bound_sample: 10 steps; counts zeroed
           just before and read just after, scatter_add_rows must launch
  split_env  scenes/synth_spheres_ours.ini with split_diffuse_env (the
           pretrain's colour MLPs frozen): 5 steps, then
           swap_env_net(env_net_5.pth, split_diffuse=True): the diffuse env
           net must equal the old env net and the env net the file's, in the
           net and the EMA net; val view 0 at 400x400 before and after
  options  synth_spheres_cp.ini at full width with each of OPTIONS (patch
           and centre-crop sampling, image batches, growing march steps, the
           background net, numerical normals, the geometric init, the
           roughness head): 5 steps each, ms a step and the losses finite
  sphere_mode_render  neural_renderer_cp.ini's widths with render_env_on_sphere
           (one env net, the material inputs; seeded weights: no tracked
           checkpoint has that network) through apps/viewer.py's frame at
           400x400, ms a frame

Then one JSON line of per-kernel numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises and the exit code
is non-zero; without a CUDA card it exits non-zero before printing anything.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
TRAIN_STEPS = 20
BENCH_ITERS = 4                    # timed calls per micro-benchmark row
SCATTER_ATOL = 1e-3                # f32 sums of ~64 unit-normal rows per slot
                                   # (level 0), added in another order
FEW_ROWS_ATOL = 1e-5               # f32 sums of the few (<= ~8) rows per slot
                                   # of a 2^19-row table, in another order
BF16_ACC_RTOL = 2.0**-5            # of max |sum|: bf16 sums of a few rows in
                                   # two orders that the atomics choose; the
                                   # bf16 readings below differ by up to 2
                                   # ulps of the largest sums, 2^-7 of max |sum|
                                   # or more, so 2^-5 (4-8 ulps) leaves room
HASH_FWD_ATOL = 1e-6               # one f32 product-sum of 8 corners
HASH_GRAD1_RTOL = 1e-5             # of max: f32 sums over 8 corners x levels
HASH_GRAD2_RTOL = 1.3e-3           # of max: double backward (ROADMAP C-3)
SORTED_ATOL = 1e-4                 # cumsum differences (the JAX package's bound)
BENCH = dict(B=262_144, W=16, S=1 << 19, S_small=4096)   # tools/bench_scatter.py:22-25,87
PARITY_RTOL = 5e-3                 # of each tensor's max |value|: the card and
                                   # the CPU sum in other orders; the largest
                                   # reading, card f32 against CPU f32, is
                                   # 1.30e-3 (sdf_net.0.weight; PERF.md), so this
                                   # is a margin of ~4x over it.  The f32 step is
                                   # itself 9.4e-3 from f64 on the table gradient
                                   # (the cpu_f32_vs_cpu_f64 reading)
CP_BF16_RTOL = 2.0**-6             # of each tensor's max, the CP step with its
                                   # encoder in bf16: the same roundings in
                                   # another summation order; the same bound
                                   # holds the port to JAX's op-by-op bf16 step
                                   # (tests/test_torch_neus.py, readings there
                                   # 2.5e-3 to 7.3e-3)
PARALLEL_STEPS = 10
PARALLEL_TIMEOUT_S = 600           # each worker process
PARALLEL_SIGNIFICANT = 1e-3        # of a tensor's max |first moment|
PARALLEL_PARAM_ATOL = 1e-6         # the CPU reading is 7.5e-9 (tests/test_torch_parallel.py)
PARALLEL_LOSS_RTOL = 1e-6          # the loss's sums in two parts
PARALLEL_F32_RTOL = 1e-4           # the summed gradient, the f32 encoder: sums in
                                   # another order (CPU reading 5.5e-7); the bf16
                                   # encoder rounds each rank's partial table
                                   # gradient: CP_BF16_RTOL
PARALLEL_EVAL_ATOL = 2e-5          # tests/test_trainer.py's sharded-eval bound
LPIPS_CARD_RTOL = 1e-4             # the card's convolutions against the CPU's, f32
LPIPS_REPS = 10
CP_INI = os.path.join(ROOT, "configs", "synth_spheres_cp.ini")
CP_CKPT = os.path.join(ROOT, "assets", "neus_cp_long_best.ckpt")
CP_PSNR_MIN_DB = 22.0              # tests/test_cp_quality_ckpt.py's bar
OURS_INI = os.path.join(ROOT, "configs", "scenes", "synth_spheres_ours.ini")
PRETRAIN_CKPT = os.path.join(ROOT, "assets", "env_sphere_pretrain_best.ckpt")
ENV_NET = os.path.join(ROOT, "assets", "env_ckpts", "env_net_5.pth")
LAPLACE_INI = os.path.join(ROOT, "configs", "r4_laplace_cue.ini")
LAPLACE_CKPT = os.path.join(ROOT, "assets", "r4_laplace_cue_best.ckpt")
LAPLACE_PSNR_MIN_DB = 23.68        # the JAX package's render of this view at
                                   # downscale 4 on the CPU reads 24.6847 dB
                                   # (tests/ours_readings.py), less 1 dB; the
                                   # card renders the full 400x400 view
AUX_INI = os.path.join(ROOT, "configs", "r4_laplace_ref.ini")
AUX_EPOCH = 121                    # back-face and Cauchy on from 40, eikonal from 120
DENSITY_INI = os.path.join(ROOT, "configs", "synth_spheres_density.ini")
SHORT_STEPS = 10                   # train_aux, train_density and train_stack
SHINY3_INI = os.path.join(ROOT, "configs", "scenes", "shiny3_indir.ini")
SHINY3_CKPT = os.path.join(ROOT, "assets", "shiny3_backsdf_ep40.ckpt")
SHINY3_DATA = os.path.join(ROOT, "data", "synth_shiny3")
# the scene configs' color_mlp_path lies under exps/, which holds logs only
RENV_CKPT = os.path.join(ROOT, "assets", "renv_pretrain_best.ckpt")
SHINY3_EPOCH = 76                  # indir_ref from 45, grad rays from 45 + 30 + 1
SHINY3_PSNR_MIN_DB = 17.5591       # the JAX package's render of val view 0 at
                                   # downscale 4 on the CPU reads 18.5591 dB
                                   # (tests/indir_readings.py), less 1 dB; the
                                   # card renders the full 400x400 view
STACK_INI = os.path.join(ROOT, "configs", "scenes", "shiny2_stack.ini")
SHINY2_DATA = os.path.join(ROOT, "data", "synth_shiny2")
STACK_EPOCH = 18                   # indir_ref from 14, grad rays from 14 + 3 + 1
CUE_STEPS, CUE_POINTS = 500, 131_072   # Trainer.train_geometric_cue's published defaults
SPHERE_INI = os.path.join(ROOT, "configs", "neural_renderer_cp.ini")
SPHERE_HASH_INI = os.path.join(ROOT, "configs", "neural_renderer_synth.ini")
RENV_INI = os.path.join(ROOT, "configs", "neural_renderer_renv.ini")
RENV_DATA = os.path.join(ROOT, "data", "env_sphere_renv")
# the renv pretrain as tools/r3_campaign.sh:61-62 ran it: the CP pretrain
# resumed whole, the CP encoder in place of the shipped hashgrid_diff
RENV_OVERRIDES = dict(encoding_pos="cp", cp_rank=32, color_mlp_path=PRETRAIN_CKPT)
SPHERE_TRAIN_VIEWS = 1200          # tools/gen_env_dataset.py's --n-train default
SPHERE_EPOCH = 5                   # color_net_start_iter: the specular branch on
SPHERE_HASH_STEPS = 5
SPHERE_RENDER_VIEWS = 4
PRETRAIN_PSNR_MIN_DB = 29.5866     # the JAX package's render of the generated val
                                   # view 0 at 100x100 on the CPU reads 30.5866 dB
                                   # (tests/sphere_readings.py), less 1 dB; the
                                   # card renders the full 400x400 view
# sphere_parity: neural_renderer_cp.ini cut as cp_parity cuts its config, two env nets
DEMO_GOLDEN = os.path.join(ROOT, "tests", "golden", "demo_render.npz")
UNWRAP_GOLDEN = os.path.join(ROOT, "tests", "golden", "unwrap_env.npz")
# tests/test_demo_parity.py's tolerances, and tests/test_sphere_golden.py's
DEMO_TOL = dict(kappa_rtol=1e-4, kappa_atol=1e-6, diffuse=2e-5, specular=5e-4,
                specular_mean=2e-5)
UNWRAP_ATOL = 3e-4
CLI_EPOCHS = 3                     # two, then one more after --resume
# each CLI epoch's loss at most this share of the one before: the card read
# 0.58523 / 0.46809 / 0.40740 (ratios 0.80, 0.87); after 3 epochs the PSNR
# does not separate a trained model from an untrained one (test view 9.890 dB
# from best.ckpt, 9.901 untrained; PERF.md §6)
CLI_LOSS_FALL = 0.95
CLI_SIZE, CLI_TRAIN_VIEWS = 400, 50  # the in-memory sphere scene's
CLI_INI, HASH_INI = CP_INI, os.path.join(ROOT, "configs", "synth_spheres.ini")
MESH_RES, MESH_CROP = 256, 64
TURNTABLE_FRAMES, TURNTABLE_SIZE = 8, 400
SPHERE_PARITY_CUT = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16,
                         hidden_dim_color=16, hidden_dim_env=16, num_envs=2)
# sphere_parity's probe rays (18 with shell samples outside the bound).  The
# bf16 sphere step is ill-conditioned: on the CPU alone, one f32 ulp of ray
# noise moves its table gradients by up to 6.2e-3 of a tensor's max at 64
# rays and 2.2e-2 at 256 (tests/sphere_readings.py), so at 256 the noise
# alone passes CP_BF16_RTOL (f32: 9.0e-5 and 1.1e-4)
SPHERE_PARITY_RAYS = 64
VOLSDF_INI = os.path.join(ROOT, "configs", "synth_spheres_cp_laplace.ini")
VOLSDF_STEPS = 10
VOLSDF_PARITY_STEPS = 32           # num_steps of the small step: 160 samples after 4 rounds
VOLSDF_PARITY_RAYS = 128
SPLIT_STEPS = OPTION_STEPS = 5
# the runtime options that no shipped config sets, each on synth_spheres_cp.ini
OPTIONS = {"patch_size": dict(patch_size=8), "center_crop": dict(center_crop=0.5),
           "image_batch": dict(image_batch=4), "dt_gamma": dict(dt_gamma=1.0 / 128),
           "bg_radius": dict(bg_radius=2.0), "numerical_normals": dict(numerical_normals=True),
           "geometric_init": dict(geometric_init=True),
           "roughness_layer": dict(ensemble_mlp=False)}
SPHERE_MODE_FRAMES, SPHERE_MODE_SIZE = 2, 400


def phase(name: str, *words, **numbers):
    fields = " ".join([*words, *(f"{k}={v}" for k, v in numbers.items())])
    print(f"{name}: {fields} elapsed_s={time.perf_counter() - T0:.1f}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_libraries():
    """(name, CudaLibrary) of every kernel instantiation, in table order."""
    import torch
    from envidr_tpu_torch.ops import gather, scatter
    return [("scatter_add_rows", scatter.KERNEL),
            ("gather_rows<f32>", gather.KERNEL),
            ("gather_rows<round_bf16>", gather.KERNEL_BF16),
            ("scatter_add_rows<round_bf16>", scatter.KERNEL_BF16),
            ("scatter_rows_tiled<f32>", scatter.TILED[torch.float32]),
            ("scatter_rows_tiled<bf16>", scatter.TILED[torch.bfloat16])]


def cp_rows_libraries():
    """(name, CudaLibrary) of the CP row pair, which every CP path runs; kept
    apart from kernel_libraries, whose counts the CP phases hold at 0."""
    from envidr_tpu_torch.ops import cp_rows
    return [("cp_rows_gather", cp_rows.GATHER), ("cp_rows_scatter", cp_rows.SCATTER)]


def build_all():
    """One nvcc per source, all started together: {source stem: seconds|None}."""
    by_source = {lib.source: lib for _, lib in kernel_libraries() + cp_rows_libraries()}
    with ThreadPoolExecutor(len(by_source)) as ex:
        secs = list(ex.map(lambda lib: lib.build(), by_source.values()))
    return {src.stem: s for src, s in zip(by_source, secs)}


def check_kernel(row, kernel, source, replaces, shape, run, plain, library, nbytes,
                 tol, bench_rows=None):
    """One kernel against its plain version on the same inputs, then timed
    (CUDA events, L2 flushed; the kernel's median, ``ms``, and mean of the
    same 20 launches) beside its plain version, the library call (``(name,
    fn)`` or None) and the bytes bound.  ``tol`` is an absolute tolerance or a
    callable of the plain result.  ``bench_rows`` is ``(micro-benchmark,
    row-name pattern)``: the rows that launch this kernel for this table
    row."""
    import statistics
    import torch
    from envidr_tpu_torch.tools._timing import cuda_time, cuda_times
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    err = float((out - ref).abs().max())
    tol = tol(ref) if callable(tol) else tol
    if not err <= tol:
        raise AssertionError(f"{kernel} ({shape}) disagrees with its plain version: "
                             f"max_abs_err={err} > {tol}")
    times = cuda_times(run, 20, 3)
    ms, mean_ms = statistics.median(times) * 1e3, statistics.fmean(times) * 1e3
    plain_ms = cuda_time(plain, 20, 3) * 1e3
    library_ms = None if library is None else cuda_time(library[1], 20, 3) * 1e3
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ms < bound_ms:
        raise AssertionError(f"{kernel} ({shape}) timed at {ms} ms, below its bound "
                             f"{bound_ms} ms: a measuring fault")
    result = {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
              "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
              "row": row, "shape": shape, "tolerance": tol,
              "library": None if library is None else library[0], "bench_rows": bench_rows,
              "mean_ms": mean_ms}
    phase("kernels", f"row {row} {kernel} ok", shape=repr(shape), max_abs_err=err,
          tol=tol, ms=ms, mean_ms=mean_ms, plain_ms=plain_ms,
          library_ms="none" if library_ms is None else library_ms,
          library=repr(result["library"]), bound_ms=bound_ms)
    return result


def check_scatter(spec, B: int, W: int):
    """Row 1, scatter_add_rows at the train step's shape."""
    import numpy as np
    import torch
    from envidr_tpu_torch.ops import scatter

    L, s_max = spec.num_levels, spec.s_max
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, s, B) for s in spec.sizes]).astype(np.int32)
    idx = torch.from_numpy(idx).cuda()
    rows = torch.from_numpy(rng.standard_normal((L, B, W), dtype=np.float32)).cuda()
    flat_idx = (idx.long() + torch.arange(L, device="cuda")[:, None] * s_max).reshape(-1)
    flat_rows = rows.reshape(-1, W)

    def library():
        return torch.zeros((L * s_max, W), device="cuda").index_add_(0, flat_idx, flat_rows)

    return check_kernel(
        "1", "scatter_add_rows", "envidr_tpu_torch/csrc/scatter_rows.cu",
        "envidr_tpu/ops/pallas_scatter.py:64", f"L={L} B={B} W={W} S_max={s_max}",
        lambda: scatter.scatter_add_rows(idx, rows, s_max),
        lambda: scatter.scatter_add_rows_plain(idx, rows, s_max),
        ("index_add_", library), L * B * 4 + L * B * W * 4 + L * s_max * W * 4,
        SCATTER_ATOL)


def launch_floor():
    """The timing harness's floor (the kernels phase's timer): an empty kernel
    launched through the gathers' ctypes and launch path, and ``zero_()`` of
    the gathers' ``[B, W]`` f32 output, which writes its bytes and nothing
    else.  Median and mean of 20, as check_kernel times a kernel."""
    import statistics
    import torch
    from envidr_tpu_torch.ops import _cuda, gather
    from envidr_tpu_torch.tools._timing import cuda_times

    dev = torch.device("cuda")
    out = torch.empty((BENCH["B"], BENCH["W"]), device=dev)
    before = gather.EMPTY.launches
    times = {name: cuda_times(fn, 20, 3) for name, fn in (
        ("empty_launch", lambda: _cuda.launch(gather.EMPTY, "empty", dev, 0, 0, 0, 0, 0)),
        ("zero_out", out.zero_))}
    if gather.EMPTY.launches != before + 23:
        raise AssertionError("the empty kernel did not go through the launch path")
    readings = {**{f"{k}_ms": statistics.median(t) * 1e3 for k, t in times.items()},
                **{f"{k}_mean_ms": statistics.fmean(t) * 1e3 for k, t in times.items()}}
    phase("kernels", "floor", **readings)


def check_bench_kernels():
    """Rows 2-8, each kernel at the micro-benchmarks' shapes."""
    import torch
    from envidr_tpu_torch.ops import gather, scatter

    B, W, S, Ss = BENCH["B"], BENCH["W"], BENCH["S"], BENCH["S_small"]
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, S, (B,), device="cuda", generator=g, dtype=torch.int32)
    rows = torch.randn(B, W, device="cuda", generator=g)
    table = torch.randn(S, W, device="cuda", generator=g)
    idx_s = idx % Ss
    table_s = table[:Ss].contiguous()
    gsrc = "envidr_tpu_torch/csrc/gather_rows.cu"
    ssrc = "envidr_tpu_torch/csrc/scatter_rows.cu"
    bf16, f32 = torch.bfloat16, torch.float32

    def gather_bytes(i):        # index, the distinct rows it touches, output
        return B * 4 + torch.unique(i).numel() * W * 4 + B * W * 4

    def scatter_bytes(s):       # index, rows, output
        return B * 4 + B * W * 4 + s * W * 4

    def index_add(i, s):
        return ("index_add_", lambda: torch.zeros((s, W), device="cuda").index_add_(0, i, rows))

    def named(bench, name):     # one micro-benchmark row, by its exact name
        return (bench, re.escape(name))

    out = []
    for row, line, name in (("2", 182, f"pallas take (VMEM table S={Ss})"),
                            ("3", 209, f"pallas take_along_axis (S={Ss})")):
        out.append(check_kernel(
            row, "gather_rows<f32>", gsrc, f"tools/bench_scatter.py:{line}",
            f"table [{Ss},{W}] f32, idx [{B}]", lambda: gather.gather_rows(table_s, idx_s),
            lambda: gather.gather_rows_plain(table_s, idx_s),
            ("index_select", lambda: table_s.index_select(0, idx_s)),
            gather_bytes(idx_s), 0.0, named("bench_scatter", name)))
    out.append(check_kernel(
        "4", "gather_rows<round_bf16>", gsrc, "tools/bench_scatter.py:249",
        f"table [{S},{W}] f32, idx [{B}]", lambda: gather.gather_rows(table, idx, True),
        lambda: gather.gather_rows_plain(table, idx, True), None, gather_bytes(idx), 0.0,
        named("bench_scatter", "pallas one-hot MXU gather S=2^19")))
    out.append(check_kernel(
        "5", "scatter_add_rows<round_bf16>", ssrc, "tools/bench_scatter.py:287",
        f"idx [{B}], rows [{B},{W}] -> [{S},{W}]",
        lambda: scatter.scatter_add_rows(idx[None], rows[None], S, round_bf16=True),
        lambda: scatter.scatter_add_rows_plain(idx[None], rows[None], S, round_bf16=True),
        None, scatter_bytes(S), FEW_ROWS_ATOL,
        named("bench_scatter", "pallas one-hot MXU scatter S=2^19")))
    out.append(check_kernel(
        "6", "scatter_rows_tiled<f32>", ssrc, "tools/bench_scatter.py:324",
        f"idx [{B}], rows [{B},{W}] -> [{Ss},{W}]",
        lambda: scatter.scatter_rows_tiled(idx_s, rows, Ss),
        lambda: scatter.scatter_rows_tiled_plain(idx_s, rows, Ss),
        index_add(idx_s, Ss), scatter_bytes(Ss), SCATTER_ATOL,
        named("bench_scatter", f"pallas fori scatter (S={Ss} VMEM)")))
    for s_lvl in (4096, 32768, 131072):
        i = idx % s_lvl
        out.append(check_kernel(
            "7", "scatter_rows_tiled<f32>", ssrc, "tools/bench_scatter2.py:126",
            f"idx [{B}], rows [{B},{W}] -> [{s_lvl},{W}]",
            lambda: scatter.scatter_rows_tiled(i, rows, s_lvl),
            lambda: scatter.scatter_rows_tiled_plain(i, rows, s_lvl),
            index_add(i, s_lvl), scatter_bytes(s_lvl), SCATTER_ATOL,
            ("bench_scatter2", rf"pallas fori S={s_lvl} K=\d+ acc \(\d+MB\)")))
    for acc, name in ((f32, "scatter_rows_tiled<f32>"), (bf16, "scatter_rows_tiled<bf16>")):
        out.append(check_kernel(
            "8", name, ssrc, "tools/bench_gs4.py:51",
            f"idx [{B}], rows [{B},{W}] -> [{S},{W}], {str(acc)[6:]} accumulator",
            lambda: scatter.scatter_rows_tiled(idx, rows, S, acc),
            lambda: scatter.scatter_rows_tiled_plain(idx, rows, S, acc),
            index_add(idx, S) if acc == f32 else None, scatter_bytes(S),
            FEW_ROWS_ATOL if acc == f32
            else (lambda ref: BF16_ACC_RTOL * float(ref.abs().max())),
            ("bench_gs4", rf"tiled pallas n=\d+ K=\d+ {str(acc)[6:]} *\(\d+MB\)")))
    return out


def check_cp_rows():
    """Rows 9-10, the CP row pair at the CP train step's shapes
    (tools/cp_rows_cases.py): N = 524,288 slots, 87% of them in runs of 28
    at one row pair, three of the encoder's table sizes.  The scatter sums
    in another f32 order than index_add_: within 2^-20 of the largest row's
    sum of magnitudes (the cuda-marked test holds each element to its own
    row's)."""
    import torch
    from envidr_tpu_torch.ops import cp_rows
    from envidr_tpu_torch.tools import cp_rows_cases as cases

    src = "envidr_tpu_torch/csrc/cp_rows.cu"
    replaces = "none (ops/cp.py:cp_encode's index_select pair and its index_add_s)"
    N, rank = cases.N, cases.RANK
    g = torch.Generator(device="cuda").manual_seed(9)
    dv0 = torch.randn(N, rank, device="cuda", generator=g)
    dv1 = torch.randn(N, rank, device="cuda", generator=g)
    out = []
    for R in cases.ROWS:
        i0 = cases.step_indices(R, generator=torch.Generator().manual_seed(R), device="cuda")
        table = torch.randn(R, rank, device="cuda", generator=g)
        gather_bytes, scatter_bytes = cases.bytes_moved(N, R, rank)
        mags = cp_rows.scatter_pair_plain(dv0.abs(), dv1.abs(), i0, R)
        out.append(check_kernel(
            "9", "cp_rows_gather", src, replaces, f"table [{R},{rank}] f32, i0 [{N}]",
            lambda: cp_rows.gather_pair(table, i0)[0],
            lambda: cp_rows.gather_pair_plain(table, i0)[0],
            ("index_select x2", lambda: (table.index_select(0, i0),
                                         table.index_select(0, i0 + 1))),
            gather_bytes, 0.0))
        out.append(check_kernel(
            "10", "cp_rows_scatter", src, replaces,
            f"dv0, dv1 [{N},{rank}] f32, i0 [{N}] -> [{R},{rank}]",
            lambda: cp_rows.scatter_pair(dv0, dv1, i0, R),
            lambda: cp_rows.scatter_pair_plain(dv0, dv1, i0, R),
            ("index_add_ x2", lambda: torch.zeros((R, rank), device="cuda")
             .index_add_(0, i0, dv0).index_add_(0, i0 + 1, dv1)),
            scatter_bytes, 2.0**-20 * float(mags.max())))
        v1, p1 = cp_rows.gather_pair(table, i0)[1], cp_rows.gather_pair_plain(table, i0)[1]
        if not torch.equal(v1, p1):
            raise AssertionError(f"cp_rows_gather (R={R}): the second tap differs from "
                                 "index_select")
    return out


def bf16_accumulator_readings():
    """Readings behind BF16_ACC_RTOL: scatter_rows_tiled<bf16> and its plain
    version (index_add_ into bf16, also atomic on the card) sum the same
    bf16-rounded rows in two orders; each against the other and against the
    f64 sum, at 0.5 rows a slot (row 8), 1 (the cuda-marked test) and 64 (a
    dense 4096-row level)."""
    import torch
    from envidr_tpu_torch.ops import scatter

    W = BENCH["W"]
    for S, B in ((BENCH["S"], BENCH["B"]), (8192, 8192), (4096, BENCH["B"])):
        g = torch.Generator(device="cuda").manual_seed(1)
        idx = torch.randint(0, S, (B,), device="cuda", generator=g, dtype=torch.int32)
        rows = torch.randn(B, W, device="cuda", generator=g)
        kern = scatter.scatter_rows_tiled(idx, rows, S, torch.bfloat16)
        plain = scatter.scatter_rows_tiled_plain(idx, rows, S, torch.bfloat16)
        exact = torch.zeros((S, W), dtype=torch.float64, device="cuda").index_add_(
            0, idx.long(), rows.to(torch.bfloat16).double())
        top = float(exact.abs().max())
        phase("kernels", "bf16 accumulator reading", S=S, B=B, rows_per_slot=B / S,
              max_abs_sum=top, kernel_vs_plain=float((kern - plain).abs().max()),
              kernel_vs_f64=float((kern.double() - exact).abs().max()),
              plain_vs_f64=float((plain.double() - exact).abs().max()),
              rtol_2_7=2.0**-7 * top, tol=BF16_ACC_RTOL * top)


def check_hash():
    """The hash encoder (forward, first and second order, the row indices)
    and the sorted scatter: card against CPU at a small size."""
    import torch
    from envidr_tpu_torch.ops import hashgrid as hg

    spec = hg.HashGridSpec(num_levels=6, level_dim=2, base_resolution=8,
                           desired_resolution=2048, log2_hashmap_size=14, indexing="hash")
    gen = torch.Generator().manual_seed(5)
    emb = torch.rand(spec.table_size, 2, generator=gen) * 0.2 - 0.1
    x = torch.rand(4096, 3, generator=gen)
    proj = torch.randn(spec.output_dim, generator=gen)
    results = []
    for dev in ("cpu", "cuda"):
        e = emb.to(dev).requires_grad_(True)
        xx = x.to(dev).requires_grad_(True)
        out = hg.hash_encode(xx, e, spec)
        g1 = torch.autograd.grad((out ** 2).sum(), (e, xx))
        f = (hg.hash_encode(xx, e, spec) @ proj.to(dev)).sum()
        (gx,) = torch.autograd.grad(f, xx, create_graph=True)
        g2 = torch.autograd.grad(((gx.norm(dim=-1) - 1.0) ** 2).sum(), (e, xx))
        idx = hg.hash_grid_indices(spec, x.to(dev))
        results.append([t.detach().cpu() for t in (out, *g1, *g2, idx)])
    (o0, a0, b0, c0, d0, i0), (o1, a1, b1, c1, d1, i1) = results

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)

    errs = {"fwd": float((o0 - o1).abs().max()), "d_emb": rel(a0, a1), "d_x": rel(b0, b1),
            "eik_d_emb": rel(c0, c1), "eik_d_x": rel(d0, d1)}
    tols = {"fwd": HASH_FWD_ATOL, "d_emb": HASH_GRAD1_RTOL, "d_x": HASH_GRAD1_RTOL,
            "eik_d_emb": HASH_GRAD2_RTOL, "eik_d_x": HASH_GRAD2_RTOL}
    bad = [k for k in errs if not errs[k] <= tols[k]]
    if bad or not torch.equal(i0, i1):
        raise AssertionError(f"hash encoder card vs CPU: {errs} (tolerances {tols}), "
                             f"indices equal {torch.equal(i0, i1)}")
    sidx = torch.randint(0, 4096, (3, 5000), generator=gen)
    srows = torch.randn(3, 5000, 16, generator=gen) * 1e-2
    ref = hg._sorted_segment_rows(sidx, srows, 4096)
    got = hg._sorted_segment_rows(sidx.cuda(), srows.cuda(), 4096).cpu()
    errs["sorted"] = float((ref - got).abs().max())
    if not errs["sorted"] <= SORTED_ATOL:
        raise AssertionError(f"sorted scatter card vs CPU: {errs['sorted']} > {SORTED_ATOL}")
    return {**errs, "tolerances": tols, "sorted_tol": SORTED_ATOL, "indices_equal": True}


def _parity_step(device: str, dtype, custom_grad: str):
    """One small train-step loss, image and gradients, as f64 CPU tensors."""
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.train.schedules import resolve
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(os.path.join(ROOT, "configs", "synth_spheres.ini"),
                       hash_scatter_impl="mixed", hash_custom_grad=custom_grad, num_levels=4,
                       log2_hashmap_size=12, desired_resolution=64, hidden_dim=16,
                       hidden_dim_color=16, hidden_dim_env=16)
    cfg = network_config(opt)
    gen = torch.Generator().manual_seed(3)
    rays_o = torch.randn(256, 3, generator=gen) * 0.1 + torch.tensor([0.0, 0.0, 2.5])
    target = torch.rand(256, 3, generator=gen) * 0.6 - 0.3
    rays_d = torch.nn.functional.normalize(target - rays_o, dim=-1)
    gt = torch.rand(256, 3, generator=gen)
    alpha = (torch.rand(256, generator=gen) > 0.5).float()
    net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(0)).to(dtype)
    tr = Trainer(opt, cfg, device=device, net=net)
    tr.grid = tr.grid._replace(bitfield=torch.ones_like(tr.grid.bitfield))
    args = [t.to(device, dtype) for t in (rays_o, rays_d, gt, torch.ones(256, 3), alpha)]
    loss, out, _ = tr.forward_loss(*args, K=32, sched=resolve(opt, 1, 0))
    loss.backward()
    return {"loss": loss.detach().double().cpu().reshape(1),
            "image": out["image"].detach().double().cpu(),
            **{n: p.grad.detach().double().cpu() for n, p in tr.net.named_parameters()}}


def check_parity():
    """One small train-step loss, image and gradients: the card (kernels)
    against the CPU (plain versions), both f32, gated by PARITY_RTOL; and, as
    a reading of the f32 step's own error, the CPU f32 step against an f64
    one (autograd's table gradient: the scatter takes f32 rows only).  Each
    reading is max |a - b| / max |b| per tensor."""
    import torch

    def rel(a, b):
        return {n: float((a[n] - b[n]).abs().max()) / max(float(b[n].abs().max()), 1e-30)
                for n in b}

    cpu = _parity_step("cpu", torch.float32, "on")
    card = rel(_parity_step("cuda", torch.float32, "on"), cpu)
    f64 = rel(cpu, _parity_step("cpu", torch.float64, "off"))
    phase("parity", "card_f32_vs_cpu_f32", json.dumps(card))
    phase("parity", "cpu_f32_vs_cpu_f64", json.dumps(f64))
    worst = max(card, key=card.get)
    if not card[worst] <= PARITY_RTOL:
        raise AssertionError(f"card and CPU train steps disagree: {worst} "
                             f"{card[worst]} > {PARITY_RTOL}")
    return {"max_rel_err": card[worst], "worst": worst, "tolerance": PARITY_RTOL,
            "f32_vs_f64_max": max(f64.values()), "f32_vs_f64_worst": max(f64, key=f64.get)}


# small cuts of the CP configs for the card-against-CPU steps: 4 levels, rank
# 8, width-16 MLPs; the ours config keeps the pretrain's rendering-MLP widths
CP_PARITY_CUT = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16)
CP_PARITY = {"synth_spheres_cp.ini": (CP_INI, dict(hidden_dim_color=16, hidden_dim_env=16)),
             "scenes/synth_spheres_ours.ini": (OURS_INI, dict(color_mlp_path=PRETRAIN_CKPT))}


def _cp_parity_step(device: str, cp_dtype: str, config: str = "synth_spheres_cp.ini"):
    """One step of a small CP + NeuS model (``config`` cut by CP_PARITY_CUT),
    its CP encoder in ``cp_dtype``: loss, image and gradients as f64 CPU
    tensors."""
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.train.schedules import resolve
    from envidr_tpu_torch.train.trainer import Trainer

    path, extra = CP_PARITY[config]
    opt = load_options(path, **CP_PARITY_CUT, **extra)
    cfg = network_config(opt)
    gen = torch.Generator().manual_seed(3)
    rays_o = torch.randn(256, 3, generator=gen) * 0.1 + torch.tensor([0.0, 0.0, 2.5])
    target = torch.rand(256, 3, generator=gen) * 0.6 - 0.3
    rays_d = torch.nn.functional.normalize(target - rays_o, dim=-1)
    gt = torch.rand(256, 3, generator=gen)
    alpha = (torch.rand(256, generator=gen) > 0.5).float()
    net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(0))
    net.cp_spec = dataclasses.replace(net.cp_spec, compute_dtype=cp_dtype)
    tr = Trainer(opt, cfg, device=device, net=net)
    bits = torch.rand(tr.grid.bitfield.shape, generator=gen) < 0.6
    tr.grid = tr.grid._replace(bitfield=bits.to(device))
    args = [t.to(device) for t in (rays_o, rays_d, gt, torch.ones(256, 3), alpha)]
    loss, out, _ = tr.forward_loss(*args, K=32, sched=resolve(opt, 1, 250))
    loss.backward()
    return {"loss": loss.detach().double().cpu().reshape(1),
            "image": out["image"].detach().double().cpu(),
            **{n: p.grad.detach().double().cpu() for n, p in tr.net.named_parameters()}}


def check_cp_parity(config: str = "synth_spheres_cp.ini", label: str = "cp_parity"):
    """A CP step on the card against the CPU, per tensor, max |a - b| /
    max |b|: the encoder in f32 under PARITY_RTOL, in bf16 under
    CP_BF16_RTOL.  Every march must take the config's path (coarse for
    synth_spheres_cp.ini, dense for the ours config)."""
    from envidr_tpu_torch.ops.marching import MARCH_PATHS

    MARCH_PATHS.clear()
    result = {}
    for cp_dtype, tol in (("float32", PARITY_RTOL), ("bfloat16", CP_BF16_RTOL)):
        cpu = _cp_parity_step("cpu", cp_dtype, config)
        card = _cp_parity_step("cuda", cp_dtype, config)
        rel = {n: float((card[n] - cpu[n]).abs().max()) / max(float(cpu[n].abs().max()), 1e-30)
               for n in cpu}
        phase(label, f"card_vs_cpu_{cp_dtype}", json.dumps(rel))
        worst = max(rel, key=rel.get)
        if not rel[worst] <= tol:
            raise AssertionError(f"{config} step ({cp_dtype} encoder): card and CPU disagree "
                                 f"on {worst}: {rel[worst]} > {tol}")
        result[f"{cp_dtype}_max_rel_err"] = rel[worst]
        result[f"{cp_dtype}_worst"] = worst
        result[f"{cp_dtype}_tolerance"] = tol
    path = "coarse" if config == "synth_spheres_cp.ini" else "dense"
    if not MARCH_PATHS[path] or sum(MARCH_PATHS.values()) != MARCH_PATHS[path]:
        raise AssertionError(f"{label} marches: {dict(MARCH_PATHS)}; all must be {path}")
    return result


def timed_steps(trainer, data, steps: int, label: str):
    """``steps`` train steps, each that neither starts an epoch nor refreshes
    the grid under sync debug mode "error" (any synchronising call in it
    raises): (losses, ms of each step, steps checked, each step's metrics)."""
    import numpy as np
    import torch

    losses, step_ms, sync_free, metrics = [], [], 0, []
    for i in range(steps):
        guard = not trainer.step_may_sync()
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if guard else "default")
        try:
            metrics.append(trainer.train_step(data))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        sync_free += guard
        losses.append(float(metrics[-1]["loss"]))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"{label} step {i + 1}: loss {losses[-1]}")
    notfinite = int(trainer.notfinite)
    if notfinite or sync_free < steps - 3:
        raise AssertionError(f"{label}: notfinite {notfinite}, {sync_free} of {steps} steps "
                             "checked for host syncs")
    return losses, step_ms, sync_free, metrics


def assert_widths(config: str, widths: dict, want: dict):
    if widths != want:
        raise AssertionError(f"{config} is not at its published width: {widths} != {want}")


def train_cp(libs):
    """synth_spheres_cp.ini at full width on the in-memory scene: 20 steps,
    the sync-free ones under sync debug mode "error".  Zeroes the launch
    counts first; every step must run the CP row pair, one scatter a table
    (levels x 3) and at least as many gathers.  Returns the pair's launches
    by name."""
    import numpy as np
    import torch
    from envidr_tpu_torch import obs
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.ops.marching import MARCH_PATHS
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(CP_INI)
    cfg = network_config(opt)
    spec = cfg.cp_spec
    widths = dict(levels=spec.num_levels, rank=spec.rank, hidden=cfg.hidden_dim,
                  hidden_color=cfg.hidden_dim_color, hidden_env=cfg.hidden_dim_env,
                  ide_degree=cfg.sh_degree, rays=opt.num_rays, max_steps=opt.max_steps,
                  early_stop=opt.early_stop_steps, compute_dtype=spec.compute_dtype)
    want = dict(levels=16, rank=32, hidden=64, hidden_color=64, hidden_env=64, ide_degree=4,
                rays=4096, max_steps=512, early_stop=64, compute_dtype="bfloat16")
    assert_widths("synth_spheres_cp.ini", {**widths, "neus": cfg.use_neus_sdf,
                                           "coarse_march": opt.coarse_march},
                  {**want, "neus": True, "coarse_march": True})
    data = SynthSpheres("train", scale=opt.scale)
    trainer = Trainer(opt, cfg)
    pair = dict(cp_rows_libraries())
    for lib in [*libs.values(), *pair.values()]:     # the CP path starts here
        lib.launches = 0
    paths = {k: obs.COUNTERS.get(f"cp_rows.scatter.{k}", 0) for k in ("shared", "global")}
    MARCH_PATHS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.update_extra_state()
    losses, step_ms, sync_free, ms = timed_steps(trainer, data, TRAIN_STEPS, "train_cp")
    launches = {k: lib.launches for k, lib in pair.items()}
    paths = {k: obs.COUNTERS.get(f"cp_rows.scatter.{k}", 0) - v for k, v in paths.items()}
    tables = spec.num_levels * spec.input_dim
    if (launches["cp_rows_scatter"] != tables * TRAIN_STEPS
            or launches["cp_rows_gather"] < tables * TRAIN_STEPS
            or sum(paths.values()) != launches["cp_rows_scatter"]):
        raise AssertionError(f"train_cp: CP row pair launches {launches}, scatter paths "
                             f"{paths}; expected {tables} scatters a step, as many gathers "
                             "or more")
    m = ms[-1]
    ms_per_step = float(np.mean(step_ms[3:]))
    notfinite = int(trainer.notfinite)
    if MARCH_PATHS["dense"] or MARCH_PATHS["coarse"] != TRAIN_STEPS:
        raise AssertionError(f"train_cp marches: {dict(MARCH_PATHS)}; every step must "
                             "take the coarse path")
    phase("train_cp", config="synth_spheres_cp.ini", widths=repr(widths), steps=TRAIN_STEPS,
          loss_1=losses[0], loss_20=losses[-1], notfinite=notfinite,
          mean_samples_per_ray=float(m["mean_count"]), K=m["K"], sync_free_steps=sync_free,
          ms_per_step_after_3=ms_per_step, rays_per_s=opt.num_rays / ms_per_step * 1e3,
          first_step_ms=step_ms[0], coarse_marches=MARCH_PATHS["coarse"],
          dense_marches=MARCH_PATHS["dense"],
          grid_occupied=float(trainer.grid.bitfield.float().mean()),
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
          cp_rows_launches=repr(" ".join(f"{k}:{v}" for k, v in launches.items())),
          scatter_paths=repr(" ".join(f"{k}:{v}" for k, v in paths.items())))
    return launches


def render_cp(libs):
    """The trained CP checkpoint on the card: val view 0 at 400x400 (the second
    of two renders timed), PSNR against the analytic ground truth."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.ops.marching import MARCH_PATHS
    from envidr_tpu_torch.train.metrics import psnr
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(CP_INI)
    trainer = Trainer(opt, network_config(opt))
    trainer.load_checkpoint(CP_CKPT)
    val = SynthSpheres("val", scale=opt.scale)
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = trainer.render_image(val.poses[0], val.intrinsics, val.H, val.W, use_ema=False)
        render_s = time.perf_counter() - t
    launches = {k: lib.launches for k, lib in libs.items()}    # the CP path ends here
    img = res["image"]
    gt = val.images[0].astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    p = psnr(img, gt)
    if img.shape != (val.H, val.W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"render_cp: shape {img.shape}, finite {np.isfinite(img).all()}")
    if not p > CP_PSNR_MIN_DB:
        raise AssertionError(f"render_cp: checkpoint PSNR {p} dB <= {CP_PSNR_MIN_DB}")
    if MARCH_PATHS["dense"]:
        raise AssertionError(f"render_cp marches: {dict(MARCH_PATHS)}; all must be coarse")
    phase("render_cp", checkpoint=os.path.relpath(CP_CKPT, ROOT), epoch=trainer.epoch,
          size=f"{val.H}x{val.W}", psnr_db=p, min_psnr_db=CP_PSNR_MIN_DB,
          eval_K=trainer.eval_samples_budget(), seconds=render_s,
          eval_rays_per_s=val.H * val.W / render_s,
          cp_path_launches=repr(" ".join(f"{k}:{v}" for k, v in launches.items())))
    return trainer, val, img, gt


def lpips_phase(trainer, val, img, gt, libs):
    """The port's LPIPS of render_cp's view on the card against the CPU, its
    time, and evaluate filling lpips."""
    import numpy as np
    import torch
    from envidr_tpu_torch.train.lpips import LPIPS

    for lib in libs.values():
        lib.launches = 0
    card, cpu = LPIPS(device="cuda"), LPIPS(device="cpu")
    v_card, v_cpu = card(img, gt), cpu(img, gt)
    rel = abs(v_card - v_cpu) / abs(v_cpu)
    if not np.isfinite(v_card) or rel > LPIPS_CARD_RTOL:
        raise AssertionError(f"lpips: card {v_card} against cpu {v_cpu} (rel {rel})")
    x0 = torch.as_tensor(img, device="cuda").permute(2, 0, 1)[None] * 2 - 1
    x1 = torch.as_tensor(gt, device="cuda").permute(2, 0, 1)[None] * 2 - 1
    times = []
    with torch.no_grad():
        for _ in range(LPIPS_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            card.distance(x0, x1)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    trainer.evaluate(val, max_images=1, track_best=False)
    r = trainer.stats["results"][-1]
    if r["lpips_kind"] != "alex_untrained" or not np.isfinite(r["lpips"] or np.nan):
        raise AssertionError(f"lpips: evaluate gave {r}")
    _assert_no_launches(libs, "lpips")
    phase("lpips", size=f"{img.shape[0]}x{img.shape[1]}", kind=card.kind, card=v_card, cpu=v_cpu,
          rel_diff=rel, tolerance=LPIPS_CARD_RTOL, ms=float(np.median(times)),
          evaluate_psnr=r["psnr"], evaluate_lpips=r["lpips"], evaluate_kind=r["lpips_kind"])


def fixtures_phase(train):
    """ensure_synth_spheres at its canonical size, decoded back by the port."""
    import tempfile

    import numpy as np
    from envidr_tpu_torch.data.fixtures import (
        CANONICAL_N_TRAIN, CANONICAL_SIZE, ensure_synth_spheres,
    )
    from envidr_tpu_torch.data.nerf_dataset import NeRFDataset

    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        ensure_synth_spheres(root, CANONICAL_SIZE, CANONICAL_N_TRAIN)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        ds = NeRFDataset(root, "train", scale=0.33)
        decode_s = time.perf_counter() - t
        files = sum(len(f) for _, _, f in os.walk(root))
    if ds.images.shape != train.images.shape or not np.array_equal(ds.images, train.images):
        raise AssertionError(f"fixtures: decoded {ds.images.shape} differ from the in-memory "
                             f"scene {train.images.shape}")
    phase("fixtures", size=CANONICAL_SIZE, train_views=len(ds), files=files, write_s=write_s,
          decode_s=decode_s, bit_equal=True)


def _state_equal(a: dict, b: dict, prefix: str) -> bool:
    import numpy as np
    keys = [k for k in a if k.startswith(prefix)]
    return bool(keys) and all(np.array_equal(a[k], b[k]) for k in keys)


def _step1_against_one(two: dict, one: dict, lr: float):
    """Step 1 of rank 0 against the one-process step: (largest relative
    error of a tensor's Adam first moment, i.e. its summed gradient; largest
    change of a parameter whose gradient is above PARALLEL_SIGNIFICANT of
    its tensor's max; largest change of any parameter; tensors)."""
    import numpy as np
    grad_err = sig_err = param_err = 0.0
    names = [k[len("step1/adam/m/"):] for k in one if k.startswith("step1/adam/m/")]
    for name in names:
        m = one[f"step1/adam/m/{name}"].astype(np.float64)
        grad_err = max(grad_err, float(np.abs(m - two[f"step1/adam/m/{name}"]).max()
                                       / max(np.abs(m).max(), 1e-30)))
        d = np.abs(one[f"step1/param/{name}"].astype(np.float64) - two[f"step1/param/{name}"])
        big = np.abs(m) > PARALLEL_SIGNIFICANT * np.abs(m).max()
        sig_err = max(sig_err, float(d[big].max(initial=0.0)))
        param_err = max(param_err, float(d.max()))
    if not names or param_err > 2.0 * lr * (1 + 1e-6):
        raise AssertionError(f"parallel: {len(names)} tensors, a parameter {param_err} from the "
                             f"one-process step's (a flipped first Adam step: 2 lr = {2 * lr})")
    return grad_err, sig_err, param_err, len(names)


def parallel_phase():
    """Two gloo ranks on the card against one process: step 1 with the CP
    encoder in f32 and in bf16, the ranks bit-equal, ms a step (bf16), the
    eval render; then nccl at world 1."""
    import tempfile

    import numpy as np
    import torch
    from envidr_tpu_torch.config import card_options
    from envidr_tpu_torch.parallel.tiny_step import render_checkpoint, run_config, run_group

    opt = card_options(CP_INI)
    lr = max(opt.lr, opt.plr or opt.lr, opt.slr or opt.lr, opt.elr or opt.lr)
    readings = {}
    with tempfile.TemporaryDirectory() as out:
        t = time.perf_counter()
        for cp_dtype, steps, tol in (("float32", 0, PARALLEL_F32_RTOL),
                                     ("bfloat16", PARALLEL_STEPS, CP_BF16_RTOL)):
            r0, r1 = run_group(2, "train", out, "--device", "cuda", "--config", CP_INI,
                               "--steps", str(steps), "--cp-dtype", cp_dtype,
                               timeout=PARALLEL_TIMEOUT_S)
            one = run_config(None, CP_INI, device="cuda", steps=steps, warmup=min(steps, 3),
                             cp_dtype=cp_dtype)
            torch.cuda.empty_cache()
            if str(r0["backend"]) != "gloo":
                raise AssertionError(f"parallel: backend {r0['backend']}, expected gloo")
            for prefix in ("step1/", "last/"):
                if not _state_equal(r0, r1, prefix):
                    bad = [k for k in r0 if k.startswith(prefix)
                           and not np.array_equal(r0[k], r1[k])]
                    raise AssertionError(f"parallel ({cp_dtype}): ranks differ after "
                                         f"{prefix[:-1]}: {bad[:8]}")
            grad_err, sig_err, param_err, n = _step1_against_one(r0, one, lr)
            loss_err = abs(float(r0["loss_1"]) - one["loss_1"]) / abs(one["loss_1"])
            if grad_err > tol or sig_err > PARALLEL_PARAM_ATOL or loss_err > PARALLEL_LOSS_RTOL:
                raise AssertionError(
                    f"parallel ({cp_dtype}): step 1 against one process over {n} tensors: "
                    f"gradients {grad_err} of their max (bound {tol}), parameters with a "
                    f"significant gradient {sig_err} (bound {PARALLEL_PARAM_ATOL}), loss "
                    f"{loss_err} (bound {PARALLEL_LOSS_RTOL})")
            readings[cp_dtype] = dict(
                grad_rel_err=grad_err, grad_tolerance=tol, param_significant_max=sig_err,
                param_max=param_err, loss_rel_err=loss_err,
                notfinite=(int(r0["notfinite"]), one["notfinite"]))
            if steps:
                readings[cp_dtype].update(ms_per_step_2_ranks=float(r0["ms_per_step"]),
                                          ms_per_step_1_rank=one["ms_per_step"],
                                          ratio=float(r0["ms_per_step"]) / one["ms_per_step"])
        workers_s = time.perf_counter() - t
        renders = run_group(2, "render", out, "--device", "cuda", "--config", CP_INI,
                            "--ckpt", CP_CKPT, timeout=PARALLEL_TIMEOUT_S)
        nccl = run_group(1, "allreduce", out, "--device", "cuda", "--backend", "nccl",
                         timeout=PARALLEL_TIMEOUT_S)[0]
    one_render = render_checkpoint(None, CP_INI, CP_CKPT, device="cuda")
    img_err = float(np.abs(renders[0]["image"] - one_render["image"]).max())
    if img_err > PARALLEL_EVAL_ATOL or not np.array_equal(renders[0]["image"], renders[1]["image"]):
        raise AssertionError(f"parallel: the 2-rank render differs from the 1-rank one by "
                             f"{img_err} > {PARALLEL_EVAL_ATOL}, or between ranks")
    if str(nccl["backend"]) != "nccl" or not np.array_equal(nccl["sum"], np.arange(4.0)):
        raise AssertionError(f"parallel: nccl world 1 gave {nccl}")
    for cp_dtype, r in readings.items():
        phase("parallel", f"step1_{cp_dtype}", json.dumps(r))
    bf16 = readings["bfloat16"]
    phase("parallel", config="synth_spheres_cp.ini", rays=opt.num_rays, ranks=2,
          backend="gloo", sync_debug="off (gloo copies through the host)",
          ranks_bit_equal=True, steps=1 + 3 + PARALLEL_STEPS,
          ms_per_step_2_ranks=bf16["ms_per_step_2_ranks"],
          ms_per_step_1_rank=bf16["ms_per_step_1_rank"], ratio=bf16["ratio"],
          eval_max_abs_diff=img_err, eval_tolerance=PARALLEL_EVAL_ATOL,
          render_s_2_ranks=float(renders[0]["render_s"]), render_s_1_rank=one_render["render_s"],
          nccl_world1_allreduce=nccl["sum"].tolist(), train_s=workers_s)


def _launches(libs) -> str:
    return repr(" ".join(f"{k}:{lib.launches}" for k, lib in libs.items()))


def _assert_no_launches(libs, name: str):
    """A path that runs no kernel: every count is still 0 since it was set."""
    launched = {k: lib.launches for k, lib in libs.items() if lib.launches}
    if launched:
        raise AssertionError(f"{name}: kernels launched on a path that runs none: {launched}")


def _val_view_psnr(val, img) -> float:
    import numpy as np
    from envidr_tpu_torch.train.metrics import psnr
    gt = val.images[0].astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])         # white background
    return psnr(img, gt)


def train_ours(libs):
    """ENVIDR's per-scene recipe at its published width, the rendering MLPs
    of the pretrain frozen: 20 steps.  Returns the trainer for relight."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.ops.marching import MARCH_PATHS
    from envidr_tpu_torch.train.trainer import Trainer, frozen_modules, read_checkpoint

    opt = load_options(OURS_INI, color_mlp_path=PRETRAIN_CKPT)
    cfg = network_config(opt)
    spec = cfg.cp_spec
    frozen = frozen_modules(opt)
    assert_widths("synth_spheres_ours.ini", dict(
        levels=spec.num_levels, rank=spec.rank, compute_dtype=spec.compute_dtype,
        hidden=cfg.hidden_dim, hidden_color=cfg.hidden_dim_color, hidden_env=cfg.hidden_dim_env,
        ide_degree=cfg.sh_degree, geo_feat=cfg.geo_feat_dim, env_feat=cfg.env_feat_dim,
        rays=opt.num_rays, max_steps=opt.max_steps, early_stop=opt.early_stop_steps,
        neus=cfg.use_neus_sdf, coarse_march=opt.coarse_march, frozen=sorted(frozen)), dict(
        levels=16, rank=32, compute_dtype="bfloat16", hidden=64, hidden_color=64,
        hidden_env=160, ide_degree=4, geo_feat=12, env_feat=12, rays=4096, max_steps=512,
        early_stop=64, neus=True, coarse_march=False, frozen=["color_net", "diffuse_net"]))
    payload = read_checkpoint(PRETRAIN_CKPT)
    ckpt = payload["ema"] if "ema" in payload else payload["params"]      # what was loaded
    data = SynthSpheres("train", scale=opt.scale)
    trainer = Trainer(opt, cfg)
    start = {name: [p.detach().clone() for p in module.parameters()]
             for name, module in trainer.net.named_children() if name not in frozen}
    for lib in libs.values():                        # the ours path starts here
        lib.launches = 0
    MARCH_PATHS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.update_extra_state()
    losses, step_ms, sync_free, ms = timed_steps(trainer, data, TRAIN_STEPS, "train_ours")
    m = ms[-1]
    launches = _launches(libs)                       # and ends here
    ms_per_step = float(np.mean(step_ms[3:]))
    for net, which in ((trainer.net, "net"), (trainer.ema_net, "EMA net")):
        for name in sorted(frozen):
            for i, layer in enumerate(getattr(net, name)):
                want = ckpt[name][i]
                if not (torch.equal(layer.weight.cpu(), torch.from_numpy(want["w"].T))
                        and torch.equal(layer.bias.cpu(), torch.from_numpy(want["b"]))):
                    raise AssertionError(f"train_ours: frozen {name}[{i}] of the {which} moved")
    still = [name for name, ps in start.items()
             if all(torch.equal(a, b) for a, b in zip(ps, getattr(trainer.net, name).parameters()))]
    if still:
        raise AssertionError(f"train_ours: trainable groups {still} did not move")
    if MARCH_PATHS["coarse"] or MARCH_PATHS["dense"] != TRAIN_STEPS:
        raise AssertionError(f"train_ours marches: {dict(MARCH_PATHS)}; every step must take "
                             "the dense path (the config sets no coarse_march)")
    phase("train_ours", config="scenes/synth_spheres_ours.ini",
          color_mlp_path=os.path.relpath(PRETRAIN_CKPT, ROOT), frozen=repr(sorted(frozen)),
          steps=TRAIN_STEPS, loss_1=losses[0], loss_20=losses[-1],
          notfinite=int(trainer.notfinite), sync_free_steps=sync_free,
          ms_per_step_after_3=ms_per_step, rays_per_s=opt.num_rays / ms_per_step * 1e3,
          first_step_ms=step_ms[0], mean_samples_per_ray=float(m["mean_count"]), K=m["K"],
          coarse_marches=MARCH_PATHS["coarse"], dense_marches=MARCH_PATHS["dense"],
          frozen_bit_equal=True, trainable_moved=repr(sorted(start)),
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)
    return trainer, opt


def relight(trainer, opt):
    """Val view 0 at 400x400 before and after swapping in env_net_5.pth."""
    import numpy as np
    import torch
    from envidr_tpu_torch.data.synth_scene import SynthSpheres

    val = SynthSpheres("val", scale=opt.scale)
    images, secs = [], []
    for swap in (False, True):
        if swap:
            trainer.swap_env_net(ENV_NET)
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = trainer.render_image(val.poses[0], val.intrinsics, val.H, val.W)["image"]
        secs.append(time.perf_counter() - t)
        if img.shape != (val.H, val.W, 3) or not np.isfinite(img).all():
            raise AssertionError(f"relight: shape {img.shape}, finite {np.isfinite(img).all()}")
        images.append(img)
    diff = float(np.abs(images[1] - images[0]).mean())
    if not diff > 0.0:
        raise AssertionError("relight: the swapped env net changed no pixel")
    phase("relight", env_net=os.path.relpath(ENV_NET, ROOT), size=f"{val.H}x{val.W}",
          seconds_before=secs[0], seconds_after=secs[1], mean_abs_diff=diff,
          psnr_before_db=_val_view_psnr(val, images[0]),
          psnr_after_db=_val_view_psnr(val, images[1]))


def render_laplace():
    """The trained Laplace checkpoint: val view 0 at 400x400, PSNR."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(LAPLACE_INI)
    trainer = Trainer(opt, network_config(opt))
    trainer.load_checkpoint(LAPLACE_CKPT)
    val = SynthSpheres("val", scale=opt.scale)
    torch.cuda.synchronize()
    t = time.perf_counter()
    img = trainer.render_image(val.poses[0], val.intrinsics, val.H, val.W, use_ema=False)["image"]
    render_s = time.perf_counter() - t
    if img.shape != (val.H, val.W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"render_laplace: shape {img.shape}, finite {np.isfinite(img).all()}")
    p = _val_view_psnr(val, img)
    if not p > LAPLACE_PSNR_MIN_DB:
        raise AssertionError(f"render_laplace: PSNR {p} dB <= {LAPLACE_PSNR_MIN_DB}")
    phase("render_laplace", checkpoint=os.path.relpath(LAPLACE_CKPT, ROOT), epoch=trainer.epoch,
          size=f"{val.H}x{val.W}", psnr_db=p, min_psnr_db=LAPLACE_PSNR_MIN_DB,
          eval_K=trainer.eval_samples_budget(), seconds=render_s)


def cue():
    """The geometric cue of r4_laplace_cue.ini at full width, then 10 train
    steps under its beta cap."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(LAPLACE_INI)
    cfg = network_config(opt)
    assert_widths("r4_laplace_cue.ini", dict(
        levels=cfg.cp_spec.num_levels, rank=cfg.cp_spec.rank, hidden=cfg.hidden_dim,
        geometric_cue=opt.geometric_cue), dict(levels=16, rank=32, hidden=64, geometric_cue=True))
    trainer = Trainer(opt, cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = trainer.train_geometric_cue(CUE_STEPS, CUE_POINTS)
    secs = time.perf_counter() - t
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"cue: losses {losses[0]} -> {losses[-1]}")
    data = SynthSpheres("train", scale=opt.scale)
    trainer.update_extra_state()
    steps, step_ms, sync_free, ms = timed_steps(trainer, data, SHORT_STEPS, "cue training")
    # the epoch's cap (beta itself is projected under it once, at the epoch's start)
    cap, beta = trainer._sched.weights["_beta_cap"], float(trainer.net.sdf_density.beta)
    phase("cue", config="r4_laplace_cue.ini", steps=CUE_STEPS, points=CUE_POINTS,
          loss_first=losses[0], loss_last=losses[-1], seconds=secs,
          ms_per_step=secs / CUE_STEPS * 1e3, train_steps=SHORT_STEPS,
          train_loss_1=steps[0], train_loss_last=steps[-1], beta=beta, beta_cap=cap,
          train_ms_per_step_after_3=float(np.mean(step_ms[3:])), sync_free_steps=sync_free,
          notfinite=int(trainer.notfinite))


def train_aux():
    """r4_laplace_ref.ini past the start of every scheduled term, with the
    stratified jitter: 10 steps, every loss term at the last."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(AUX_INI, stratified_sampling=True)
    trainer = Trainer(opt, network_config(opt))
    trainer.epoch = AUX_EPOCH - 1                    # the first step starts AUX_EPOCH
    data = SynthSpheres("train", scale=opt.scale)
    torch.cuda.synchronize()
    trainer.update_extra_state()
    losses, step_ms, sync_free, ms = timed_steps(trainer, data, SHORT_STEPS, "train_aux")
    first, last = ({k: float(v) for k, v in m.items()
                    if k not in ("loss", "mean_count", "notfinite", "K", "index")}
                   for m in (ms[0], ms[-1]))
    missing = {"backsdf", "cauchy", "eikonal"} - set(last)
    if missing or not all(np.isfinite(v) for v in [*first.values(), *last.values()]):
        raise AssertionError(f"train_aux: terms {last}; missing {sorted(missing)}")
    phase("train_aux", config="r4_laplace_ref.ini", epoch=trainer.epoch,
          stratified_sampling=True, steps=SHORT_STEPS, loss_1=losses[0], loss_last=losses[-1],
          **{f"last_{k}": v for k, v in last.items()},
          **{f"first_{k}": v for k, v in first.items()}, K=ms[-1]["K"],
          ms_per_step_after_3=float(np.mean(step_ms[3:])), sync_free_steps=sync_free,
          notfinite=int(trainer.notfinite))


def train_density(libs):
    """synth_spheres_density.ini on the card's hash path: 10 steps through
    the scatter_add_rows kernel.  Returns that kernel's launches."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import HASH_KERNEL_PATH, card_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.train.trainer import Trainer

    opt = card_options(DENSITY_INI)
    cfg = network_config(opt)
    if cfg.use_sdf or opt.hash_scatter_impl != HASH_KERNEL_PATH["hash_scatter_impl"] \
            or not cfg.hash_custom_grad:
        raise AssertionError("synth_spheres_density.ini is not a density field on the kernel path")
    data = SynthSpheres("train", scale=opt.scale)
    trainer = Trainer(opt, cfg)
    for lib in libs.values():                        # the density path starts here
        lib.launches = 0
    torch.cuda.synchronize()
    trainer.update_extra_state()
    losses, step_ms, sync_free, ms = timed_steps(trainer, data, SHORT_STEPS, "train_density")
    m = ms[-1]
    launches = libs["scatter_add_rows"].launches     # and ends here
    if not launches:
        raise AssertionError("train_density: scatter_add_rows was not launched")
    phase("train_density", config="synth_spheres_density.ini", steps=SHORT_STEPS,
          loss_1=losses[0], loss_last=losses[-1], ms_per_step_after_3=float(np.mean(step_ms[3:])),
          rays_per_s=opt.num_rays / float(np.mean(step_ms[3:])) * 1e3,
          mean_samples_per_ray=float(m["mean_count"]), sync_free_steps=sync_free,
          notfinite=int(trainer.notfinite), scatter_launches=launches,
          grid_occupied=float(trainer.grid.bitfield.float().mean()))
    return launches


def load_shiny3():
    """The synth_shiny3 train and val splits through the port's PNG decoder."""
    from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
    t = time.perf_counter()
    train = NeRFDataset(SHINY3_DATA, "train", scale=0.8)
    val = NeRFDataset(SHINY3_DATA, "val", scale=0.8)
    return train, val, time.perf_counter() - t


def _shiny3_trainer(device=None, cp_dtype=None):
    """shiny3_indir.ini resumed from the trained checkpoint (its optimizer
    state included)."""
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(SHINY3_INI, color_mlp_path=RENV_CKPT)
    cfg = network_config(opt)
    net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(0))
    if cp_dtype is not None:
        net.cp_spec = dataclasses.replace(net.cp_spec, compute_dtype=cp_dtype)
    trainer = Trainer(opt, cfg, device=device, net=net)
    trainer.load_checkpoint(SHINY3_CKPT)
    return trainer


def _indir_parity_step(device: str, cp_dtype: str, view, pick):
    """One indirect step of the trained shiny3 scene on the rays ``pick`` of
    the split ``view``'s view 0: loss, image and gradients as f64 CPU
    tensors, the error map's row after the step's EMA, and the shares of
    reflecting rays and of samples with the renv gate open."""
    import numpy as np
    import torch
    from envidr_tpu_torch.geometry.rays import full_image_rays, srgb_to_linear
    from envidr_tpu_torch.train.schedules import resolve
    from envidr_tpu_torch.train.trainer import update_error_row

    tr = _shiny3_trainer(device, cp_dtype)
    pose = torch.from_numpy(view.poses[:1])
    rays_o, rays_d = full_image_rays(pose, view.intrinsics, view.H, view.W)
    pix = torch.from_numpy(view.images[0].reshape(-1, 4)[pick].astype(np.float32) / 255.0)
    rgb = srgb_to_linear(pix[:, :3])
    gt = rgb * pix[:, 3:] + (1.0 - pix[:, 3:])
    args = [t.to(device) for t in (rays_o[0][pick], rays_d[0][pick], gt, torch.ones_like(gt),
                                   pix[:, 3])]
    sched = resolve(tr.opt, SHINY3_EPOCH, tr.global_step)
    loss, out, _ = tr.forward_loss(*args, K=32, sched=sched)
    loss.backward()
    ic = torch.from_numpy(np.random.default_rng(4).integers(0, 300, len(pick))).to(device)
    err = (out["image"].detach() - args[2]).abs().mean(dim=-1)
    row = update_error_row(tr.error_map[0], ic, err)
    shares = (float(out["ref_mask"].float().mean()), float(out["renv_mask"].float().mean()))
    return ({"loss": loss.detach().double().cpu().reshape(1),
             "image": out["image"].detach().double().cpu(),
             "error_map_row": row.double().cpu(),
             **{n: p.grad.detach().double().cpu() for n, p in tr.net.named_parameters()
                if p.grad is not None}}, shares)


def check_indir_parity(val, renv_mask_image):
    """The indirect step on the card against the CPU, per tensor (max |a - b|
    / max |b|): the CP encoder in f32 under PARITY_RTOL, in bf16 under
    CP_BF16_RTOL.  The rays: up to 64 pixels of val view 0 whose render
    (render_shiny3's) opened the renv gate, 160 other foreground pixels and
    32 background ones, so that renv_net takes a gradient."""
    import numpy as np

    alpha = val.images[0][..., 3].reshape(-1)
    gate = np.flatnonzero(renv_mask_image.reshape(-1) > 0.5)
    rng = np.random.default_rng(3)
    gate = rng.choice(gate, min(64, gate.size), replace=False)
    fg = np.setdiff1d(np.flatnonzero(alpha > 0), gate)
    pick = np.concatenate([gate, rng.choice(fg, 160, replace=False),
                           rng.choice(np.flatnonzero(alpha == 0), 32, replace=False)])
    result = {"gate_pixels": int(gate.size)}
    for cp_dtype, tol in (("float32", PARITY_RTOL), ("bfloat16", CP_BF16_RTOL)):
        cpu, shares = _indir_parity_step("cpu", cp_dtype, val, pick)
        card, card_shares = _indir_parity_step("cuda", cp_dtype, val, pick)
        rel = {n: float((card[n] - cpu[n]).abs().max()) / max(float(cpu[n].abs().max()), 1e-30)
               for n in cpu}
        phase("indir_parity", f"card_vs_cpu_{cp_dtype}", json.dumps(rel))
        worst = max(rel, key=rel.get)
        if not rel[worst] <= tol or set(card) != set(cpu):
            raise AssertionError(f"indirect step ({cp_dtype} encoder): card and CPU disagree "
                                 f"on {worst}: {rel[worst]} > {tol}")
        if not float(cpu["renv_net.0.weight"].abs().max()) > 0.0:
            raise AssertionError("indir_parity: renv_net took no gradient")
        result.update({f"{cp_dtype}_max_rel_err": rel[worst], f"{cp_dtype}_worst": worst,
                       f"{cp_dtype}_tolerance": tol, "reflecting_rays": shares[0],
                       "renv_open_samples_cpu": shares[1],
                       "renv_open_samples_card": card_shares[1]})
    return result


def render_shiny3(val, decode_s):
    """The trained shiny3 scene: val view 0 at 400x400 through the three
    passes.  The same model rendered in one pass (the renv branch shut, as a
    config without the indirect pass renders it) gives the readings that
    depend on pass 2 and the blend: on the pixels where the gate opens,
    their PSNR and the change the indirect branch makes."""
    import copy

    import numpy as np
    import torch
    from envidr_tpu_torch.train.metrics import psnr
    from envidr_tpu_torch.train.trainer import eval_pair

    trainer = _shiny3_trainer()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = trainer.render_view(val, 0)
    render_s = time.perf_counter() - t
    img = res["image"]
    if img.shape != (val.H, val.W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"render_shiny3: shape {img.shape}, finite {np.isfinite(img).all()}")
    pred, gt = eval_pair(res, val, 0, trainer.opt)
    p = psnr(pred, gt)
    if not p > SHINY3_PSNR_MIN_DB:
        raise AssertionError(f"render_shiny3: PSNR {p} dB <= {SHINY3_PSNR_MIN_DB}")
    single = copy.copy(trainer)
    single.opt = dataclasses.replace(trainer.opt, indir_ref_start_iter=-1)
    pred_1, _ = eval_pair(single.render_view(val, 0), val, 0, single.opt)
    mask = res["renv_mask_image"]
    gate = mask > 0.5
    change = np.abs(pred - pred_1).max(axis=-1)
    effect = float(change[gate].max()) if gate.any() else 0.0
    if not effect > 0.0:
        raise AssertionError("render_shiny3: the indirect branch changed no gate pixel")
    phase("render_shiny3", checkpoint=os.path.relpath(SHINY3_CKPT, ROOT), epoch=trainer.epoch,
          size=f"{val.H}x{val.W}", psnr_db=p, min_psnr_db=SHINY3_PSNR_MIN_DB,
          renv_open_pixels=float(gate.mean()), renv_mask_mean=float(mask.mean()),
          gate_psnr_db=psnr(pred[gate], gt[gate]),
          gate_psnr_one_pass_db=psnr(pred_1[gate], gt[gate]), gate_max_change=effect,
          shut_max_change=float(change[mask == 0].max()),
          eval_K=trainer.eval_samples_budget(), seconds=render_s, decode_s=decode_s)
    return res["renv_mask_image"]


def train_shiny3(train, libs):
    """shiny3_indir.ini at full width from the trained checkpoint at epoch 76:
    20 steps, then a checkpoint round trip."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer, frozen_modules

    opt = load_options(SHINY3_INI, color_mlp_path=RENV_CKPT)
    cfg = network_config(opt)
    spec = cfg.cp_spec
    frozen = frozen_modules(opt)
    assert_widths("shiny3_indir.ini", dict(
        levels=spec.num_levels, rank=spec.rank, compute_dtype=spec.compute_dtype,
        hidden=cfg.hidden_dim, hidden_color=cfg.hidden_dim_color, hidden_env=cfg.hidden_dim_env,
        rays=opt.num_rays, neus=cfg.use_neus_sdf, renv=cfg.use_renv,
        learn_blend=cfg.learn_indir_blend, error_map=opt.error_map, frozen=sorted(frozen)), dict(
        levels=16, rank=32, compute_dtype="bfloat16", hidden=64, hidden_color=64, hidden_env=160,
        rays=4096, neus=True, renv=True, learn_blend=True, error_map=True,
        frozen=["color_net", "diffuse_net"]))
    trainer = _shiny3_trainer()
    if [tuple(l.weight.shape) for l in trainer.net.renv_net] != [(64, 4), (64, 64), (64, 64),
                                                                 (12, 64)]:
        raise AssertionError("train_shiny3: renv_net is not 4 -> 64x3 -> 12")
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    unseen = float((trainer.grid.density < 0).float().mean())
    trainer.epoch = SHINY3_EPOCH - 1
    keep = {name: [p.detach().clone() for p in getattr(trainer.net, name).parameters()]
            for name in sorted(frozen) + ["renv_net"]}
    frozen_ema = {name: [p.detach().clone() for p in getattr(trainer.ema_net, name).parameters()]
                  for name in frozen}
    error_map = trainer.error_map.clone()
    for lib in libs.values():                        # the shiny3 path starts here
        lib.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, sync_free, ms = timed_steps(trainer, train, TRAIN_STEPS, "train_shiny3")
    launches = _launches(libs)                       # and ends here
    if not (trainer._sched.indir_ref and trainer._sched.grad_rays and trainer._sched.use_error_map):
        raise AssertionError("train_shiny3: the indirect pass, grad rays or the error map is off")
    for name in frozen:
        for which, net, before in (("net", trainer.net, keep[name]),
                                   ("EMA net", trainer.ema_net, frozen_ema[name])):
            if not all(torch.equal(a, b) for a, b in zip(before, getattr(net, name).parameters())):
                raise AssertionError(f"train_shiny3: frozen {name} of the {which} moved")
    if all(torch.equal(a, b) for a, b in zip(keep["renv_net"], trainer.net.renv_net.parameters())):
        raise AssertionError("train_shiny3: renv_net did not move")
    em_changed = int((trainer.error_map != error_map).sum())
    renv_open = [float(m["renv_open"]) for m in ms]
    if not em_changed or not max(renv_open) > 0.0:
        raise AssertionError(f"train_shiny3: error map cells changed {em_changed}, renv gate "
                             f"open on {renv_open}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms_per_step = float(np.mean(step_ms[3:]))
    work = tempfile.mkdtemp(prefix="envidr_ckpt_")
    try:
        trainer.workspace = work
        path = trainer.save_checkpoint()
        again = _shiny3_trainer()
        again.load_checkpoint(path)
        a, b = trainer.optimizer, again.optimizer
        same = (all(torch.equal(x, y) for x, y in zip(
            [*trainer.net.parameters(), *trainer.ema_net.parameters(), *a.m, *a.v,
             trainer.error_map], [*again.net.parameters(), *again.ema_net.parameters(), *b.m,
                                  *b.v, again.error_map]))
                and all(int(getattr(a, k)) == int(getattr(b, k))
                        for k in ("count", "sched_count", "skipped")))
        if not same:
            raise AssertionError("train_shiny3: the checkpoint round trip changed the state")
        counts = (int(b.count), int(b.sched_count))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase("train_shiny3", config="scenes/shiny3_indir.ini",
          checkpoint=os.path.relpath(SHINY3_CKPT, ROOT), epoch=trainer.epoch, steps=TRAIN_STEPS,
          loss_1=losses[0], loss_20=losses[-1], notfinite=int(trainer.notfinite),
          sync_free_steps=sync_free, ms_per_step_after_3=ms_per_step,
          rays_per_s=opt.num_rays / ms_per_step * 1e3, first_step_ms=step_ms[0],
          mean_samples_per_ray=float(ms[-1]["mean_count"]), K=ms[-1]["K"],
          renv_open_max=max(renv_open), renv_open_mean=float(np.mean(renv_open)),
          error_map_cells_changed=em_changed, unseen_cells=unseen, frozen_bit_equal=True,
          renv_moved=True, checkpoint_round_trip=True, adam_counts=repr(counts),
          peak_mem_gib=peak, launches=launches)


def train_stack(libs):
    """shiny2_stack.ini on the card's hash path from epoch 18: 10 steps
    through the scatter_add_rows kernel.  Returns that kernel's launches."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import HASH_KERNEL_PATH, card_options, network_config
    from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
    from envidr_tpu_torch.train.trainer import Trainer

    opt = card_options(STACK_INI, color_mlp_path=RENV_CKPT)
    cfg = network_config(opt)
    if opt.hash_scatter_impl != HASH_KERNEL_PATH["hash_scatter_impl"] or not cfg.hash_custom_grad:
        raise AssertionError("shiny2_stack.ini is not on the kernel path")
    t = time.perf_counter()
    data = NeRFDataset(SHINY2_DATA, "train", scale=opt.scale)
    decode_s = time.perf_counter() - t
    trainer = Trainer(opt, cfg)
    trainer.epoch = STACK_EPOCH - 1
    for lib in libs.values():                        # the stack path starts here
        lib.launches = 0
    torch.cuda.synchronize()
    losses, step_ms, sync_free, ms = timed_steps(trainer, data, SHORT_STEPS, "train_stack")
    launches = libs["scatter_add_rows"].launches     # and ends here
    sched = trainer._sched
    if not launches or not (sched.indir_ref and sched.grad_rays):
        raise AssertionError(f"train_stack: scatter_add_rows launches {launches}, indirect "
                             f"{sched.indir_ref}, grad rays {sched.grad_rays}")
    phase("train_stack", config="scenes/shiny2_stack.ini", epoch=trainer.epoch,
          steps=SHORT_STEPS, loss_1=losses[0], loss_last=losses[-1], rays=sched.num_rays,
          K=ms[-1]["K"], ms_per_step_after_3=float(np.mean(step_ms[3:])),
          sync_free_steps=sync_free, notfinite=int(trainer.notfinite),
          scatter_launches=launches, terms=repr(sorted(k for k in ms[-1] if k not in (
              "loss", "mean_count", "notfinite", "K", "index", "renv_open"))), decode_s=decode_s)
    return launches


def _sphere_parity_step(device: str, cp_dtype: str):
    """One sphere-mode step of neural_renderer_cp.ini cut small (CP encoder
    in ``cp_dtype``, material, 2 env nets, the sdf, back-face and eikonal
    terms) on SPHERE_PARITY_RAYS probe rays, some with shell samples outside
    the bound: loss, image and gradients as f64 CPU tensors.  The SDF is
    first fitted to the sphere on the CPU (``render/sphere_probe.py``: where
    the normals are well-conditioned)."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.render.sphere_probe import PROBE_MATERIAL, fit_sphere_sdf, probe_rays
    from envidr_tpu_torch.train.schedules import resolve
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(SPHERE_INI, **SPHERE_PARITY_CUT)
    cfg = network_config(opt)
    net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(0))
    material = torch.from_numpy(PROBE_MATERIAL)
    fit_sphere_sdf(net, 3)
    net.cp_spec = dataclasses.replace(net.cp_spec, compute_dtype=cp_dtype)
    n = SPHERE_PARITY_RAYS
    o, d = probe_rays(n, 3, inside=False, cp_scales=net.cp_spec.scales)
    rng = np.random.default_rng(3)
    pix = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=n) > 0.4).astype(np.float32)
    bg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
    tr = Trainer(opt, cfg, device=device, net=net)
    args = [torch.from_numpy(a).to(device) for a in (o, d, gt, bg, pix[:, 3].copy())]
    loss, out, terms = tr.forward_loss(*args, K=0, sched=resolve(opt, SPHERE_EPOCH, 0),
                                       material=material.to(device),
                                       env_index=torch.tensor(1, device=device))
    loss.backward()
    if set(terms) != {"color", "backsdf", "eikonal", "sdf"}:
        raise AssertionError(f"sphere_parity: the step's terms are {sorted(terms)}")
    return {"loss": loss.detach().double().cpu().reshape(1),
            "image": out["image"].detach().double().cpu(),
            **{n: p.grad.detach().double().cpu() for n, p in tr.net.named_parameters()}}


def check_sphere_parity():
    """The sphere step on the card against the CPU, per tensor (max |a - b| /
    max |b|): the CP encoder in f32 under PARITY_RTOL, in bf16 under
    CP_BF16_RTOL."""
    result = {}
    for cp_dtype, tol in (("float32", PARITY_RTOL), ("bfloat16", CP_BF16_RTOL)):
        cpu = _sphere_parity_step("cpu", cp_dtype)
        card = _sphere_parity_step("cuda", cp_dtype)
        rel = {n: float((card[n] - cpu[n]).abs().max()) / max(float(cpu[n].abs().max()), 1e-30)
               for n in cpu}
        phase("sphere_parity", f"card_vs_cpu_{cp_dtype}", json.dumps(rel))
        worst = max(rel, key=rel.get)
        if not rel[worst] <= tol:
            raise AssertionError(f"sphere step ({cp_dtype} encoder): card and CPU disagree on "
                                 f"{worst}: {rel[worst]} > {tol}")
        result.update({f"{cp_dtype}_max_rel_err": rel[worst], f"{cp_dtype}_worst": worst,
                       f"{cp_dtype}_tolerance": tol})
    return result


def _sphere_widths(opt, cfg) -> dict:
    spec = cfg.cp_spec if cfg.encoding_pos == "cp" else cfg.hash_spec
    return dict(encoding=cfg.encoding_pos, levels=spec.num_levels,
                rank=cfg.cp_rank if cfg.encoding_pos == "cp" else None,
                log2_table=None if cfg.encoding_pos == "cp" else cfg.log2_hashmap_size,
                sdf=[cfg.sdf_in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [cfg.sdf_out_dim],
                color=[cfg.color_in_dim] + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1)
                + [3], diffuse_layers=cfg.num_layers_diffuse, env_nets=cfg.num_env_nets,
                env=[cfg.refdir_enc_dim] + [cfg.hidden_dim_env] * (cfg.num_layers_env - 1)
                + [cfg.env_feat_dim], rays=opt.num_rays, samples=12)


SPHERE_WIDTHS = dict(encoding="cp", levels=16, rank=32, log2_table=None, sdf=[37, 64, 64, 14],
                     color=[28, 64, 64, 3], diffuse_layers=2, env_nets=11,
                     env=[38, 160, 160, 160, 12], rays=16384, samples=12)


def generate_sphere_sets():
    """The env-sphere train split (SPHERE_TRAIN_VIEWS views) and
    SPHERE_RENDER_VIEWS val views at 400x400, generated on the card, and the
    seconds."""
    import torch
    from envidr_tpu_torch.data.env_dataset import PrefilteredBank, generate_env_sphere
    from envidr_tpu_torch.render.pbr import make_env_bank

    torch.cuda.synchronize()
    t = time.perf_counter()
    bank = PrefilteredBank(make_env_bank(11), "cuda")
    train = generate_env_sphere("train", SPHERE_TRAIN_VIEWS, prefiltered=bank)
    val = generate_env_sphere("val", SPHERE_RENDER_VIEWS, prefiltered=bank)
    return train, val, time.perf_counter() - t


def train_sphere(train, gen_s, libs):
    """neural_renderer_cp.ini at its published width on the generated set: 2
    steps of the diffuse term alone (epoch 1), then 20 from epoch 5, all under
    sync debug mode "error"; every env net a step chose must move."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import card_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer

    opt = card_options(SPHERE_INI)
    cfg = network_config(opt)
    assert_widths("neural_renderer_cp.ini", _sphere_widths(opt, cfg), SPHERE_WIDTHS)
    trainer = Trainer(opt, cfg)
    for lib in libs.values():                        # the sphere path starts here
        lib.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    color = [p.detach().clone() for p in trainer.net.color_net.parameters()]
    _, diffuse_ms, diffuse_free, _ = timed_steps(trainer, train, 2, "train_sphere diffuse")
    if not trainer._sched.diffuse_only or not all(
            torch.equal(a, b) for a, b in zip(color, trainer.net.color_net.parameters())):
        raise AssertionError("train_sphere: the diffuse-only steps moved the colour net")
    trainer.epoch, trainer._order = SPHERE_EPOCH - 1, []
    env = [layer.weight.detach().clone() for layer in trainer.net.env_nets]
    losses, step_ms, sync_free, ms = timed_steps(trainer, train, TRAIN_STEPS, "train_sphere")
    launches = _launches(libs)                       # and ends here
    chosen = sorted({int(train.env_index[m["index"]]) for m in ms})
    moved = [e for e in range(cfg.num_env_nets)
             if any(not torch.equal(a[e], b.weight[e]) for a, b in zip(env, trainer.net.env_nets))]
    if trainer._sched.diffuse_only or not set(chosen) <= set(moved) or sync_free != TRAIN_STEPS:
        raise AssertionError(f"train_sphere: env nets chosen {chosen}, moved {moved}, "
                             f"sync-free steps {sync_free}")
    ms_per_step = float(np.mean(step_ms[3:]))
    phase("train_sphere", config="neural_renderer_cp.ini", widths=repr(_sphere_widths(opt, cfg)),
          train_views=len(train), size=f"{train.H}x{train.W}", generate_s=gen_s,
          diffuse_only_steps=2, diffuse_only_ms=repr([round(v, 1) for v in diffuse_ms]),
          steps=TRAIN_STEPS, epoch=trainer.epoch, loss_1=losses[0], loss_20=losses[-1],
          terms=repr(sorted(k for k in ms[-1] if k not in ("loss", "notfinite", "K", "index"))),
          notfinite=int(trainer.notfinite), sync_free_steps=sync_free + diffuse_free,
          ms_per_step_after_3=ms_per_step, rays_per_s=opt.num_rays / ms_per_step * 1e3,
          samples_per_step=opt.num_rays * 12, first_step_ms=step_ms[0],
          env_nets_chosen=repr(chosen), env_nets_moved=repr(moved),
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)


def train_sphere_hash(train, libs):
    """neural_renderer_synth.ini as shipped (hashgrid_diff, a 2^19 table) at
    full width: 5 steps from epoch 5."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import card_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer

    opt = card_options(SPHERE_HASH_INI)
    cfg = network_config(opt)
    assert_widths("neural_renderer_synth.ini", _sphere_widths(opt, cfg), dict(
        SPHERE_WIDTHS, encoding="hashgrid_diff", rank=None, log2_table=19))
    trainer = Trainer(opt, cfg)
    trainer.epoch = SPHERE_EPOCH - 1
    for lib in libs.values():                        # the hash sphere path starts here
        lib.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, sync_free, _ = timed_steps(trainer, train, SPHERE_HASH_STEPS,
                                                "train_sphere_hash")
    launches = _launches(libs)                       # and ends here
    phase("train_sphere_hash", config="neural_renderer_synth.ini",
          widths=repr(_sphere_widths(opt, cfg)), indexing=cfg.hash_spec.indexing,
          steps=SPHERE_HASH_STEPS, loss_1=losses[0], loss_last=losses[-1],
          notfinite=int(trainer.notfinite), sync_free_steps=sync_free,
          ms_per_step_after_1=float(np.mean(step_ms[1:])), first_step_ms=step_ms[0],
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)


def _sphere_view_psnrs(trainer, val, with_r_image=False):
    """(PSNR of each view as the trainer's evaluate reads it, the renders,
    the seconds of each render)."""
    import numpy as np
    import torch
    from envidr_tpu_torch.train.metrics import psnr
    from envidr_tpu_torch.train.trainer import eval_pair

    psnrs, images, secs = [], [], []
    for i in range(SPHERE_RENDER_VIEWS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = trainer.render_view(val, i, with_r_image=with_r_image)
        secs.append(time.perf_counter() - t)
        img = res["image"]
        if img.shape != (val.H, val.W, 3) or not np.isfinite(img).all():
            raise AssertionError(f"view {i}: shape {img.shape}, finite {np.isfinite(img).all()}")
        psnrs.append(psnr(*eval_pair(res, val, i, trainer.opt)))
        images.append(eval_pair(res, val, i, trainer.opt)[0])
    return psnrs, images, secs


def render_pretrain(val, libs):
    """assets/env_sphere_pretrain_best.ckpt (EMA) on SPHERE_RENDER_VIEWS
    generated val views at 400x400 with their materials and env indices."""
    import numpy as np
    from envidr_tpu_torch.config import card_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer

    opt = card_options(SPHERE_INI)
    trainer = Trainer(opt, network_config(opt))
    trainer.load_checkpoint(PRETRAIN_CKPT)
    for lib in libs.values():
        lib.launches = 0
    psnrs, _, secs = _sphere_view_psnrs(trainer, val)
    launches = _launches(libs)
    if not psnrs[0] > PRETRAIN_PSNR_MIN_DB:
        raise AssertionError(f"render_pretrain: view 0 reads {psnrs[0]} dB <= "
                             f"{PRETRAIN_PSNR_MIN_DB}")
    phase("render_pretrain", checkpoint=os.path.relpath(PRETRAIN_CKPT, ROOT),
          epoch=trainer.epoch, size=f"{val.H}x{val.W}", psnr_db_view0=psnrs[0],
          min_psnr_db=PRETRAIN_PSNR_MIN_DB, psnr_db=repr(psnrs),
          mean_psnr_db=float(np.mean(psnrs)), env_index=repr(val.env_index.tolist()),
          seconds=repr([round(v, 3) for v in secs]), launches=launches)


def train_renv(libs):
    """neural_renderer_renv.ini with RENV_OVERRIDES on the decoded
    data/env_sphere_renv (mirror images included): 10 steps; every frozen
    module bit-equal in the net and the EMA net, renv_net moved."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import card_options, network_config
    from envidr_tpu_torch.data.env_dataset import EnvSphereDataset
    from envidr_tpu_torch.train.trainer import Trainer

    t = time.perf_counter()
    data = EnvSphereDataset(RENV_DATA, "train", scale=0.8, with_renv=True)
    decode_s = time.perf_counter() - t
    opt = card_options(RENV_INI, **RENV_OVERRIDES)
    cfg = network_config(opt)
    assert_widths("neural_renderer_renv.ini", _sphere_widths(opt, cfg), SPHERE_WIDTHS)
    trainer = Trainer(opt, cfg)
    frozen = sorted(trainer.optimizer.frozen_names)
    if frozen != sorted(n for n, _ in trainer.net.named_children() if n != "renv_net"):
        raise AssertionError(f"train_renv: frozen {frozen}")
    keep = {(which, name): [p.detach().clone() for p in getattr(net, name).parameters()]
            for which, net in (("net", trainer.net), ("EMA net", trainer.ema_net))
            for name in frozen + ["renv_net"]}
    for lib in libs.values():                        # the renv path starts here
        lib.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, sync_free, _ = timed_steps(trainer, data, SHORT_STEPS, "train_renv")
    launches = _launches(libs)                       # and ends here
    for (which, name), before in keep.items():
        net = trainer.net if which == "net" else trainer.ema_net
        same = all(torch.equal(a, b) for a, b in zip(before, getattr(net, name).parameters()))
        if same != (name != "renv_net"):
            raise AssertionError(f"train_renv: {name} of the {which} "
                                 f"{'did not move' if same else 'moved'}")
    phase("train_renv", config="neural_renderer_renv.ini", overrides=repr(RENV_OVERRIDES),
          train_views=len(data), size=f"{data.H}x{data.W}", decode_s=decode_s,
          steps=SHORT_STEPS, loss_1=losses[0], loss_last=losses[-1],
          notfinite=int(trainer.notfinite), sync_free_steps=sync_free,
          ms_per_step_after_3=float(np.mean(step_ms[3:])), first_step_ms=step_ms[0],
          frozen=repr(frozen), frozen_bit_equal=True, renv_moved=True,
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)


def render_renv(libs):
    """assets/renv_pretrain_best.ckpt on the renv set's val views at 400x400,
    with their mirror images (the train step's render_sphere input) and
    without them (the eval path): both PSNRs and the largest change, which
    must not be 0."""
    import numpy as np
    from envidr_tpu_torch.config import card_options, network_config
    from envidr_tpu_torch.data.env_dataset import EnvSphereDataset
    from envidr_tpu_torch.train.trainer import Trainer

    opt = card_options(RENV_INI, **{**RENV_OVERRIDES, "color_mlp_path": ""})
    trainer = Trainer(opt, network_config(opt))
    trainer.load_checkpoint(RENV_CKPT)
    val = EnvSphereDataset(RENV_DATA, "val", scale=0.8, with_renv=True)
    for lib in libs.values():
        lib.launches = 0
    with_r, img_r, secs = _sphere_view_psnrs(trainer, val, with_r_image=True)
    without, img_0, _ = _sphere_view_psnrs(trainer, val)
    launches = _launches(libs)
    change = max(float(np.abs(a - b).max()) for a, b in zip(img_r, img_0))
    if not change > 0.0:
        raise AssertionError("render_renv: the mirror images changed no pixel")
    phase("render_renv", checkpoint=os.path.relpath(RENV_CKPT, ROOT), epoch=trainer.epoch,
          size=f"{val.H}x{val.W}", views=SPHERE_RENDER_VIEWS,
          psnr_db_with_r_images=repr(with_r), psnr_db_without=repr(without),
          mean_psnr_db_with_r_images=float(np.mean(with_r)),
          mean_psnr_db_without=float(np.mean(without)), max_change=change,
          seconds=repr([round(v, 3) for v in secs]), launches=launches)


class SyncWatch:
    """Counts the host syncs of one CLI epoch (the second) under sync debug
    mode "warn": those of the steps :meth:`Trainer.step_may_sync` names, and
    the rest (the epoch's one read of its averaged metrics)."""

    def __init__(self, trainer_cls, at_epoch: int = 1):
        self.cls, self.at_epoch = trainer_cls, at_epoch
        self.total = self.in_may_sync = self.may_sync_steps = self.steps = 0
        self.record, self.entries, self.beyond_at = None, [], []

    def __enter__(self):
        import warnings
        import torch
        epoch, step, watch = self.cls.train_one_epoch, self.cls.train_step, self

        def train_one_epoch(tr, dataset):
            watch.entries.append((tr.epoch, tr.global_step))
            if tr.epoch != watch.at_epoch or watch.steps:
                return epoch(tr, dataset)
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                watch.record, watch._tail = rec, 0
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return epoch(tr, dataset)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    watch.total = watch._syncs(0)
                    watch.beyond_at += watch._where(watch._tail, len(rec))
                    watch.record = None

        def train_step(tr, dataset, **kw):
            if watch.record is None:
                return step(tr, dataset, **kw)
            may, n0 = tr.step_may_sync(), len(watch.record)
            watch.beyond_at += watch._where(watch._tail, n0)
            out = step(tr, dataset, **kw)
            watch.steps += 1
            if may:
                watch.may_sync_steps += 1
                watch.in_may_sync += watch._syncs(n0)
            else:
                watch.beyond_at += watch._where(n0, len(watch.record))
            watch._tail = len(watch.record)
            return out

        self._saved = (epoch, step)
        self.cls.train_one_epoch, self.cls.train_step = train_one_epoch, train_step
        return self

    SYNC_WARNING = "called a synchronizing CUDA operation"

    def _syncs(self, start: int) -> int:
        return sum(self.SYNC_WARNING in str(w.message) for w in self.record[start:])

    def _where(self, start: int, stop: int):
        return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                for w in self.record[start:stop] if self.SYNC_WARNING in str(w.message)]

    def __exit__(self, *exc):
        self.cls.train_one_epoch, self.cls.train_step = self._saved


def _epoch_lines(workspace: str):
    """(epoch, seconds, rays/s, loss) of each ``[ep N]`` line of a CLI log."""
    out = []
    for line in open(os.path.join(workspace, "log.txt")).read().splitlines():
        m = re.match(r"\[ep +(\d+)\] loss=([\d.]+) .*rays/s=(\d+) .*t=([\d.]+)s", line)
        if m:
            out.append((int(m.group(1)), float(m.group(4)), int(m.group(3)),
                        float(m.group(2))))
    return out


def cli_phase():
    """The CLI on synth_spheres_cp.ini at full width: train 2 epochs (eval
    at 2), resume for a third, test from best; the losses must fall, the
    second epoch's host syncs counted."""
    import numpy as np
    import tempfile
    from envidr_tpu_torch.apps import cli
    from envidr_tpu_torch.data.png import read_png
    from envidr_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory(prefix="envidr_cli_") as ws:
        common = ["--config", CLI_INI, "--workspace", ws]
        t = time.perf_counter()
        with SyncWatch(Trainer) as watch:
            eval_psnr = cli.main(common + ["--max-epochs", "2", "--eval-interval", "2"])
            resume_psnr = cli.main(common + ["--resume", "--max-epochs", str(CLI_EPOCHS)])
        train_s = time.perf_counter() - t
        test_psnr = cli.main(common + ["--test", "--ckpt", "best"])
        files = sorted(os.listdir(os.path.join(ws, "checkpoints")))
        for name in ("ep0002.ckpt", "ep0003.ckpt", "best.ckpt"):
            if name not in files:
                raise AssertionError(f"cli: no checkpoints/{name} in {files}")
        with open(os.path.join(ws, "args.json")) as f:
            n_args = len(json.load(f))
        final = read_png(os.path.join(ws, "results", "final_rgb.png"))
        if final.shape != (CLI_SIZE, CLI_SIZE, 3):
            raise AssertionError(f"cli: results/final_rgb.png is {final.shape}")
        epochs = _epoch_lines(ws)
    # each run's first train_one_epoch entry: (epoch, global_step) before it
    starts = [watch.entries[0], watch.entries[2]]
    if starts != [(0, 0), (2, 2 * CLI_TRAIN_VIEWS)] or [e[0] for e in epochs] != [1, 2, 3]:
        raise AssertionError(f"cli: epoch entries {watch.entries}, log epochs {epochs}; "
                             "the resumed run must start at epoch 3 from global step 100")
    beyond = watch.total - watch.in_may_sync
    if watch.steps != CLI_TRAIN_VIEWS or beyond > 1:
        raise AssertionError(f"cli: the second epoch ({watch.steps} steps) synchronised "
                             f"{watch.total} times, {watch.in_may_sync} in the "
                             f"{watch.may_sync_steps} steps step_may_sync names: "
                             f"{beyond} beyond them (at most 1), at {watch.beyond_at}")
    # the epochs move the model: each epoch's mean loss (the log's) at most
    # CLI_LOSS_FALL of the one before, the resumed third's too; an optimizer
    # that never steps, an epoch without its steps or a resume from fresh
    # weights (its loss back near epoch 1's) fails
    losses = [e[3] for e in epochs]
    if not all(b <= CLI_LOSS_FALL * a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"cli: epoch losses {losses}: each must be at most "
                             f"{CLI_LOSS_FALL} of the one before")
    if not all(np.isfinite(p) for p in (eval_psnr, resume_psnr, test_psnr)):
        raise AssertionError(f"cli: PSNRs {eval_psnr}, {resume_psnr}, {test_psnr}")
    phase("cli", config="synth_spheres_cp.ini", epochs=CLI_EPOCHS,
          epoch_s=repr([e[1] for e in epochs]), rays_per_s=repr([e[2] for e in epochs]),
          epoch_loss=repr(losses),
          eval_psnr_db_ep2=eval_psnr, eval_psnr_db_ep3=resume_psnr, test_psnr_db=test_psnr,
          resumed_from=repr(starts[1]), checkpoints=repr(files), args_json_keys=n_args,
          syncs_epoch2=watch.total, syncs_in_may_sync_steps=watch.in_may_sync,
          may_sync_steps=watch.may_sync_steps, syncs_beyond=beyond,
          syncs_beyond_at=repr(watch.beyond_at), train_runs_s=train_s)


def cli_hash_phase(libs):
    """One CLI epoch of synth_spheres.ini on the kernel's path; returns the
    scatter_add_rows launches."""
    import numpy as np
    import tempfile
    from envidr_tpu_torch.apps import cli
    from envidr_tpu_torch.config import HASH_KERNEL_PATH

    with tempfile.TemporaryDirectory(prefix="envidr_cli_hash_") as ws:
        sets = [a for k, v in HASH_KERNEL_PATH.items() for a in ("--set", f"{k}={v}")]
        for lib in libs.values():                    # the CLI's hash path starts here
            lib.launches = 0
        t = time.perf_counter()
        psnr = cli.main(["--config", HASH_INI, "--workspace", ws, "--max-epochs", "1", *sets])
        seconds = time.perf_counter() - t
        launches = libs["scatter_add_rows"].launches   # and ends here
        (_, epoch_s, rays, _), = _epoch_lines(ws)
    if not launches > 0 or not np.isfinite(psnr):
        raise AssertionError(f"cli_hash: scatter_add_rows launches {launches}, PSNR {psnr}")
    phase("cli_hash", config="synth_spheres.ini", overrides=repr(HASH_KERNEL_PATH),
          scatter_launches=launches, epoch_s=epoch_s, rays_per_s=rays, eval_psnr_db=psnr,
          seconds=seconds, launches=_launches(libs))
    return launches


def mesh_phase():
    """save_mesh's pieces on the CP checkpoint at MESH_RES: the field on the
    card, the C++ marching tetrahedra, the OBJ; the C++ against numpy on a
    crop."""
    import numpy as np
    import tempfile
    import torch
    from envidr_tpu_torch.apps import mesh_extract
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SPHERES
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(CP_INI)
    trainer = Trainer(opt, network_config(opt))
    trainer.load_checkpoint(CP_CKPT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field = mesh_extract.mesh_field(trainer, MESH_RES)
    t1 = time.perf_counter()
    verts, faces = mesh_extract.mesh_from_field(field, trainer.cfg)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mesh_extract.write_obj(os.path.join(d, "mesh.obj"), verts, faces)
        obj_bytes = os.path.getsize(os.path.join(d, "mesh.obj"))
    sdf = np.min([np.linalg.norm(verts - opt.scale * c[[1, 2, 0]], axis=-1) - opt.scale * r
                  for c, r, _ in SPHERES], axis=0)
    lo = MESH_RES // 2
    crop = -field[lo:lo + MESH_CROP, lo:lo + MESH_CROP, lo:lo + MESH_CROP]
    nv, nf = mesh_extract.marching_tets(crop)
    t3 = time.perf_counter()
    rv, rf = mesh_extract.marching_tets_numpy(crop)
    numpy_s = time.perf_counter() - t3
    same = (nv.shape == rv.shape and nf.shape == rf.shape
            and set(map(tuple, np.round(nv * 1024).astype(np.int64)))
            == set(map(tuple, np.round(rv * 1024).astype(np.int64))))
    if not same or len(nv) == 0:
        raise AssertionError(f"mesh: native {nv.shape}/{nf.shape} and numpy {rv.shape}/"
                             f"{rf.shape} marching tets differ on the {MESH_CROP}^3 crop")
    if not len(verts) or not np.isfinite(verts).all() or np.abs(sdf).mean() > 0.02:
        raise AssertionError(f"mesh: {len(verts)} vertices, mean |sdf| {np.abs(sdf).mean()}")
    phase("mesh", checkpoint=os.path.relpath(CP_CKPT, ROOT), resolution=MESH_RES,
          field_s=t1 - t0, native_tets_s=t2 - t1, verts=len(verts), faces=len(faces),
          obj_bytes=obj_bytes, mean_abs_sdf=float(np.abs(sdf).mean()),
          max_abs_sdf=float(np.abs(sdf).max()), crop=f"{MESH_CROP}^3",
          crop_verts=len(nv), crop_native_equals_numpy=same, crop_numpy_s=numpy_s)


def demo_phase():
    """The demo golden on the card, then the demo CLI at 400x400."""
    import numpy as np
    import tempfile
    import torch
    from envidr_tpu_torch.apps import demo_render

    fix = np.load(DEMO_GOLDEN)
    mask = fix["mask"]
    rays_o = torch.from_numpy(fix["rays_o"][mask]).cuda()
    rays_d = torch.from_numpy(fix["rays_d"][mask]).cuda()
    xyzs = rays_o + rays_d * torch.from_numpy(fix["nears"][mask]).cuda()
    errs = {}
    for case in (0, 1):
        m = fix[f"case{case}_material"]
        nets, xyz = demo_render.load_demo_nets(int(m[5]), device=rays_d.device)
        with torch.no_grad():
            kappa, diffuse, specular = demo_render.shade(
                nets, xyz, torch.as_tensor(m[:5], dtype=torch.float32, device=rays_d.device),
                rays_d, xyzs)
        diffuse, specular = diffuse.cpu().numpy(), specular.cpu().numpy()
        k_ref = float(fix[f"case{case}_kappa_inv"])
        e = dict(kappa=abs(float(kappa) - k_ref),
                 diffuse=float(np.abs(diffuse - fix[f"case{case}_diffuse"]).max()),
                 specular=float(np.abs(specular - fix[f"case{case}_specular"]).max()),
                 specular_mean=float(np.abs(specular - fix[f"case{case}_specular"]).mean()))
        errs[case] = e
        if not (e["kappa"] <= DEMO_TOL["kappa_atol"] + DEMO_TOL["kappa_rtol"] * abs(k_ref)
                and e["diffuse"] <= DEMO_TOL["diffuse"] and e["specular"] <= DEMO_TOL["specular"]
                and e["specular_mean"] < DEMO_TOL["specular_mean"]):
            raise AssertionError(f"demo: case {case} off the golden: {e} (bounds {DEMO_TOL})")
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        img = demo_render.main(["--size", "400", "--out", os.path.join(d, "demo.png")])
        seconds = time.perf_counter() - t
    img8 = np.round(img * 255).astype(np.uint8)
    fg = float((img8.min(-1) < 255).mean())
    if img.shape != (400, 400, 3) or not 0.3 < fg < 0.7:
        raise AssertionError(f"demo: image {img.shape}, foreground share {fg}")
    phase("demo", golden_errors=repr(errs), size="400x400", mean=float(img.mean()), fg_frac=fg,
          seconds=seconds)


def _golden_unwrap_net(fix):
    """tests/test_torch_goldens.py's net: the fixture's SDF net, the
    reference's diffuse and colour nets and env nets 2 and 7 (tracked)."""
    import torch
    from envidr_tpu_torch.io.jax_params import mlp_from_tree
    from envidr_tpu_torch.io.torch_import import load_npz_env_nets, load_npz_mlps
    from envidr_tpu_torch.models.network import NeRFNetwork, NetworkConfig

    cfg = NetworkConfig(
        encoding_pos="frequency", multires=6, env_sph_mode=True, num_env_nets=2,
        in_roughness=1, in_metallic=1, in_base_color=3, num_layers=3, geo_feat_dim=12,
        env_feat_dim=12, hidden_dim_env=160, roughness_act_scale=1.0,
        geo_feat_act="unitNorm", env_feat_act="unitNorm", init_beta=0.1, sh_degree=4)
    net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(0))
    trees = load_npz_mlps(os.path.join(ROOT, "assets", "rendering_mlps.npz"),
                          ("diffuse_net", "color_net"))
    trees["sdf_net"] = [{"w": fix[f"sdf_net.{i}.w"].T, "b": fix[f"sdf_net.{i}.b"]}
                        for i in range(3)]
    trees["env_nets"] = load_npz_env_nets(os.path.join(ROOT, "assets", "env_nets.npz"), (2, 7))
    for name, tree in trees.items():
        setattr(net, name, mlp_from_tree(tree))
    return net.cuda()


def unwrap_phase():
    """unwrap_env.npz on the card, then the CLI's 512x1024 unwrap of env 3."""
    import numpy as np
    import tempfile
    from envidr_tpu_torch.apps import unwrap

    fix = np.load(UNWRAP_GOLDEN)
    net = _golden_unwrap_net(fix)
    m = fix["material"]
    material = {"roughness": float(m[0]), "metallic": float(m[1]), "color": np.asarray(m[2:5])}
    errs = []
    for ei, env in enumerate((2, 7)):
        img = unwrap.unwrap_env(net, env_h=int(fix["env_h"]), env_w=int(fix["env_w"]),
                                radius=0.95, material=material, env_index=ei)
        errs.append(float(np.abs(img - fix[f"env{env}_image"]).max()))
    if not max(errs) <= UNWRAP_ATOL:
        raise AssertionError(f"unwrap: golden errors {errs} > {UNWRAP_ATOL}")
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        img = unwrap.main(["--config", SPHERE_INI, "--ckpt", PRETRAIN_CKPT, "--env-index", "3",
                           "--size", "512", "1024", "--out", os.path.join(d, "env3.png")])
        seconds = time.perf_counter() - t
    if img.shape != (512, 1024, 3) or not np.isfinite(img).all() or img.std() < 1e-3:
        raise AssertionError(f"unwrap: env 3 image {img.shape}, std {img.std()}")
    phase("unwrap", golden_max_abs_err=repr(errs), atol=UNWRAP_ATOL,
          checkpoint=os.path.relpath(PRETRAIN_CKPT, ROOT), env=3, size="512x1024",
          mean=float(img.mean()), seconds_incl_load=seconds)


def turntable_phase():
    import numpy as np
    import tempfile
    from envidr_tpu_torch.apps import turntable

    with tempfile.TemporaryDirectory() as d:
        frames, secs = turntable.main(["--config", CP_INI, "--ckpt", CP_CKPT, "--n-frames",
                                       str(TURNTABLE_FRAMES), "--size", str(TURNTABLE_SIZE),
                                       "--env-rot",
                                       "--out", d])
        written = len(os.listdir(d))
    change = float(np.abs(frames[0].astype(np.int16) - frames[4].astype(np.int16)).max())
    if written != TURNTABLE_FRAMES or not change > 0:
        raise AssertionError(f"turntable: {written} frames written, frame 0 vs 4 max change "
                             f"{change}")
    phase("turntable", frames=TURNTABLE_FRAMES, size=f"{TURNTABLE_SIZE}x{TURNTABLE_SIZE}",
          env_rot=True,
          ms_per_frame=1e3 * float(np.mean(secs[1:])), first_frame_ms=1e3 * secs[0],
          frame0_vs_4_max_change=change)


def viewer_phase():
    import numpy as np
    import threading
    import urllib.request
    from http.server import HTTPServer
    from envidr_tpu_torch.apps.viewer import ViewerState, make_handler
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.png import decode
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(CP_INI)
    trainer = Trainer(opt, network_config(opt))
    trainer.load_checkpoint(CP_CKPT)
    srv = HTTPServer(("127.0.0.1", 0), make_handler(ViewerState(trainer, opt, "scene")))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        t = time.perf_counter()
        png = urllib.request.urlopen(base + "/render?size=256", timeout=120).read()
        seconds = time.perf_counter() - t
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    img = decode(png)
    if img.shape != (256, 256, 3) or img.std() == 0:
        raise AssertionError(f"viewer: /render gave {img.shape}, std {img.std()}")
    phase("viewer", port=srv.server_address[1], size="256x256", png_bytes=len(png),
          seconds=seconds, mean=float(img.mean() / 255))


@functools.lru_cache(maxsize=None)
def _volsdf_fitted_state():
    """The small VolSDF model's parameters, its SDF fitted to the sphere on
    the CPU (one fit for the four steps of volsdf_parity)."""
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.render.sphere_probe import fit_sphere_sdf

    opt = load_options(VOLSDF_INI, error_bound_sample=True, num_steps=VOLSDF_PARITY_STEPS,
                       **CP_PARITY_CUT, hidden_dim_color=16, hidden_dim_env=16)
    net = NeRFNetwork(network_config(opt), generator=torch.Generator().manual_seed(0))
    fit_sphere_sdf(net, 3)
    return opt, {k: v.detach().clone() for k, v in net.state_dict().items()}


def _volsdf_parity_step(device: str, cp_dtype: str):
    """One VolSDF step of the small model (encoder in ``cp_dtype``) on
    VOLSDF_PARITY_RAYS rays, the sampler's draws made on the CPU: loss,
    image and gradients as f64 CPU tensors, and the samples a ray."""
    import torch
    from envidr_tpu_torch.config import network_config
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.train.schedules import resolve
    from envidr_tpu_torch.train.trainer import Trainer

    opt, state = _volsdf_fitted_state()
    cfg = network_config(opt)
    net = NeRFNetwork(cfg)
    net.load_state_dict(state)
    net.cp_spec = dataclasses.replace(net.cp_spec, compute_dtype=cp_dtype)
    n = VOLSDF_PARITY_RAYS
    gen = torch.Generator().manual_seed(3)
    rays_o = torch.randn(n, 3, generator=gen) * 0.1 + torch.tensor([0.0, 0.0, 2.5])
    target = torch.rand(n, 3, generator=gen) * 0.6 - 0.3
    rays_d = torch.nn.functional.normalize(target - rays_o, dim=-1)
    gt = torch.rand(n, 3, generator=gen)
    alpha = (torch.rand(n, generator=gen) > 0.5).float()
    tr = Trainer(opt, cfg, device=device, net=net)
    vopts = tr.volsdf_options()
    draws = dict(noise=torch.rand((n, vopts.num_steps), generator=gen),
                 u=torch.rand((n, vopts.upsample_steps), generator=gen),
                 perm=torch.randperm(vopts.num_steps * (1 + vopts.grow_iters), generator=gen))
    args = [t.to(device) for t in (rays_o, rays_d, gt, torch.ones(n, 3), alpha)]
    loss, out, _ = tr.forward_loss(*args, K=0, sched=resolve(opt, 1, 0),
                                   volsdf_draws={k: v.to(device) for k, v in draws.items()})
    loss.backward()
    return {"loss": loss.detach().double().cpu().reshape(1),
            "image": out["image"].detach().double().cpu(),
            **{n: p.grad.detach().double().cpu() for n, p in tr.net.named_parameters()}}, \
        out["sigmas"].shape[1]


def check_volsdf_parity():
    """The VolSDF step on the card against the CPU, per tensor, max |a - b| /
    max |b|: the encoder in f32 under PARITY_RTOL, in bf16 under
    CP_BF16_RTOL."""
    result = {}
    for cp_dtype, tol in (("float32", PARITY_RTOL), ("bfloat16", CP_BF16_RTOL)):
        cpu, samples = _volsdf_parity_step("cpu", cp_dtype)
        card, _ = _volsdf_parity_step("cuda", cp_dtype)
        rel = {n: float((card[n] - cpu[n]).abs().max()) / max(float(cpu[n].abs().max()), 1e-30)
               for n in cpu}
        phase("volsdf_parity", f"card_vs_cpu_{cp_dtype}", json.dumps(rel))
        worst = max(rel, key=rel.get)
        if not rel[worst] <= tol:
            raise AssertionError(f"VolSDF step ({cp_dtype} encoder): card and CPU disagree "
                                 f"on {worst}: {rel[worst]} > {tol}")
        result.update({f"{cp_dtype}_max_rel_err": rel[worst], f"{cp_dtype}_worst": worst,
                       f"{cp_dtype}_tolerance": tol})
    return {**result, "rays": VOLSDF_PARITY_RAYS, "samples_per_ray": samples}


def _timed_sampler():
    """A context in which every call of the VolSDF sampler is bracketed by
    two CUDA events (no sync): yields the list of (start, end) pairs."""
    import contextlib
    import torch
    from envidr_tpu_torch.render import volsdf

    @contextlib.contextmanager
    def ctx():
        sampler, events = volsdf.volsdf_sample, []

        def timed(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            z = sampler(*a, **kw)
            end.record()
            events.append((start, end, z.shape[1]))
            return z

        volsdf.volsdf_sample = timed
        try:
            yield events
        finally:
            volsdf.volsdf_sample = sampler
    return ctx()


def train_volsdf(libs, config: str = VOLSDF_INI, label: str = "train_volsdf", **overrides):
    """``config`` with error_bound_sample at full width: VOLSDF_STEPS steps
    after the grid refresh, the sync-free ones under sync debug mode
    "error".  Counts are zeroed just before and read just after; returns the
    launches of scatter_add_rows."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.ops.marching import MARCH_PATHS
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(config, error_bound_sample=True, **overrides)
    cfg = network_config(opt)
    widths = dict(encoder=cfg.encoding_pos, levels=cfg.num_levels, hidden=cfg.hidden_dim,
                  hidden_color=cfg.hidden_dim_color, hidden_env=cfg.hidden_dim_env,
                  rays=opt.num_rays, num_steps=opt.num_steps, laplace=not cfg.use_neus_sdf)
    want = dict(encoder=widths["encoder"], levels=16, hidden=64, hidden_color=64, hidden_env=64,
                rays=4096, num_steps=512, laplace=True)
    assert_widths(os.path.basename(config), widths, want)
    data = SynthSpheres("train", scale=opt.scale)
    trainer = Trainer(opt, cfg)
    vopts = trainer.volsdf_options()
    for lib in libs.values():                        # this path starts here
        lib.launches = 0
    MARCH_PATHS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.update_extra_state()
    with _timed_sampler() as events:
        losses, step_ms, sync_free, _ = timed_steps(trainer, data, VOLSDF_STEPS, label)
    launches = {k: lib.launches for k, lib in libs.items()}     # and ends here
    torch.cuda.synchronize()
    sampler_ms = [a.elapsed_time(b) for a, b, _ in events]
    samples = {n for _, _, n in events}
    want_samples = vopts.upsample_steps + vopts.n_samples_extra + 2
    if len(events) != VOLSDF_STEPS or samples != {want_samples}:
        raise AssertionError(f"{label}: {len(events)} sampler calls, {samples} samples a ray; "
                             f"want {VOLSDF_STEPS} and {want_samples}")
    if sum(MARCH_PATHS.values()):
        raise AssertionError(f"{label}: a VolSDF step marched the grid: {dict(MARCH_PATHS)}")
    ms_per_step = float(np.mean(step_ms[3:]))
    phase(label, config=os.path.basename(config), overrides=repr(overrides),
          widths=repr(widths), steps=VOLSDF_STEPS, loss_1=losses[0], loss_last=losses[-1],
          notfinite=int(trainer.notfinite), sync_free_steps=sync_free,
          ms_per_step_after_3=ms_per_step, rays_per_s=opt.num_rays / ms_per_step * 1e3,
          first_step_ms=step_ms[0], sampler_ms_after_3=float(np.mean(sampler_ms[3:])),
          sampler_share=float(np.mean(sampler_ms[3:])) / ms_per_step,
          grow_rounds=vopts.grow_iters, last_round_samples=vopts.num_steps * vopts.grow_iters,
          samples_per_ray=want_samples, marches=sum(MARCH_PATHS.values()),
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
          scatter_launches=launches["scatter_add_rows"])
    return launches["scatter_add_rows"]


def train_volsdf_hash(libs):
    """train_volsdf on the hash grid through the kernel's path."""
    from envidr_tpu_torch.config import HASH_KERNEL_PATH
    launches = train_volsdf(libs, HASH_INI, "train_volsdf_hash", **HASH_KERNEL_PATH)
    if launches < VOLSDF_STEPS:
        raise AssertionError(f"train_volsdf_hash: scatter_add_rows launched {launches} times "
                             f"in {VOLSDF_STEPS} steps; expected at least one a step")
    return launches


def split_env(libs):
    """The per-scene recipe with split_diffuse_env: SPLIT_STEPS steps, then
    the split relight, checked in the net and the EMA net, and val view 0
    rendered before and after."""
    import numpy as np
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.io.torch_import import load_env_net
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(OURS_INI, color_mlp_path=PRETRAIN_CKPT, split_diffuse_env=True)
    cfg = network_config(opt)
    data, val = SynthSpheres("train", scale=opt.scale), SynthSpheres("val", scale=opt.scale)
    trainer = Trainer(opt, cfg)
    for lib in libs.values():                        # this path starts here
        lib.launches = 0
    trainer.update_extra_state()
    losses, step_ms, sync_free, _ = timed_steps(trainer, data, SPLIT_STEPS, "split_env")
    images, secs = [], []
    for swap in (False, True):
        if swap:
            old = {w: [p.detach().clone() for p in net.env_net.parameters()]
                   for w, net in (("net", trainer.net), ("ema", trainer.ema_net))}
            trainer.swap_env_net(ENV_NET, split_diffuse=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = trainer.render_image(val.poses[0], val.intrinsics, val.H, val.W)["image"]
        secs.append(time.perf_counter() - t)
        if not np.isfinite(img).all():
            raise AssertionError("split_env: the render is not finite")
        images.append(img)
    new = load_env_net(ENV_NET)
    for w, net in (("net", trainer.net), ("ema", trainer.ema_net)):
        if not all(torch.equal(a, b) for a, b in zip(old[w], net.diffuse_env_net.parameters())):
            raise AssertionError(f"split_env: the {w}'s diffuse env net is not its old env net")
        for layer, p in zip(net.env_net, new):
            if not torch.equal(layer.weight.cpu(), torch.from_numpy(p["w"].T)):
                raise AssertionError(f"split_env: the {w}'s env net is not the file's")
    diff = float(np.abs(images[1] - images[0]).mean())
    if not diff > 0.0:
        raise AssertionError("split_env: the split relight changed no pixel")
    phase("split_env", config="scenes/synth_spheres_ours.ini", split_diffuse_env=True,
          steps=SPLIT_STEPS, loss_1=losses[0], loss_last=losses[-1],
          notfinite=int(trainer.notfinite), sync_free_steps=sync_free,
          ms_per_step_after_1=float(np.mean(step_ms[1:])), diffuse_env_is_old_env=True,
          env_is_file=True, size=f"{val.H}x{val.W}", seconds_before=secs[0],
          seconds_after=secs[1], mean_abs_diff=diff, launches=_launches(libs))


def options_phase(libs):
    """Each of OPTIONS on synth_spheres_cp.ini at full width: OPTION_STEPS
    steps after the grid refresh."""
    import numpy as np
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.ops.marching import MARCH_PATHS
    from envidr_tpu_torch.train.trainer import Trainer

    data = SynthSpheres("train", scale=load_options(CP_INI).scale)
    readings = {}
    for lib in libs.values():                        # the options' paths start here
        lib.launches = 0
    for name, kw in OPTIONS.items():
        opt = load_options(CP_INI, **kw)
        trainer = Trainer(opt, network_config(opt))
        MARCH_PATHS.clear()
        trainer.update_extra_state()
        losses, step_ms, sync_free, ms = timed_steps(trainer, data, OPTION_STEPS, name)
        if name == "dt_gamma" and (MARCH_PATHS["coarse"] or MARCH_PATHS["dense"] != OPTION_STEPS):
            raise AssertionError(f"options dt_gamma marches: {dict(MARCH_PATHS)}; all dense")
        readings[name] = dict(ms_per_step_after_1=float(np.mean(step_ms[1:])),
                              loss_last=losses[-1], sync_free=sync_free,
                              mean_count=float(ms[-1]["mean_count"]))
        phase("options", name, overrides=repr(kw), **readings[name])
    # the background net's 2-D table takes autograd's gradient, as in JAX
    # (its spec's scatter_impl is 'xla'): no kernel on these paths
    _assert_no_launches(libs, "options")
    phase("options", "all finite", options=len(OPTIONS), launches=_launches(libs))


def sphere_mode_render(libs):
    """render_env_on_sphere at neural_renderer_cp.ini's widths (seeded
    weights) through the viewer's frame: SPHERE_MODE_FRAMES frames."""
    import numpy as np
    from envidr_tpu_torch.apps.viewer import ViewerState
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.png import decode
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(SPHERE_INI, env_sph_mode=False, render_env_on_sphere=True)
    cfg = network_config(opt)
    widths = dict(levels=cfg.num_levels, rank=cfg.cp_rank, hidden=cfg.hidden_dim,
                  hidden_color=cfg.hidden_dim_color, hidden_env=cfg.hidden_dim_env,
                  material=cfg.material_dims, env_nets=cfg.num_env_nets)
    assert_widths("neural_renderer_cp.ini", widths, dict(
        levels=16, rank=32, hidden=64, hidden_color=64, hidden_env=160, material=5, env_nets=1))
    trainer = Trainer(opt, cfg)
    if trainer.use_grid or not hasattr(trainer.net, "env_net"):
        raise AssertionError("sphere_mode_render: the trainer marches a grid or has no env net")
    state = ViewerState(trainer, opt, "sphere")
    for lib in libs.values():                        # this path starts here
        lib.launches = 0
    secs, imgs = [], []
    for k in range(SPHERE_MODE_FRAMES):
        t = time.perf_counter()
        png, _ = state.frame(35.0 + 30.0 * k, -25.0, 3.2, SPHERE_MODE_SIZE, "image", 3, 0, 0)
        secs.append(time.perf_counter() - t)
        imgs.append(decode(png))
    if imgs[0].shape != (SPHERE_MODE_SIZE, SPHERE_MODE_SIZE, 3) or imgs[0].std() == 0:
        raise AssertionError(f"sphere_mode_render: frame {imgs[0].shape}, std {imgs[0].std()}")
    _assert_no_launches(libs, "sphere_mode_render")
    phase("sphere_mode_render", config="neural_renderer_cp.ini", render_env_on_sphere=True,
          weights="seeded", widths=repr(widths), frames=SPHERE_MODE_FRAMES,
          size=f"{SPHERE_MODE_SIZE}x{SPHERE_MODE_SIZE}",
          ms_per_frame_after_1=1e3 * float(np.mean(secs[1:])), first_frame_ms=1e3 * secs[0],
          mean=float(imgs[0].mean() / 255), launches=_launches(libs))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.tools import bench_gs4, bench_scatter, bench_scatter2, scatter_edges
    from envidr_tpu_torch.train.metrics import psnr
    from envidr_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", kind=repr(kind), count=torch.cuda.device_count(), nvidia_smi=repr(smi))

    built = build_all()
    phase("build", **{k: "cached" if v is None else f"nvcc_s={v:.1f}"
                      for k, v in built.items()})

    opt = load_options(os.path.join(ROOT, "configs", "synth_spheres.ini"),
                       hash_scatter_impl="mixed", hash_custom_grad="on")
    cfg = network_config(opt)
    K0 = opt.early_stop_steps                        # the first epoch's budget
    rows = [check_scatter(cfg.hash_spec, B=opt.num_rays * K0, W=8 * cfg.level_dim)]
    launch_floor()
    rows += check_bench_kernels()
    rows += check_cp_rows()
    bf16_accumulator_readings()
    edges = scatter_edges.run(log=lambda line: phase("kernels", "edge", line))
    phase("kernels", "edge shapes ok", checks=len(edges))
    libs = dict(kernel_libraries())

    par = check_parity()
    phase("parity", **par)
    phase("hash", **check_hash())

    t = time.perf_counter()
    train = SynthSpheres("train", scale=opt.scale)
    val = SynthSpheres("val", scale=opt.scale)
    data_s = time.perf_counter() - t
    trainer = Trainer(opt, cfg)
    for lib in libs.values():                        # main path starts here
        lib.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.update_extra_state()
    occupied = float(trainer.grid.bitfield.float().mean())
    losses, step_ms, sync_free, ms = timed_steps(trainer, train, TRAIN_STEPS, "train")
    m = ms[-1]
    ms_per_step = float(np.mean(step_ms[3:]))
    launches_train = libs["scatter_add_rows"].launches
    if launches_train < TRAIN_STEPS:
        raise AssertionError(f"scatter_add_rows launched {launches_train} times in "
                             f"{TRAIN_STEPS} steps; expected at least one per step")
    phase("train", steps=TRAIN_STEPS, loss_1=losses[0], loss_20=losses[-1],
          notfinite=int(trainer.notfinite), mean_samples_per_ray=float(m["mean_count"]),
          K=m["K"], sync_free_steps=sync_free,
          ms_per_step_after_3=ms_per_step, rays_per_s=opt.num_rays / ms_per_step * 1e3,
          first_step_ms=step_ms[0], grid_occupied=occupied,
          scatter_launches=launches_train,
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, data_gen_s=data_s)

    torch.cuda.synchronize()
    t = time.perf_counter()
    res = trainer.render_image(val.poses[0], val.intrinsics, val.H, val.W)
    render_s = time.perf_counter() - t
    train_launches = {k: lib.launches for k, lib in libs.items()}   # main path ends here
    img = res["image"]
    gt = val.images[0].astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    p = psnr(np.clip(img, 0.0, 1.0), gt)
    if img.shape != (val.H, val.W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"render: shape {img.shape}, finite {np.isfinite(img).all()}")
    if not np.isfinite(p) or float(img.std()) < 1e-4:
        raise AssertionError(f"render: psnr {p}, image std {img.std()}")
    phase("render", size=f"{val.H}x{val.W}", psnr_db=p, image_std=float(img.std()),
          seconds=render_s, rays_per_s=val.H * val.W / render_s)

    phase("cp_parity", **check_cp_parity())
    phase("ours_parity", **check_cp_parity("scenes/synth_spheres_ours.ini", "ours_parity"))
    cp_launches = train_cp(libs)
    lpips_phase(*render_cp(libs), libs)
    fixtures_phase(train)
    trainer_ours, opt_ours = train_ours(libs)
    relight(trainer_ours, opt_ours)
    del trainer_ours
    render_laplace()
    cue()
    train_aux()
    density_launches = train_density(libs)
    shiny3_train, shiny3_val, decode_s = load_shiny3()
    phase("decode", scene=os.path.relpath(SHINY3_DATA, ROOT), train_views=len(shiny3_train),
          val_views=len(shiny3_val), size=f"{shiny3_train.H}x{shiny3_train.W}", seconds=decode_s)
    renv_mask_image = render_shiny3(shiny3_val, decode_s)
    phase("indir_parity", **check_indir_parity(shiny3_val, renv_mask_image))
    train_shiny3(shiny3_train, libs)
    stack_launches = train_stack(libs)
    import bench_torch
    row = bench_torch.run(scaling=True)
    if not (row["gspmd_overhead_ratio"] > 0 and all(
            v > 0 for v in row["weak_rays_per_sec_per_vdev"].values())):
        raise AssertionError(f"bench_torch: scaling probe gave {row}")
    phase("bench_torch", json.dumps(row))
    parallel_phase()

    for lib in libs.values():                        # the benchmarks' path starts here
        lib.launches = 0
    summaries = {}
    for bench in (bench_scatter, bench_scatter2, bench_gs4):
        name = bench.__name__.rsplit(".", 1)[-1]
        summaries[name] = bench.main(
            ["--iters", str(BENCH_ITERS), "--e2e-iters", str(BENCH_ITERS)]
            if bench is bench_scatter else ["--iters", str(BENCH_ITERS)])
    # and ends here; each table row takes the launches of its own bench rows
    for row in rows:
        bench_rows = row.pop("bench_rows")
        if row["name"] in cp_launches:               # rows 9-10: train_cp's counts
            row["launches"] = cp_launches[row["name"]]
            continue
        if bench_rows is None:                       # row 1: the train path's count
            row["launches"] = train_launches[row["name"]]
            row["launches_by_path"] = {"train": row["launches"],
                                       "train_density": density_launches,
                                       "train_stack": stack_launches}
            continue
        bench, pattern = bench_rows
        matched = [r for r in summaries[bench]["rows"] if re.fullmatch(pattern, r["name"])]
        row["launches"] = sum(r["launches"].get(libs[row["name"]].symbol, 0) for r in matched)
        if not row["launches"]:
            raise AssertionError(f"row {row['row']} ({row['shape']}): the {bench} rows "
                                 f"{[r['name'] for r in matched]} launched no {row['name']}")
    phase("bench", launches_by_row=repr(" ".join(f"{r['row']}:{r['launches']}" for r in rows)))

    phase("sphere_parity", **check_sphere_parity())
    sphere_train, sphere_val, gen_s = generate_sphere_sets()
    train_sphere(sphere_train, gen_s, libs)
    train_sphere_hash(sphere_train, libs)
    del sphere_train
    render_pretrain(sphere_val, libs)
    train_renv(libs)
    render_renv(libs)
    cli_phase()
    hash_cli_launches = cli_hash_phase(libs)
    mesh_phase()
    demo_phase()
    unwrap_phase()
    turntable_phase()
    viewer_phase()
    phase("volsdf_parity", **check_volsdf_parity())
    train_volsdf(libs)
    volsdf_hash_launches = train_volsdf_hash(libs)
    split_env(libs)
    options_phase(libs)
    sphere_mode_render(libs)
    for row in rows:
        if row["name"] == "scatter_add_rows":
            row["launches_by_path"]["cli_hash"] = hash_cli_launches
            row["launches_by_path"]["train_volsdf_hash"] = volsdf_hash_launches

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

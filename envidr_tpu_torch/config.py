"""Options dataclass and `.ini` loader of the PyTorch port.

A copy of ``envidr_tpu/config.py`` (the JAX package's loader cannot be
imported here: it pulls in jax through its network module).  The dialect is
the same: ``key = value``, ``#``/``;`` comments, ``[a, b]`` lists.  One
difference: a key that names no field of :class:`Options` raises instead of
being dropped, so a config never silently loses a setting.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Tuple

from envidr_tpu_torch.models.network import NetworkConfig


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        return [_parse_value(v) for v in inner.split(",")] if inner else []
    low = raw.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def parse_ini(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith(";"):
                continue
            if "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = _parse_value(v)
    return out


@dataclasses.dataclass(frozen=True)
class Options:
    """Union of the reference's main flag schema (nerf/options.py) — defaults
    match the reference so its .ini files drop in unchanged."""

    config: str = ""
    path: str = ""
    workspace: str = "workspace"
    seed: int = 0
    test: bool = False

    # training
    iters: int = 30000
    lr: float = 1e-2
    plr: float = 0.0
    slr: float = 0.0
    elr: float = 0.0
    ckpt: str = "latest"
    num_rays: int = 4096
    num_rays_sched: Tuple[int, ...] = ()
    cuda_ray: bool = False                # kept for config compat; we always grid-march
    max_steps: int = 1024
    max_steps_sched: Tuple[int, ...] = ()
    early_stop_steps: int = -1
    early_stop_steps_sched: Tuple[int, ...] = ()
    num_steps: int = 512
    upsample_steps: int = 0
    update_extra_interval: int = 16
    update_extra_before: int = -1
    extra_state_full_update: bool = False
    max_ray_batch: int = 4096
    max_ray_batch_cuda: int = -1
    image_batch: int = 1
    max_keep_ckpt: int = 2
    T_thresh: float = 1e-4
    stratified_sampling: bool = False
    eval_interval: int = 200

    # network backbone
    fp16: bool = False
    encoding_pos: str = "hashgrid"
    num_levels: int = 16
    level_dim: int = 2
    enabled_levels: int = -1
    enabled_levels_sched: Tuple[int, ...] = ()
    base_resolution: int = 16
    desired_resolution: int = 2048
    log2_hashmap_size: int = 19
    hidden_dim: int = 64
    num_layers: int = 2
    skip_layers: Tuple[int, ...] = ()
    multires: int = 6

    # dataset
    color_space: str = "srgb"
    preload: bool = False
    bound: float = 2.0
    scale: float = 0.33
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    dt_gamma: float = 1.0 / 128.0
    min_near: float = 0.2
    density_thresh: float = 10.0
    bg_radius: float = -1.0
    num_layers_bg: int = 2
    marching_aabb: Tuple[float, ...] = ()
    obj_aabb: Optional[Tuple[float, ...]] = None
    test_split: str = "test"
    test_ids: Tuple[int, ...] = ()
    test_skip: int = 10
    error_map: bool = False
    error_map_start_iter: int = 0
    rand_pose: int = -1
    patch_size: int = 1
    center_crop: float = 0.0             # central-crop ray sampling window
    center_crop_ratio: float = 0.6       # fraction of rays from the crop

    # sdf / geometry
    use_sdf: bool = False
    use_neus_sdf: bool = False
    init_variance: float = 0.3
    neus_n_detach: bool = False
    geo_init_bias: float = 1.0
    inside_outside: bool = False
    cos_anneal_steps: int = 5000
    cos_anneal_ratio: float = 1.0
    warmup_steps: int = 0
    geometric_init: bool = False
    geometric_cue: bool = False          # pre-fit SDF to a sphere (utils.py:1668)
    init_beta: float = 0.1
    beta_min: float = 0.0001
    beta_max: float = 1.0
    beta_min_sched: Tuple[float, ...] = ()
    # [start, end, epochs]: host-side geometric anneal of an UPPER cap on the
    # learned Laplace beta (projected at epoch boundaries — no recompile).
    # The reference's beta is free and takes ~500 epochs to sharpen out of
    # the fog equilibrium (docs/QUALITY_R2.md); this forces the escape.
    beta_cap_sched: Tuple[float, ...] = ()

    # losses
    relsdf_loss_start_iter: int = 0
    relsdf_loss_weight: float = 0.0
    relsdf_loss_weight_sched: Tuple[float, ...] = ()
    relsdf_mode: str = "mean"
    dist_bound_weight: float = 0.0
    dist_bound_start_iter: int = 0
    backsdf_loss_start_iter: int = 0
    backsdf_loss_weight: float = 0.0
    backsdf_thresh: float = 0.1
    backsdf_mode: str = "sum"
    backsdf_loss_weight_sched: Tuple[float, ...] = ()
    cauchy_loss_start_iter: int = 0
    cauchy_loss_weight: float = 0.0
    cauchy_roughness_weighted: bool = False
    cauchy_undetach_beta: bool = False
    cauchy_loss_weight_sched: Tuple[float, ...] = ()
    weighted_eikonal: bool = False
    eikonal_loss_start_iter: int = 0
    eikonal_loss_weight: float = 0.0
    eikonal_loss_weight_sched: Tuple[float, ...] = ()
    sdf_loss_weight: float = 0.0
    orientation_loss_weight: float = 0.0
    orientation_loss_start_iter: int = 0
    orientation_loss_weight_sched: Tuple[float, ...] = ()
    entropy_loss_weight: float = 0.0
    mask_loss_weight: float = 0.0
    mask_loss_start_iter: int = 0
    color_loss: str = "l2"
    color_l1_loss: bool = False
    color_loss_weight: float = 1.0
    diffuse_loss: bool = False
    diffuse_loss_weight: float = 1.0
    beta_loss_start_iter: int = 0
    beta_loss_weight: float = 0.0

    # color mlp
    color_act: str = "sigmoid"
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    encoding_dir: str = "sphere_harmonics"
    multires_dir: int = 0
    detach_normal: bool = False
    normal_with_mlp: bool = False
    multires_normal: int = 0
    sh_degree: int = 4
    error_bound_sample: bool = False
    error_bound_start_iter: int = 0
    render_bg_color: str = "white"
    alpha_bg_mode: str = "random"
    net_init: str = ""
    mlp_bias: bool = False
    geo_feat_act: str = ""
    env_feat_act: str = ""
    use_diffuse: bool = False
    diffuse_only: bool = False
    color_net_start_iter: int = 0
    num_layers_diffuse: int = 2
    hidden_dim_diffuse: int = 32
    diffuse_with_env: bool = False
    diffuse_env_fusion: str = "concat"
    visual_items: Tuple[str, ...] = ()
    use_reflected_dir: bool = False
    multires_refdir: int = 0
    use_n_dot_viewdir: bool = False
    use_env_net: bool = False
    num_layers_env: int = 4
    hidden_dim_env: int = 128
    env_feat_dim: int = 16
    env_wo_bias: bool = False
    geo_feat_dim: int = 15
    encoding_ref: str = "frequency"
    wo_viewdir: bool = False
    normal_anneal_iters: int = 0
    normal_anneal_ratio: float = 1.0

    # lighting / env-sphere
    swap_env_path: str = ""
    env_sph_mode: bool = False
    env_sph_radius: float = 1.0
    env_dataset_config: str = ""
    light_intensity_scale: float = 1.0
    color_mlp_path: str = ""
    frozen_mlps: Tuple[str, ...] = ()
    resume_mlps: Tuple[str, ...] = ()
    use_roughness: bool = False
    diffuse_kappa_inv: float = 0.64
    default_roughness: float = 0.05
    split_diffuse_env: bool = False
    hidden_dim_env_diffuse: int = -1
    sh_degree_diffuse: int = -1
    roughness_scale: float = 1.0
    roughness_act_scale: float = 0.2
    ensemble_mlp: bool = False

    # interreflection
    indir_ref: bool = False
    dir_only: bool = False
    indir_only: bool = False
    indir_ref_start_iter: int = -1
    indir_roughness_thresh: float = 0.1
    indir_early_stop_steps: int = 32
    indir_max_steps: int = 1024
    learn_indir_blend: bool = False
    grad_rays: bool = False
    grad_rays_scale: float = 0.01
    grad_rays_start_iter: int = 100
    train_renv: bool = False
    use_renv: bool = False
    renv_mlp_path: str = ""

    # applications
    unwrap_env_sphere: bool = False
    unwrap_env_id: int = -1
    img_format: str = "jpg"
    unwrap_roughness: float = 0.7
    unwrap_metallic: float = 0.9
    unwrap_color: Tuple[float, float, float] = (0.7, 0.7, 0.7)
    unwrap_color_intensity: float = 1.0
    intensity_scale: float = 1.0
    val_folder_name: str = "validation"
    render_env_on_sphere: bool = False
    overwrite_materials: bool = False
    set_env_net_index: int = -1
    train_env_only: bool = False
    env_rot_degree_range: Tuple[int, ...] = ()

    # env-sphere dataset schema (nerf/sph_loader.py:18-47)
    camera_angle_x: float = 0.6194058656692505
    sph_radius: float = 0.95
    render_image_H: int = 800
    render_image_W: int = 800
    radius: float = 4.0
    num_train_images: int = 100
    vary_roughness: bool = False
    vary_metallic: bool = False
    vary_base_color: bool = False
    num_envs: int = 11
    env_data_dir: str = ""               # pre-rendered env-sphere dataset root

    # TPU-specific runtime knobs (no reference analogue)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"      # MLP matmul dtype on TPU
    samples_budget: int = -1             # static K override (-1: auto from mean_count)
    min_samples_budget: int = 32         # K floor: a pruned grid (mean_count
                                         # ~4) must not starve the thin NeuS
                                         # shell of samples (limit-cycle guard)
    numerical_normals: bool = False      # central-difference SDF normals (TPU fast path)
    numerical_normals_eps: float = 0.005
    hash_table_dtype: str = "float32"    # 'bfloat16' for half gather bytes
    hash_scatter_impl: str = "xla"       # 'mixed': Pallas VMEM scatter levels;
    # 'sorted': scatter-free sort+cumsum reduction (ops/hashgrid.py).
    # All apply to the custom-VJP (rolled_tiled) backward only.
    # hand-written hash VJP: 'auto' = on for sphere/renv modes (shrinks the
    # second-order remote compile 20-26min -> ~1min), off for scene training
    # (measured 1101ms vs 589ms/step: XLA's autodiff fuses the two same-index
    # scatter-adds of the first+second-order backward; the custom path can't).
    hash_custom_grad: str = "auto"       # 'auto' | 'on' | 'off'
    cp_rank: int = 32                    # CP (MXU) encoder rank
    eval_samples_budget: int = 256
    # 0 = unset sentinel: finalize() resolves it (max_ray_batch if the config
    # sets one, else 4096).  An explicit value always wins — the old ==4096
    # heuristic silently overrode an explicitly-set 4096 (ADVICE r4).
    eval_ray_chunk: int = 0
    # two-level occupancy march (coarse maxpool probe + fine refine) — cuts
    # the march's gather-row wall ~2.7x; exact up to the M-segment budget
    coarse_march: bool = False
    mesh_shape: Tuple[int, ...] = ()     # data-parallel device mesh (empty: all devices)


def finalize(opt: Options) -> Options:
    """Post-parse derived-flag normalization (options.py:288-358)."""
    upd = {}
    if opt.hidden_dim_env_diffuse < 0:
        upd["hidden_dim_env_diffuse"] = opt.hidden_dim_env
    if opt.sh_degree_diffuse < 0:
        upd["sh_degree_diffuse"] = opt.sh_degree
    if opt.color_l1_loss:
        upd["color_loss"] = "l1"
    # max_ray_batch is the reference's test-time ray chunk (renderer.py:364);
    # our equivalent knob is eval_ray_chunk — map it through unless the user
    # set eval_ray_chunk explicitly (sentinel 0 = unset)
    if opt.eval_ray_chunk <= 0:
        if opt.max_ray_batch != 4096:
            print(f"[config] eval_ray_chunk <- max_ray_batch "
                  f"({opt.max_ray_batch}); set eval_ray_chunk to override "
                  f"(large chunks materialize on CPU eval)")
            upd["eval_ray_chunk"] = opt.max_ray_batch
        else:
            upd["eval_ray_chunk"] = 4096
    if opt.use_neus_sdf:
        upd["use_sdf"] = True
    if opt.train_renv:
        upd["use_env_net"] = True
        upd["use_renv"] = True
    if opt.indir_ref or opt.indir_ref_start_iter > 0:
        upd["use_renv"] = True
    if not opt.resume_mlps:
        upd["resume_mlps"] = opt.frozen_mlps
    if opt.diffuse_loss_weight > 0 and opt.diffuse_loss:
        upd["diffuse_loss"] = True

    def fix_sched(name, start):
        sched = list(getattr(opt, name))
        if len(sched) == 4:
            sched.insert(2, start)
            upd[name] = tuple(sched)

    fix_sched("relsdf_loss_weight_sched", opt.relsdf_loss_start_iter)
    fix_sched("backsdf_loss_weight_sched", opt.backsdf_loss_start_iter)
    fix_sched("cauchy_loss_weight_sched", opt.cauchy_loss_start_iter)
    fix_sched("eikonal_loss_weight_sched", opt.eikonal_loss_start_iter)
    fix_sched("orientation_loss_weight_sched", opt.orientation_loss_start_iter)
    return dataclasses.replace(opt, **upd) if upd else opt

# accepted for .ini compatibility but consumed nowhere (dead in the reference
# as well); a warning keeps such a config from silently doing nothing
_UNIMPLEMENTED = ("warmup_steps", "beta_loss_weight", "max_ray_batch_cuda")


def load_options(config_path: str = "", **overrides) -> Options:
    """Parse ``config_path`` (plus keyword overrides) into :class:`Options`.

    Raises ``ValueError`` for a key that is not a field of :class:`Options`.
    """
    fields = {f.name: f for f in dataclasses.fields(Options)}
    values = {}
    if config_path:
        raw = parse_ini(config_path)
        # follow the env-dataset sub-config (sph_loader.py:18-47 schema)
        sub = raw.get("env_dataset_config", "")
        if sub:
            for cand in (sub, os.path.join(os.path.dirname(config_path),
                                           os.path.basename(str(sub)))):
                if isinstance(cand, str) and os.path.exists(cand):
                    merged = parse_ini(cand)
                    merged.update(raw)      # main config wins
                    raw = merged
                    break
        for k, v in raw.items():
            if k not in fields:
                raise ValueError(f"{config_path}: unknown option '{k}'")
            if isinstance(v, list):
                v = tuple(v)
            elif fields[k].type == "float" and isinstance(v, int):
                v = float(v)
            values[k] = v
        values["config"] = config_path
    unknown = sorted(set(overrides) - set(fields))
    if unknown:
        raise ValueError(f"unknown option override(s): {unknown}")
    values.update(overrides)
    for k in _UNIMPLEMENTED:
        if k in values:
            warnings.warn(
                f"option '{k}' is accepted for config compatibility but "
                f"unimplemented (dead in the reference as well)")
    return finalize(Options(**values))


# the hash encoder's path through the port's kernel: the hand-written VJP,
# whose table gradients csrc/scatter_rows.cu scatters
HASH_KERNEL_PATH = dict(hash_scatter_impl="mixed", hash_custom_grad="on")


def card_options(config_path: str, **overrides) -> Options:
    """:func:`load_options` as the card runs a config: a scene-mode hash-grid
    config takes :data:`HASH_KERNEL_PATH` (the CP configs reach no kernel);
    a sphere-mode config runs as it stands (its ``hashgrid_diff`` is the
    ``hash`` indexing, differentiated by autograd: no kernel either)."""
    opt = load_options(config_path, **overrides)
    if opt.encoding_pos in ("rolled_tiled", "hashgrid", "hashgrid_diff") and not opt.env_sph_mode:
        opt = load_options(config_path, **{**HASH_KERNEL_PATH, **overrides})
    return opt


def network_config(opt: Options) -> NetworkConfig:
    """Build the structural NetworkConfig from Options (main_nerf.py:28-78)."""
    in_r = in_m = in_c = 0
    if opt.env_sph_mode:
        in_r, in_m = int(opt.vary_roughness), int(opt.vary_metallic)
        in_c = 3 * int(opt.vary_base_color)
    elif opt.unwrap_env_sphere or opt.render_env_on_sphere:
        in_r, in_m, in_c = 1, 1, 3
    return NetworkConfig(
        bound=opt.bound,
        encoding_pos=opt.encoding_pos,
        num_levels=opt.num_levels, level_dim=opt.level_dim,
        base_resolution=opt.base_resolution,
        desired_resolution=opt.desired_resolution,
        log2_hashmap_size=opt.log2_hashmap_size, multires=opt.multires,
        num_layers=opt.num_layers, hidden_dim=opt.hidden_dim,
        geo_feat_dim=opt.geo_feat_dim, skip_layers=tuple(opt.skip_layers),
        use_sdf=opt.use_sdf, use_neus_sdf=opt.use_neus_sdf,
        init_beta=opt.init_beta, beta_min=opt.beta_min, beta_max=opt.beta_max,
        init_variance=opt.init_variance, neus_n_detach=opt.neus_n_detach,
        geometric_init=opt.geometric_init, inside_outside=opt.inside_outside,
        geo_init_bias=opt.geo_init_bias, mlp_bias=opt.mlp_bias,
        net_init=opt.net_init, geo_feat_act=opt.geo_feat_act,
        in_roughness=in_r, in_metallic=in_m, in_base_color=in_c,
        use_roughness=opt.use_roughness, ensemble_mlp=opt.ensemble_mlp,
        learn_indir_blend=opt.learn_indir_blend,
        roughness_act_scale=opt.roughness_act_scale,
        roughness_scale=opt.roughness_scale,
        default_roughness=opt.default_roughness,
        encoding_dir=opt.encoding_dir, multires_dir=opt.multires_dir,
        sh_degree=opt.sh_degree, sh_degree_diffuse=opt.sh_degree_diffuse,
        multires_normal=opt.multires_normal, encoding_ref=opt.encoding_ref,
        multires_refdir=opt.multires_refdir,
        normal_with_mlp=opt.normal_with_mlp,
        use_reflected_dir=opt.use_reflected_dir,
        use_n_dot_viewdir=opt.use_n_dot_viewdir, wo_viewdir=opt.wo_viewdir,
        detach_normal=opt.detach_normal,
        use_diffuse=opt.use_diffuse, num_layers_diffuse=opt.num_layers_diffuse,
        hidden_dim_diffuse=opt.hidden_dim_diffuse,
        diffuse_with_env=opt.diffuse_with_env,
        diffuse_env_fusion=opt.diffuse_env_fusion,
        diffuse_kappa_inv=opt.diffuse_kappa_inv,
        split_diffuse_env=opt.split_diffuse_env,
        hidden_dim_env_diffuse=opt.hidden_dim_env_diffuse,
        use_env_net=opt.use_env_net, env_sph_mode=opt.env_sph_mode,
        num_env_nets=opt.num_envs if opt.env_sph_mode else 1,
        num_layers_env=opt.num_layers_env, hidden_dim_env=opt.hidden_dim_env,
        env_feat_dim=opt.env_feat_dim, env_wo_bias=opt.env_wo_bias,
        env_feat_act=opt.env_feat_act,
        use_renv=opt.use_renv, train_renv=opt.train_renv,
        indir_roughness_thresh=opt.indir_roughness_thresh,
        indir_only=opt.indir_only,
        num_layers_color=opt.num_layers_color,
        hidden_dim_color=opt.hidden_dim_color, color_act=opt.color_act,
        intensity_scale=opt.intensity_scale,
        light_intensity_scale=opt.light_intensity_scale,
        bg_radius=opt.bg_radius, num_layers_bg=opt.num_layers_bg,
        hidden_dim_bg=64,
        numerical_normals=opt.numerical_normals,
        numerical_normals_eps=opt.numerical_normals_eps,
        hash_table_dtype=opt.hash_table_dtype,
        hash_scatter_impl=opt.hash_scatter_impl,
        cp_rank=opt.cp_rank,
        hash_custom_grad=(
            opt.env_sph_mode or opt.render_env_on_sphere or opt.train_renv
            if str(opt.hash_custom_grad) == "auto"
            else str(opt.hash_custom_grad).lower() in ("on", "true", "1")),
    )

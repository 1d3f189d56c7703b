"""The ENVIDR neural model in PyTorch: SDF + materials + neural-renderer MLPs.

Counterpart of ``envidr_tpu/models/network.py``.  The JAX package keeps a
parameter pytree and pure functions; here :class:`NeRFNetwork` is an
``nn.Module`` whose submodule names are the pytree's top-level keys
(``encoder``, ``sdf_density``, ``sdf_net``, ``roughness_layer``,
``diffuse_net``, ``color_net``, ``env_net`` or ``env_nets``,
``diffuse_env_net``, ``renv_net``, ``bg``); its constructor is
``init_network_params``, and its methods carry the JAX functions' names
(``forward_geometry``, ``geometry_with_normals``, ``sdf_to_sigma``,
``forward_color``, ``get_color_mlp_extra_params``, ``background_color``).

Every option of the JAX ``NetworkConfig`` is ported: the hash encoder
(``encoding_pos`` ``rolled_tiled``, and ``hashgrid`` / ``hashgrid_diff``,
which select ``hash`` indexing with linear / smoothstep interpolation), the
CP encoder (``cp``), the frequency encoding of the position (``frequency``:
no encoder parameters), material conditioning (roughness, metallic and
colour appended to the SDF net's input, in that order), the Laplace density
and the NeuS alpha, a density field (``use_sdf=False``: a ``trunc_exp``
sigma head, normals from -grad sigma), the geometric (sphere) init with
softplus(100) between the SDF layers, numerical (central-difference)
normals, a roughness head on ``geo_feat`` when the SDF net is not an
ensemble, the frequency/SH/IDE direction encoders, the diffuse, specular and
environment MLPs, a diffuse env net of its own (``split_diffuse_env``), the
stack of ``num_env_nets`` env MLPs of sphere mode (``env_sph_mode``:
``env_nets``, one chosen per call by ``env_index``), the interreflection
branch (``use_renv``: ``renv_net`` reads the colour and visibility of a
reflected ray, gated by roughness, and ``learn_indir_blend`` blends it in;
under ``train_renv`` it replaces the specular colour outright where
``r_images`` are given) and the background net (``bg_radius > 0``: a 2-D
hash grid on the background sphere and a bias-free MLP).
:meth:`NeRFNetwork.diffuse_only` renders the diffuse term alone (no
roughness, no specular), as a step before ``color_net_start_iter`` does.
``skip_layers`` is refused: the JAX package's own SDF net fails on it
(:func:`_unported`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from envidr_tpu_torch import obs
from envidr_tpu_torch.geometry.rays import reflect_dir
from envidr_tpu_torch.models.mlp import (
    apply_mlp, apply_stacked_mlp, feat_act, init_linear, init_mlp, softplus_beta, stack_mlps,
)
from envidr_tpu_torch.ops import density as density_ops
from envidr_tpu_torch.ops.cp import (CPSpec, cp_encode_from_world, init_cp_params,
                                     rows_read_again)
from envidr_tpu_torch.ops.freq import freq_encode, freq_output_dim
from envidr_tpu_torch.ops.hashgrid import (
    EncoderGradGate, HashGridSpec, hash_encode, hash_encode_from_world, init_hash_embeddings,
)
from envidr_tpu_torch.ops.ide import ide_encode, ide_output_dim
from envidr_tpu_torch.ops.sh import sh_encode, sh_output_dim


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Structural hyper-parameters (a copy of the JAX package's NetworkConfig;
    field names and defaults track ``nerf/options.py``)."""

    bound: float = 1.0
    # --- position encoder -------------------------------------------------
    encoding_pos: str = "hashgrid_diff"   # 'hashgrid_diff' | 'hashgrid' | 'frequency'
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    desired_resolution: int = 2048        # scaled by bound at build time
    log2_hashmap_size: int = 19
    multires: int = 6                     # freq PE fallback
    # --- SDF net ----------------------------------------------------------
    num_layers: int = 3
    hidden_dim: int = 64
    geo_feat_dim: int = 12
    skip_layers: Tuple[int, ...] = ()
    use_sdf: bool = True
    use_neus_sdf: bool = False
    init_beta: float = 0.1
    beta_min: float = 0.0005
    beta_max: float = 1.0
    init_variance: float = 0.3
    neus_n_detach: bool = False
    geometric_init: bool = False
    inside_outside: bool = False
    geo_init_bias: float = 1.0
    mlp_bias: bool = True
    net_init: str = "xavier_uniform"
    geo_feat_act: str = "unitNorm"
    # --- material conditioning (env-sphere pretraining) -------------------
    in_roughness: int = 0
    in_metallic: int = 0
    in_base_color: int = 0
    # --- roughness head ----------------------------------------------------
    use_roughness: bool = True
    ensemble_mlp: bool = True
    learn_indir_blend: bool = False
    roughness_bias: float = -1.0
    roughness_act_scale: float = 0.2
    roughness_scale: float = 1.0
    default_roughness: float = 0.05
    bypass_roughness: bool = False
    diffuse_only: bool = False
    # --- direction encoders -------------------------------------------------
    encoding_dir: str = "frequency"
    multires_dir: int = 0
    sh_degree: int = 4                    # degree for SH *and* deg_view for IDE
    sh_degree_diffuse: int = -1
    multires_normal: int = 0
    encoding_ref: str = "integrated_dir"
    multires_refdir: int = 4
    normal_with_mlp: bool = True
    use_reflected_dir: bool = True
    use_n_dot_viewdir: bool = True
    wo_viewdir: bool = True
    detach_normal: bool = False
    # --- diffuse branch -----------------------------------------------------
    use_diffuse: bool = True
    num_layers_diffuse: int = 2
    hidden_dim_diffuse: int = 32
    diffuse_with_env: bool = True
    diffuse_env_fusion: str = "concat"    # 'concat' | 'add' | 'mul'
    diffuse_kappa_inv: float = 0.64
    split_diffuse_env: bool = False
    hidden_dim_env_diffuse: int = -1
    # --- environment MLPs ---------------------------------------------------
    use_env_net: bool = True
    env_sph_mode: bool = False
    num_env_nets: int = 1                 # >1 only in env_sph_mode
    num_layers_env: int = 4
    hidden_dim_env: int = 160
    env_feat_dim: int = 12
    env_wo_bias: bool = False
    env_feat_act: str = "unitNorm"
    # --- interreflection (renv) --------------------------------------------
    use_renv: bool = False
    train_renv: bool = False
    indir_roughness_thresh: float = 0.1
    indir_only: bool = False
    # --- specular color net -------------------------------------------------
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    color_act: str = "sigmoid"            # 'sigmoid' | 'exp'
    intensity_scale: float = 1.0
    light_intensity_scale: float = 1.0
    # --- background ---------------------------------------------------------
    bg_radius: float = -1.0
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    # --- TPU-specific -------------------------------------------------------
    # Numerical (central-difference) SDF gradients instead of autodiff
    # double-backward.  6 extra forward evals, but the eikonal/normal losses
    # then need only FIRST-order backprop — on TPU the second-order graph
    # through the hash gathers costs ~10x the whole rest of the step (and is
    # the Neuralangelo recipe: numerical grads also behave better for hash
    # grids).  The analytic path (reference parity, renderer.py:182-198)
    # remains the default.
    numerical_normals: bool = False
    numerical_normals_eps: float = 0.005
    hash_table_dtype: str = "float32"      # 'bfloat16': halve gather bytes
    hash_scatter_impl: str = "xla"         # 'mixed': Pallas VMEM scatter levels
    hash_custom_grad: bool = True          # hand-written 1st+2nd-order VJP
    cp_rank: int = 32                      # CP encoder rank (encoding_pos='cp')

    # ----- derived dims -----------------------------------------------------
    @property
    def hash_spec(self) -> HashGridSpec:
        interp = "linear" if self.encoding_pos == "hashgrid" else "smoothstep"
        indexing = "rolled_tiled" if self.encoding_pos == "rolled_tiled" else "hash"
        return HashGridSpec(
            input_dim=3, num_levels=self.num_levels, level_dim=self.level_dim,
            base_resolution=self.base_resolution,
            desired_resolution=int(self.bound * self.desired_resolution),
            log2_hashmap_size=self.log2_hashmap_size, interpolation=interp,
            indexing=indexing, table_dtype=self.hash_table_dtype,
            scatter_impl=self.hash_scatter_impl,
            custom_grad=self.hash_custom_grad)

    @property
    def cp_spec(self) -> CPSpec:
        return CPSpec(
            input_dim=3, num_levels=self.num_levels, level_dim=self.level_dim,
            rank=self.cp_rank, base_resolution=self.base_resolution,
            desired_resolution=int(self.bound * self.desired_resolution))

    @property
    def pos_enc_dim(self) -> int:
        if self.encoding_pos in ("hashgrid", "hashgrid_diff", "rolled_tiled",
                                 "cp"):
            return self.num_levels * self.level_dim
        return freq_output_dim(3, self.multires)

    @property
    def material_dims(self) -> int:
        return self.in_roughness + self.in_metallic + self.in_base_color

    @property
    def sdf_in_dim(self) -> int:
        return self.pos_enc_dim + self.material_dims

    @property
    def sdf_out_dim(self) -> int:
        out = 1 + self.geo_feat_dim
        if self.ensemble_mlp:
            out += int(self.use_roughness) + int(self.learn_indir_blend)
        return out

    def _dir_enc_dim(self, encoding: str, multires: int, degree: int) -> int:
        if encoding == "frequency":
            return freq_output_dim(3, multires) if multires > 0 else 3
        if encoding == "sphere_harmonics":
            return sh_output_dim(degree)
        if encoding == "integrated_dir":
            return ide_output_dim(degree)
        raise ValueError(encoding)

    @property
    def in_dim_dir(self) -> int:
        if self.wo_viewdir:
            return 0
        return self._dir_enc_dim(self.encoding_dir, self.multires_dir, self.sh_degree)

    @property
    def in_normal_dim(self) -> int:
        if not self.normal_with_mlp:
            return 0
        return self._dir_enc_dim(self.encoding_dir, self.multires_normal, self.sh_degree)

    @property
    def refdir_enc_dim(self) -> int:
        return self._dir_enc_dim(self.encoding_ref, self.multires_refdir, self.sh_degree)

    @property
    def refdir_enc_dim_diffuse(self) -> int:
        deg = self.sh_degree_diffuse if self.sh_degree_diffuse > 0 else self.sh_degree
        return self._dir_enc_dim(self.encoding_ref, self.multires_refdir, deg)

    @property
    def in_refdir_dim(self) -> int:
        """dim of the env-feature slot in the color net (network.py:263-301)."""
        if not self.use_reflected_dir:
            return 0
        return self.env_feat_dim if self.use_env_net else self.refdir_enc_dim

    @property
    def color_in_dim(self) -> int:
        return (self.in_dim_dir + self.geo_feat_dim + self.in_normal_dim
                + self.in_refdir_dim + int(self.use_n_dot_viewdir))

    @property
    def diffuse_in_dim(self) -> int:
        if self.diffuse_with_env and self.diffuse_env_fusion == "concat":
            return self.geo_feat_dim + self.env_feat_dim
        return self.geo_feat_dim


def _unported(cfg: NetworkConfig):
    """Names of the options of ``cfg`` the port refuses.  ``skip_layers``
    fails in the JAX package itself: its skip layer takes ``hidden_dim +
    sdf_in_dim`` inputs but is handed ``hidden_dim - pos_enc_dim +
    sdf_in_dim`` (``envidr_tpu/models/network.py:254-263``), so there is
    no reference to hold a port to."""
    checks = {
        f"encoding_pos={cfg.encoding_pos!r}": cfg.encoding_pos not in (
            "rolled_tiled", "hashgrid", "hashgrid_diff", "cp", "frequency"),
        "skip_layers (the JAX package's SDF net fails on it: its skip layer's "
        "input width is hidden_dim - pos_enc_dim + sdf_in_dim, its weight's "
        "hidden_dim + sdf_in_dim, envidr_tpu/models/network.py:254-263)": bool(cfg.skip_layers),
    }
    return [name for name, bad in checks.items() if bad]


def bg_hash_spec(cfg: NetworkConfig) -> HashGridSpec:
    """The background net's 2-D hash grid (``network.py:344-353``): 4
    levels, 2^19 rows, resolution 16 to 2048, linear interpolation,
    ``hash`` indexing with autograd's table gradient."""
    return HashGridSpec(input_dim=2, num_levels=4, level_dim=cfg.level_dim, base_resolution=16,
                        desired_resolution=2048, log2_hashmap_size=19, interpolation="linear")


def encode_dir(encoding: str, multires: int, degree: int, dirs, roughness=0.0):
    if encoding == "frequency":
        return freq_encode(dirs, degree=multires) if multires > 0 else dirs
    if encoding == "sphere_harmonics":
        return sh_encode(dirs, degree=degree)
    if encoding == "integrated_dir":
        return ide_encode(dirs, roughness, deg_view=degree)
    raise ValueError(encoding)


def _safe_normalize(v: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """v / sqrt(|v|^2 + eps^2): bounded gradient at v = 0, unlike
    ``v / max(|v|, eps)`` whose backward is 0/0 there."""
    return v * torch.rsqrt((v * v).sum(dim=-1, keepdim=True) + eps * eps)


class _Params(nn.Module):
    """A named holder of loose parameters (``encoder.embeddings``,
    ``sdf_density.beta`` or ``sdf_density.variance``) so that module names
    match the JAX pytree keys."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))


class CPEncoder(nn.Module):
    """The CP encoder's tables as parameters named like the JAX pytree
    ``{"axes": [[Tx, Ty, Tz] per level], "proj": [P per level]}``:
    ``axes.<level>.<axis>`` and ``proj.<level>``."""

    def __init__(self, spec: CPSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        p = init_cp_params(spec, generator=generator)
        self.axes = nn.ModuleList([nn.ParameterList(level) for level in p["axes"]])
        self.proj = nn.ParameterList(p["proj"])

    def tables(self):
        return {"axes": [list(level) for level in self.axes], "proj": list(self.proj)}


class BackgroundNet(nn.Module):
    """``params["bg"]``: ``encoder.embeddings`` of :func:`bg_hash_spec` and
    ``net``, an MLP from the encoding and the degree-4 SH of the direction
    to a colour, without biases."""

    def __init__(self, cfg: NetworkConfig, init: str, generator: Optional[torch.Generator]):
        super().__init__()
        spec = bg_hash_spec(cfg)
        self.encoder = _Params(embeddings=init_hash_embeddings(spec, generator=generator))
        self.net = init_mlp([spec.output_dim + sh_output_dim(4)]
                            + [cfg.hidden_dim_bg] * (cfg.num_layers_bg - 1) + [3],
                            bias=False, init=init, generator=generator)


def _geometric_init_layers(cfg: NetworkConfig, generator) -> nn.ModuleList:
    """The SDF net's geometric (sphere) init (``network.py:265-275``): the
    last layer ``sign * sqrt(pi) / sqrt(in) + 1e-4 N(0, 1)`` with bias
    ``-sign * geo_init_bias``; the first ``sqrt(2) / sqrt(out) N(0, 1)`` on
    the first three inputs and zero on the rest; the others ``sqrt(2) /
    sqrt(out) N(0, 1)``; biases zero."""
    layers = []
    sign = -1.0 if cfg.inside_outside else 1.0
    for l in range(cfg.num_layers):
        in_dim = cfg.sdf_in_dim if l == 0 else cfg.hidden_dim
        last = l == cfg.num_layers - 1
        out_dim = cfg.sdf_out_dim if last else cfg.hidden_dim
        layer = nn.Linear(in_dim, out_dim)
        with torch.no_grad():
            w = torch.randn((out_dim, in_dim), generator=generator)
            if last:
                layer.weight.copy_(sign * math.sqrt(math.pi) / math.sqrt(in_dim) + 1e-4 * w)
                layer.bias.fill_(-sign * cfg.geo_init_bias)
            else:
                w = w * (math.sqrt(2.0) / math.sqrt(out_dim))
                if l == 0 and in_dim > 3:
                    w[:, 3:] = 0.0
                layer.weight.copy_(w)
                layer.bias.zero_()
        layers.append(layer)
    return nn.ModuleList(layers)


class NeRFNetwork(nn.Module):
    def __init__(self, cfg: NetworkConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(
                f"not ported to envidr_tpu_torch yet: {', '.join(missing)}")
        self.cfg = cfg
        # the CP encoder's spec; a caller may swap in another compute dtype
        self.cp_spec = cfg.cp_spec
        init = cfg.net_init or "torch_default"
        if cfg.encoding_pos == "cp":
            self.encoder = CPEncoder(self.cp_spec, generator)
        elif cfg.encoding_pos != "frequency":
            self.encoder = _Params(
                embeddings=init_hash_embeddings(cfg.hash_spec, generator=generator))
        if cfg.use_sdf:             # a density field has no SDF-to-density scalar
            self.sdf_density = _Params(**(
                density_ops.init_neus_params(cfg.init_variance) if cfg.use_neus_sdf
                else density_ops.init_laplace_params(cfg.init_beta)))
        if cfg.geometric_init:
            self.sdf_net = _geometric_init_layers(cfg, generator)
        else:
            self.sdf_net = nn.ModuleList(
                init_linear(cfg.sdf_in_dim if l == 0 else cfg.hidden_dim,
                            cfg.sdf_out_dim if l == cfg.num_layers - 1 else cfg.hidden_dim,
                            bias=cfg.mlp_bias, init=init,
                            gain=1.0 if l == cfg.num_layers - 1 else math.sqrt(2.0),
                            generator=generator)
                for l in range(cfg.num_layers))
        if cfg.use_roughness and not cfg.ensemble_mlp:     # network.py:306
            self.roughness_layer = init_linear(cfg.geo_feat_dim, 1, init="torch_default",
                                               generator=generator)
        if cfg.use_diffuse:
            self.diffuse_net = init_mlp(
                [cfg.diffuse_in_dim] + [cfg.hidden_dim_diffuse]
                * (cfg.num_layers_diffuse - 1) + [3], init=init, generator=generator)
        self.color_net = init_mlp(
            [cfg.color_in_dim] + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1)
            + [3], bias=cfg.mlp_bias, init=init, generator=generator)
        if cfg.use_diffuse and cfg.mlp_bias:
            with torch.no_grad():      # lower initial specular (network.py:333-334)
                self.color_net[-1].bias -= math.log(3.0)
        if cfg.use_env_net:
            def env_mlp(in_dim=cfg.refdir_enc_dim, hidden=cfg.hidden_dim_env):
                return init_mlp([in_dim] + [hidden] * (cfg.num_layers_env - 1)
                                + [cfg.env_feat_dim],
                                bias=not cfg.env_wo_bias, init=init, generator=generator)
            if cfg.env_sph_mode:      # a stacked pytree in JAX (network.py:325-328)
                self.env_nets = stack_mlps([env_mlp() for _ in range(cfg.num_env_nets)])
            else:
                self.env_net = env_mlp()
                if cfg.split_diffuse_env:      # network.py:332-336
                    self.diffuse_env_net = env_mlp(
                        cfg.refdir_enc_dim_diffuse,
                        cfg.hidden_dim_env_diffuse if cfg.hidden_dim_env_diffuse > 0
                        else cfg.hidden_dim_env)
            if cfg.use_renv:    # rgb + roughness -> env feature (network.py:304-310)
                self.renv_net = init_mlp([4, 64, 64, 64, cfg.env_feat_dim],
                                         bias=not cfg.env_wo_bias, init=init,
                                         generator=generator)
        if cfg.bg_radius > 0:
            self.bg = BackgroundNet(cfg, init, generator)

    # ------------------------------------------------------------ geometry

    def encode_position(self, xyz, level_mask=None, gate: Optional[EncoderGradGate] = None):
        cfg = self.cfg
        if cfg.encoding_pos == "frequency":
            return freq_encode(xyz, degree=cfg.multires)
        with obs.span("encode"):
            if cfg.encoding_pos == "cp":
                x = cp_encode_from_world(xyz, self.encoder.tables(), self.cp_spec,
                                         bound=cfg.bound)
            else:
                x = hash_encode_from_world(xyz, self.encoder.embeddings, cfg.hash_spec,
                                           bound=cfg.bound, gate=gate)
            if level_mask is not None:
                # coarse-to-fine level gating (network.py:390-393)
                x = x * torch.repeat_interleave(level_mask, cfg.level_dim)
        return x

    def material_features(self, material, like: torch.Tensor) -> torch.Tensor:
        """The material inputs of the SDF net, broadcast to ``like``'s
        leading shape: roughness, metallic, colour (those the config takes).
        ``material`` is a dict of host or device values, or a tensor [5]
        (roughness, metallic, colour) on ``like``'s device."""
        cfg = self.cfg
        if isinstance(material, dict):
            material = material_tensor(material, like.device)
        m = material.to(like.dtype)
        # slices, not an index list: a list would be copied to the device
        parts = ([m[0:1]] if cfg.in_roughness else []) + ([m[1:2]] if cfg.in_metallic else []) \
            + ([m[2:5]] if cfg.in_base_color else [])
        m = torch.cat(parts)
        return m.expand(like.shape[:-1] + m.shape)

    def forward_geometry(self, xyz, level_mask=None,
                         gate: Optional[EncoderGradGate] = None, *,
                         material=None) -> Dict[str, Any]:
        """-> dict(sdf or, for a density field, sigma; geo_feat, roughness,
        blend_weight).  ``material`` conditions the SDF net in sphere mode."""
        cfg = self.cfg
        h = self.encode_position(xyz, level_mask, gate)
        if cfg.material_dims > 0:
            if material is None:
                raise ValueError("sphere mode requires material conditioning")
            h = torch.cat([h, self.material_features(material, h)], dim=-1)
        for l, layer in enumerate(self.sdf_net):
            h = layer(h)
            if l != cfg.num_layers - 1:
                h = softplus_beta(h, 100.0) if cfg.geometric_init else F.relu(h)
        out: Dict[str, Any] = (
            {"sdf": h[..., 0]} if cfg.use_sdf else {"sigma": density_ops.trunc_exp(h[..., 0])})
        out["geo_feat"] = feat_act(h[..., 1:1 + cfg.geo_feat_dim], cfg.geo_feat_act)
        if cfg.use_roughness and not cfg.diffuse_only and not cfg.bypass_roughness:
            raw = (h[..., 1 + cfg.geo_feat_dim:2 + cfg.geo_feat_dim] if cfg.ensemble_mlp
                   else self.roughness_layer(out["geo_feat"]))
            rough = cfg.roughness_act_scale * F.softplus(raw + cfg.roughness_bias)
            out["roughness"] = rough * cfg.roughness_scale
        else:
            out["roughness"] = None    # the renderer uses cfg.default_roughness
        out["blend_weight"] = (
            torch.sigmoid(h[..., 2 + cfg.geo_feat_dim:3 + cfg.geo_feat_dim])
            if cfg.learn_indir_blend and cfg.ensemble_mlp else None)
        return out

    def sdf_to_sigma(self, sdf, *, dirs=None, dists=None, normals=None,
                     cos_anneal_ratio=1.0, beta_cap=None, beta_min=None):
        """NeuS alpha (``use_neus_sdf``; ``dists`` defaults to one step of a
        1024-step ladder, 2*sqrt(3)/1024) or the Laplace density, whose beta
        ``beta_cap`` bounds from above and ``beta_min`` from below in place
        of ``cfg.beta_min``."""
        cfg = self.cfg
        if cfg.use_neus_sdf:
            if dists is None:
                dists = 2.0 * density_ops.SQRT3 / 1024.0
            return density_ops.neus_alpha(
                sdf, self.sdf_density.variance, dirs=dirs, dists=dists, gradients=normals,
                cos_anneal_ratio=cos_anneal_ratio, n_detach=cfg.neus_n_detach)
        beta = density_ops.laplace_beta(
            self.sdf_density.beta, cfg.beta_min if beta_min is None else beta_min,
            cfg.beta_max)
        if beta_cap is not None:
            # the gradient splits at a tie, as jnp.minimum's does
            beta = torch.minimum(beta, torch.as_tensor(beta_cap, device=beta.device))
        return density_ops.laplace_density(sdf, beta)

    def geometry_with_normals(self, xyz, level_mask=None, *, need_normals: bool = True,
                              normal_anneal_ratio: float = 1.0, create_graph: bool = True,
                              material=None):
        """forward_geometry + surface normals (of the SDF, or of -sigma for a
        density field): by autodiff, or with ``numerical_normals`` by central
        differences.

        Returns (geo_out, normals, raw_gradients).  With ``create_graph`` the
        gradients stay differentiable (the eikonal loss needs them); an eval
        render passes False.
        """
        if not need_normals:
            return self.forward_geometry(xyz, level_mask, material=material), None, None
        if self.cfg.numerical_normals:
            geo_out, grads = self._numerical_gradients(xyz, level_mask, material)
        else:
            gate = EncoderGradGate()
            with torch.enable_grad():
                # positions that carry a gradient (the indirect pass's grad_ray
                # samples) keep it, through the normals too
                pts = xyz if xyz.requires_grad else xyz.detach().requires_grad_(True)
                geo_out = self.forward_geometry(pts, level_mask, gate, material=material)
                gate.skip_table_grad = True
                try:
                    field = geo_out["sdf"] if self.cfg.use_sdf else geo_out["sigma"]
                    # the double backward keeps the CP encoder's rows as it reads them
                    with rows_read_again():
                        (grads,) = torch.autograd.grad(field.sum(), pts,
                                                       create_graph=create_graph)
                finally:
                    gate.skip_table_grad = False
            if not self.cfg.use_sdf:
                grads = -grads
        if not create_graph:
            geo_out = {k: (v.detach() if torch.is_tensor(v) else v)
                       for k, v in geo_out.items()}
            grads = grads.detach()
        normals = _safe_normalize(grads.detach() if self.cfg.detach_normal else grads)
        if normal_anneal_ratio < 1.0:
            anneal = _safe_normalize(xyz.detach())
            normals = _safe_normalize(normals * normal_anneal_ratio
                                      + (1.0 - normal_anneal_ratio) * anneal)
        return geo_out, normals, grads

    def _numerical_gradients(self, xyz, level_mask, material):
        """(geometry of ``xyz``, central differences of the field on the six
        probes ``xyz +- numerical_normals_eps`` along each axis, network.py:
        473-481); the field is ``-sigma`` for a density field."""
        eps = self.cfg.numerical_normals_eps
        eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
        probe = xyz[..., None, :] + torch.cat([eye, -eye]) * eps             # [..., 6, 3]
        geo_out = self.forward_geometry(xyz, level_mask, material=material)
        pg = self.forward_geometry(probe, level_mask, material=material)
        f = pg["sdf"] if self.cfg.use_sdf else -pg["sigma"]                   # [..., 6]
        return geo_out, (f[..., 0:3] - f[..., 3:6]) / (2.0 * eps)

    # --------------------------------------------------------------- color

    def _env_feat(self, x, env_index=0):
        """The env MLP's feature of ``x``: in sphere mode the env net
        ``env_index`` (an int or a 0-dim device tensor) of the stack."""
        if self.cfg.env_sph_mode:
            y = apply_stacked_mlp(self.env_nets, env_index, x)
        else:
            y = apply_mlp(self.env_net, x)
        return feat_act(y, self.cfg.env_feat_act)

    @contextlib.contextmanager
    def diffuse_only(self, on: bool = True):
        """While the block runs (with ``on``), the net renders the diffuse
        term alone: no roughness head, no reflected direction, no specular
        colour (``diffuse_only``, the JAX step's ``dataclasses.replace``)."""
        cfg = self.cfg
        if on:
            self.cfg = dataclasses.replace(cfg, diffuse_only=True)
        try:
            yield
        finally:
            self.cfg = cfg

    def _color_head(self, h):
        y = apply_mlp(self.color_net, h)
        return torch.sigmoid(y) if self.cfg.color_act == "sigmoid" else density_ops.trunc_exp(y)

    def forward_color(self, geo_feat, dirs, normals_enc=None, w_r_enc=None,
                      n_dot_w_o=None, *, env_index=0, n_env_enc=None, r_images=None,
                      roughness=None, blend_weight=None):
        """Diffuse + specular color of each sample; returns (color, aux).

        ``r_images`` [..., 3 or 4] is the colour (and visibility) of each
        sample's reflected ray (the indirect pass).  Under ``use_renv`` the
        specular colour is then blended with the colour head's reading of
        ``renv_net``'s feature where the roughness is below
        ``indir_roughness_thresh`` (and, with a visibility channel, the
        reflected ray hit the scene: visibility > 0.9); ``aux`` then holds
        ``renv_mask`` and ``blend``.  Under ``train_renv`` the specular
        colour is the renv branch's alone wherever ``r_images`` are given
        (network.py:588-592, 620-635); without them the env branch renders.
        ``env_index`` chooses the env net in sphere mode."""
        cfg = self.cfg
        aux: Dict[str, Any] = {}
        c_diffuse = 0.0
        if cfg.use_diffuse:
            h = geo_feat
            if cfg.diffuse_with_env:
                nenv = (feat_act(apply_mlp(self.diffuse_env_net, n_env_enc), cfg.env_feat_act)
                        if cfg.split_diffuse_env else self._env_feat(n_env_enc, env_index))
                if cfg.diffuse_env_fusion == "concat":
                    h = torch.cat([h, nenv], dim=-1)
                elif cfg.diffuse_env_fusion == "add":
                    h = h + nenv
                elif cfg.diffuse_env_fusion == "mul":
                    h = h * nenv
            y = apply_mlp(self.diffuse_net, h)
            c_diffuse = (torch.sigmoid(y) if cfg.color_act == "sigmoid"
                         else density_ops.trunc_exp(y))
        aux["c_diffuse"] = c_diffuse

        c_specular = 0.0
        if not cfg.diffuse_only:
            if not cfg.wo_viewdir:
                d_enc = encode_dir(cfg.encoding_dir, cfg.multires_dir, cfg.sh_degree, dirs)
                h = torch.cat([d_enc, geo_feat], dim=-1)
            else:
                h = geo_feat
            if cfg.normal_with_mlp:
                h = torch.cat([h, normals_enc], dim=-1)

            def head(feat):
                x = h if feat is None else torch.cat([h, feat], dim=-1)
                return self._color_head(torch.cat([x, n_dot_w_o], dim=-1)
                                        if cfg.use_n_dot_viewdir else x)

            if cfg.train_renv and r_images is not None:
                remap = torch.sqrt(torch.clamp(roughness / 0.75, min=0.0))
                c_specular = head(self._renv_feat(r_images, remap))
            else:
                c_specular = head(None if w_r_enc is None else
                                  self._env_feat(w_r_enc, env_index) if cfg.use_env_net
                                  else w_r_enc)
                if r_images is not None and cfg.use_renv:
                    c_specular = self._blend_renv(c_specular, head, r_images, roughness,
                                                  blend_weight, aux)
        aux["c_specular"] = c_specular
        return (c_diffuse + c_specular) * cfg.intensity_scale, aux

    def _renv_feat(self, r_images, remap):
        """``renv_net``'s feature of the reflected colour and the remapped
        roughness."""
        x = torch.cat([r_images[..., :3], remap], dim=-1)
        return feat_act(apply_mlp(self.renv_net, x), self.cfg.env_feat_act)

    def _blend_renv(self, c_env, head, r_images, roughness, blend_weight, aux):
        """The renv branch of ``forward_color`` (network.py:604-643), the span
        ``renv``.  It runs on every sample slot it is given, counted as
        ``renv.samples``; ``renv.open`` counts the slots its gate opens."""
        with obs.span("renv"):
            cfg = self.cfg
            renv_mask = roughness[..., 0] < cfg.indir_roughness_thresh
            if r_images.shape[-1] == 4:
                r_vis = r_images[..., 3]
                r_images = r_images[..., :3] * r_vis.detach()[..., None]
                renv_mask = renv_mask & (r_vis > 0.9)
            obs.count("renv.samples", renv_mask.numel())
            obs.count_later("renv.open", renv_mask)
            remap = torch.sqrt(torch.clamp(roughness / cfg.roughness_scale / 0.75, min=0.0))
            if cfg.learn_indir_blend and blend_weight is not None:
                blend = 0.98 * blend_weight
            else:     # the reference's roughness sigmoid (network.py:631)
                blend = 0.95 * torch.sigmoid(80.0 * (remap - 0.18))
            c_renv = head(self._renv_feat(r_images, remap))
            if cfg.indir_only:
                c_env = c_env * 0.0
            blended = c_env * blend + c_renv * (1.0 - blend)
            aux["renv_mask"] = renv_mask
            aux["blend"] = blend
            return torch.where(renv_mask[..., None], blended, c_env)

    def get_color_mlp_extra_params(self, normals, dirs, roughness=0.0, env_rot_radian=None):
        """Normal encoding, IDE of the reflected direction, n.w_o and the
        diffuse IDE of the normal (renderer.py:147-180).  ``env_rot_radian``
        (a number or a 0-dim tensor) turns the environment about the y axis:
        the reflected direction and the diffuse normal are each multiplied by
        :func:`rot_theta_mat` on the right, as the JAX package does."""
        cfg = self.cfg
        if normals is None:
            return None, None, None, None
        normals_enc = None
        if cfg.normal_with_mlp:
            normals_enc = encode_dir(cfg.encoding_dir, cfg.multires_normal,
                                     cfg.sh_degree, normals)
        w_o = -dirs
        w_r_enc = None
        if cfg.use_reflected_dir and not cfg.diffuse_only:
            w_r = reflect_dir(w_o, normals)
            if env_rot_radian is not None:
                w_r = w_r @ rot_theta_mat(env_rot_radian, w_r)
            w_r_enc = encode_dir(cfg.encoding_ref, cfg.multires_refdir, cfg.sh_degree,
                                 w_r, roughness) * cfg.light_intensity_scale
        n_dot_w_o = None
        if cfg.use_n_dot_viewdir:
            n_dot_w_o = (normals * w_o).sum(dim=-1, keepdim=True)
        n_env_enc = None
        if cfg.diffuse_with_env:
            n_rot = normals if env_rot_radian is None else normals @ rot_theta_mat(
                env_rot_radian, normals)
            deg = (cfg.sh_degree_diffuse if cfg.split_diffuse_env and cfg.sh_degree_diffuse > 0
                   else cfg.sh_degree)
            n_env_enc = encode_dir(cfg.encoding_ref, cfg.multires_refdir, deg,
                                   n_rot, cfg.diffuse_kappa_inv) * cfg.light_intensity_scale
        return normals_enc, w_r_enc, n_dot_w_o, n_env_enc

    def background_color(self, sph_coords, dirs):
        """The background net's colour (``network.py:704-714``) at
        ``sph_coords`` [N, 2] (:func:`~envidr_tpu_torch.geometry.rays.sph_from_ray`)
        seen along ``dirs`` [N, 3]."""
        h = hash_encode((sph_coords + 1.0) / 2.0, self.bg.encoder.embeddings,
                        bg_hash_spec(self.cfg))
        y = apply_mlp(self.bg.net, torch.cat([sh_encode(dirs, degree=4), h], dim=-1))
        return torch.sigmoid(y) if self.cfg.color_act == "sigmoid" else density_ops.trunc_exp(y)


def rot_theta_mat(radian, like: torch.Tensor) -> torch.Tensor:
    """The [3, 3] rotation about the y axis of ``_rot_theta_mat``
    (``network.py:696``), in ``like``'s dtype and on its device."""
    r = torch.as_tensor(radian, dtype=like.dtype, device=like.device)
    c, s = torch.cos(r), torch.sin(r)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, zero, -s]), torch.stack([zero, one, zero]),
                        torch.stack([s, zero, c])])


def material_tensor(material: dict, device) -> torch.Tensor:
    """A material dict (``roughness``, ``metallic``, ``color``: host or device
    values) as float32 [5] on ``device``: roughness, metallic, colour."""
    parts = [torch.as_tensor(material["roughness"], dtype=torch.float32, device=device).reshape(1),
             torch.as_tensor(material["metallic"], dtype=torch.float32, device=device).reshape(1),
             torch.as_tensor(np.asarray(material["color"], np.float32)[..., :3]
                             if not torch.is_tensor(material["color"])
                             else material["color"][..., :3],
                             dtype=torch.float32, device=device).reshape(3)]
    return torch.cat(parts)

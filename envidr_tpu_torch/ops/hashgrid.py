"""Multiresolution hash-grid encoder: ``rolled_tiled`` and ``hash`` indexing.

Counterpart of ``envidr_tpu/ops/hashgrid.py``.

``rolled_tiled``: each level's table is tiled (dense index mod the level
size); the 8 corner offsets become static rolls of the table, so a
corner-blocked table ``[L, S_max, 8C]`` serves each sample with one row
gather per level (:func:`build_blocked_tables`).  With ``custom_grad`` the
first- and second-order VJP are written by hand as two nested
``torch.autograd.Function``s, mirroring ``_rolled_encode`` and
``_rolled_encode_grad`` of the JAX package.  The table gradient of each order
is one scatter-add of ``[L, B, 8C]`` rows (:func:`_scatter_rows`):
``scatter_impl='mixed'`` sends it to the CUDA kernel of ``ops/scatter.py``,
``'sorted'`` to the scatter-free sort + cumsum reduction
(:func:`_sorted_segment_rows`), ``'xla'`` to one ``index_add_`` per level.
Without ``custom_grad`` autograd differentiates the plain forward.

``hash``: the reference-exact prime-XOR hashing, 8 row gathers per sample and
level (:func:`hash_grid_indices`).  As in the JAX package it takes no custom
VJP: autograd gives the gradients to any order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from envidr_tpu_torch import device_constant
from envidr_tpu_torch.ops.scatter import scatter_add_rows, scatter_add_rows_plain


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static geometry of a multiresolution hash grid (same fields and
    derived per-level geometry as the JAX package's spec)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    desired_resolution: Optional[int] = 2048
    interpolation: str = "smoothstep"   # 'smoothstep' | 'linear'
    indexing: str = "hash"              # 'hash' | 'rolled_tiled'
    table_dtype: str = "float32"        # 'bfloat16': gather from a bf16 copy
    custom_grad: bool = True            # hand-written 1st+2nd-order VJP
    scatter_impl: str = "xla"           # 'mixed': CUDA kernel; 'sorted':
                                        # sort + cumsum; 'xla': index_add_

    scale_factor: float = dataclasses.field(init=False)
    offsets: Tuple[int, ...] = dataclasses.field(init=False)
    resolutions: Tuple[int, ...] = dataclasses.field(init=False)
    scales: Tuple[float, ...] = dataclasses.field(init=False)

    def __post_init__(self):
        s = self.per_level_scale
        if self.desired_resolution is not None:
            s = float(np.exp2(np.log2(self.desired_resolution / self.base_resolution)
                              / max(self.num_levels - 1, 1)))
        object.__setattr__(self, "scale_factor", s)
        log2_s = np.log2(s)
        max_params = 2**self.log2_hashmap_size
        offsets, resolutions, scales = [], [], []
        offset = 0
        for lvl in range(self.num_levels):
            # hashencoder.cu:150-152: scale = exp2(level*S)*H - 1; res = ceil(scale)+1
            scale = float(np.exp2(lvl * log2_s) * self.base_resolution - 1.0)
            resolution = int(np.ceil(scale)) + 1
            offsets.append(offset)
            offset += min(max_params, resolution**self.input_dim)
            resolutions.append(resolution)
            scales.append(scale)
        offsets.append(offset)
        object.__setattr__(self, "offsets", tuple(offsets))
        object.__setattr__(self, "resolutions", tuple(resolutions))
        object.__setattr__(self, "scales", tuple(scales))

    @property
    def table_size(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(self.offsets[l + 1] - self.offsets[l]
                     for l in range(self.num_levels))

    @property
    def s_max(self) -> int:
        return max(self.sizes)


def init_hash_embeddings(spec: HashGridSpec, std: float = 1e-4,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-1e-4, 1e-4) table ``[table_size, C]``."""
    emb = torch.empty(spec.table_size, spec.level_dim)
    return emb.uniform_(-std, std, generator=generator)


def _corners(D: int) -> np.ndarray:
    """[2^D, D] corner offsets: bit d of corner c is its offset on axis d."""
    return np.array([[(c >> d) & 1 for d in range(D)] for c in range(2**D)], np.float32)


_CORNERS = _corners(3)                                # [8, 3] corner offsets
_PRIMES = (1, 2654435761, 805459861)                  # fast_hash, up to 3 axes
_U32 = 0xFFFFFFFF


def build_blocked_tables(embeddings: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """``[table_size, C] -> [L, S_max, 8C]`` corner-blocked stacked tables.

    Corner ``c`` of level ``l`` is the level's table rolled by the corner's
    dense offset mod the level size; autograd of the rolls is their inverse.
    """
    tables = []
    for l, (r, size) in enumerate(zip(spec.resolutions, spec.sizes)):
        tab = embeddings[spec.offsets[l]:spec.offsets[l + 1]]
        rolls = []
        for corner in range(2**spec.input_dim):
            off = sum(((corner >> d) & 1) * r**d for d in range(spec.input_dim))
            rolls.append(torch.roll(tab, -(off % size), dims=0))
        blk = torch.cat(rolls, dim=-1)                             # [S_l, 8C]
        tables.append(F.pad(blk, (0, 0, 0, spec.s_max - size)))
    out = torch.stack(tables)
    return out.to(torch.bfloat16) if spec.table_dtype == "bfloat16" else out


def _rolled_geom(spec: HashGridSpec, x: torch.Tensor, derivs: bool = True):
    """Per-level interpolation geometry, batched over levels.

    x: [B, 3] in [0, 1].  Returns base [L, B] (int64, in [0, S_l)),
    sel [L, B, 8, 3] and, with ``derivs``, dsel = d sel/dx and
    ddsel = d2 sel/dx2 (scale chain included), both [L, B, 8, 3].
    """
    dev = x.device
    scales = device_constant(spec.scales, x.dtype, dev)[:, None, None]
    res = device_constant(spec.resolutions, torch.int64, dev)[:, None]
    sizes = device_constant(spec.sizes, torch.int64, dev)[:, None]
    pos = x[None] * scales                                         # [L, B, 3]
    pg = torch.floor(pos)
    f = pos - pg
    if spec.interpolation == "smoothstep":
        s = f * f * (3.0 - 2.0 * f)
    else:
        s = f
    pgi = pg.to(torch.int64)
    # dense index mod the level size; in-bounds levels never wrap int64 and
    # hashed levels have power-of-two sizes, so this equals the JAX package's
    # wrapping uint32 arithmetic
    base = torch.remainder(pgi[..., 0] + pgi[..., 1] * res + pgi[..., 2] * res * res,
                           sizes)
    corner = device_constant(_CORNERS, torch.bool, dev)            # [8, 3]
    s4 = s[:, :, None, :]
    sel = torch.where(corner, s4, 1.0 - s4)                        # [L, B, 8, 3]
    if not derivs:
        return base, sel, None, None
    if spec.interpolation == "smoothstep":
        ds = 6.0 * f * (1.0 - f)
        dds = 6.0 - 12.0 * f
    else:
        ds = torch.ones_like(f)
        dds = torch.zeros_like(f)
    signs = device_constant(_CORNERS * 2.0 - 1.0, x.dtype, dev)
    sc = scales[..., None, :]                                      # [L, 1, 1, 1]
    dsel = signs * ds[:, :, None, :] * sc
    ddsel = signs * dds[:, :, None, :] * (sc * sc)
    return base, sel, dsel, ddsel


def _w_and_grads(sel, dsel):
    """Corner weights wc [L, B, 8], the products of the other two axes'
    factors [L, B, 8, 3], and dwc/dx [L, B, 8, 3]."""
    wc = sel[..., 0] * sel[..., 1] * sel[..., 2]
    prod_other = torch.stack([sel[..., 1] * sel[..., 2],
                              sel[..., 0] * sel[..., 2],
                              sel[..., 0] * sel[..., 1]], dim=-1)
    dwc = None if dsel is None else dsel * prod_other
    return wc, prod_other, dwc


def _gather_rows(blocked: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """``[L, S, W] x [L, B] -> [L, B, W]``: the one batched gather."""
    W = blocked.shape[-1]
    return torch.gather(blocked, 1, base[..., None].expand(-1, -1, W))


def _scatter_rows(s_max: int, base: torch.Tensor, rows: torch.Tensor,
                  spec: HashGridSpec) -> torch.Tensor:
    """``[L, B] x [L, B, 8C] -> [L, S_max, 8C]`` scatter-add (the table grad)."""
    rows = rows.float().contiguous()
    if spec.scatter_impl == "mixed":
        return scatter_add_rows(base, rows, s_max)
    if spec.scatter_impl == "sorted":
        return _sorted_segment_rows(base, rows, s_max)
    if spec.scatter_impl == "xla":
        return scatter_add_rows_plain(base, rows, s_max)
    raise ValueError(f"unknown hash_scatter_impl {spec.scatter_impl!r}")


_SORTED_CHUNK = 4096          # rows per chunk of the sorted prefix sum


def _sorted_segment_rows(base: torch.Tensor, rows: torch.Tensor, S: int) -> torch.Tensor:
    """Scatter-free scatter-add ``[L, B] x [L, B, W] -> [L, S, W]``: sort the
    rows by index, prefix-sum them, and difference the prefix at each slot's
    end (``torch.searchsorted``).

    The prefix is chunked (a within-chunk cumsum plus a compensated ``hi``/
    ``lo`` cumsum of the chunk totals), so its absolute error stays ~eps
    times a chunk's sum instead of the whole prefix's; the JAX package
    measured 4e-6 against 2.2e-3 unchunked at B = 2M (``_sorted_segment_rows``).
    """
    L, B = base.shape
    W = rows.shape[-1]
    dev = rows.device
    CS = _SORTED_CHUNK
    C = -(-B // CS)
    Bp = C * CS
    order = torch.argsort(base, dim=1, stable=True)
    keys = torch.gather(base, 1, order)
    vals = torch.gather(rows.float(), 1, order[..., None].expand(-1, -1, W))
    chunks = F.pad(vals, (0, 0, 0, Bp - B)).reshape(L, C, CS, W)
    within = chunks.cumsum(dim=2)                                  # [L, C, CS, W]
    totals = within[:, :, -1]                                      # [L, C, W]
    zero = torch.zeros((L, 1, W), dtype=torch.float32, device=dev)
    # compensated chunk prefix: hi = f32 cumsum, lo = cumsum of its per-step
    # rounding errors (the true prefix is ~ hi - lo)
    hi = torch.cat([zero, totals.cumsum(dim=1)], dim=1)            # [L, C+1, W]
    lo = torch.cat([zero, ((hi[:, 1:] - hi[:, :-1]) - totals).cumsum(dim=1)], dim=1)
    # exclusive within-chunk prefix, addressed by sorted position (0..Bp)
    exw = torch.cat([torch.zeros((L, C, 1, W), dtype=torch.float32, device=dev),
                     within[:, :, :-1]], dim=2).reshape(L, Bp, W)
    exw = torch.cat([exw, zero], dim=1)                            # [L, Bp+1, W]
    slots = torch.arange(S, dtype=keys.dtype, device=dev).expand(L, S).contiguous()
    right = torch.searchsorted(keys.contiguous(), slots, right=True)   # [L, S]

    def take(a, i):
        return torch.gather(a, 1, i[..., None].expand(-1, -1, W))

    def dshift(a):                          # a[s] - a[s-1], a[-1] := 0
        return a - torch.cat([zero, a[:, :-1]], dim=1)

    c = torch.div(right, CS, rounding_mode="floor")
    return dshift(take(hi, c)) - dshift(take(lo, c)) + dshift(take(exw, right))


def _oob(x: torch.Tensor) -> torch.Tensor:
    return ((x < 0.0) | (x > 1.0)).any(dim=-1)                     # [B]


def _rolled_encode_impl(spec: HashGridSpec, x: torch.Tensor, blocked: torch.Tensor):
    """Forward: ``(out [B, L*C], rows [L, B, 8C])``."""
    L, C = spec.num_levels, spec.level_dim
    B = x.shape[0]
    base, sel, _, _ = _rolled_geom(spec, x, derivs=False)
    wc, _, _ = _w_and_grads(sel, None)
    rows = _gather_rows(blocked, base).to(x.dtype)                 # [L, B, 8C]
    out = (wc[..., None] * rows.reshape(L, B, 8, C)).sum(dim=2)   # [L, B, C]
    out = out.masked_fill(_oob(x)[None, :, None], 0.0)
    return out.transpose(0, 1).reshape(B, L * C), rows


class EncoderGradGate:
    """Lets a caller that needs only d/dx of an encoding skip the table
    gradient of that backward pass.

    ``geometry_with_normals`` differentiates the SDF w.r.t. positions only;
    the table gradient of that pass is never consumed (JAX's compiler drops
    it as dead code), so the normals pass sets ``skip_table_grad`` and the
    encoder launches no scatter for it.
    """

    def __init__(self):
        self.skip_table_grad = False


class _RolledEncode(torch.autograd.Function):
    """``out = encode(x, blocked)``; backward is :class:`_RolledEncodeGrad`."""

    @staticmethod
    def forward(ctx, x, blocked, spec, gate):
        out, rows = _rolled_encode_impl(spec, x, blocked)
        ctx.save_for_backward(x, blocked, rows)
        ctx.spec, ctx.gate = spec, gate
        return out

    @staticmethod
    def backward(ctx, g):
        x, blocked, rows = ctx.saved_tensors
        table_grad = ctx.needs_input_grad[1] and not (
            ctx.gate is not None and ctx.gate.skip_table_grad)
        d_x, d_blocked = _RolledEncodeGrad.apply(x, blocked, g, rows, ctx.spec,
                                                 table_grad)
        return d_x, d_blocked, None, None


class _RolledEncodeGrad(torch.autograd.Function):
    """First-order backward ``(d_x, d_blocked)``, itself differentiable once
    more (the eikonal loss's second order).

    ``rows`` is a saved value of ``gather(blocked)``: its cotangent is severed
    and the table gradient of the second order is returned for ``blocked``
    directly, so nothing is counted twice.  ``d_blocked`` is None when the
    caller asked for no table gradient.
    """

    @staticmethod
    def forward(ctx, x, blocked, g, rows, spec, table_grad):
        ctx.set_materialize_grads(False)
        L, C = spec.num_levels, spec.level_dim
        B = x.shape[0]
        base, sel, dsel, _ = _rolled_geom(spec, x)
        wc, _, dwc = _w_and_grads(sel, dsel)
        oob = _oob(x)
        gl = g.reshape(B, L, C).transpose(0, 1).masked_fill(oob[None, :, None], 0.0)
        rows_c = rows.reshape(L, B, 8, C).float()
        gr = (gl[:, :, None, :] * rows_c).sum(dim=-1)               # [L, B, 8]
        d_x = (gr[..., None] * dwc).sum(dim=(0, 2)).to(x.dtype)     # [B, 3]
        d_blocked = None
        if table_grad:
            u = (wc[..., None] * gl[:, :, None, :]).reshape(L, B, 8 * C)
            d_blocked = _scatter_rows(blocked.shape[1], base, u, spec).to(blocked.dtype)
        ctx.save_for_backward(x, g, rows)
        ctx.spec, ctx.s_max, ctx.blocked_dtype = spec, blocked.shape[1], blocked.dtype
        return d_x, d_blocked

    @staticmethod
    @once_differentiable
    def backward(ctx, t_x, t_blk):
        """Cotangents ``(t_x, t_blk)`` of ``(d_x, d_blocked)`` -> grads of
        ``(x, blocked, g)``.  An absent cotangent (None) drops its branch:
        the eikonal loss uses only d_x, so ``t_blk`` is None and the
        [L, S_max, 8C] gather of it never runs."""
        x, g, rows = ctx.saved_tensors
        spec = ctx.spec
        L, C = spec.num_levels, spec.level_dim
        B = x.shape[0]
        if t_x is None and t_blk is None:
            return None, None, None, None, None, None
        base, sel, dsel, ddsel = _rolled_geom(spec, x)
        wc, prod_other, dwc = _w_and_grads(sel, dsel)
        oob = _oob(x)
        gl = g.reshape(B, L, C).transpose(0, 1).float().masked_fill(
            oob[None, :, None], 0.0)                                # [L, B, C]
        rows_c = rows.reshape(L, B, 8, C).float()
        tb_c = None
        if t_blk is not None:
            tb_c = _gather_rows(t_blk, base).float().reshape(L, B, 8, C)

        grad_g = torch.zeros_like(gl)
        grad_blocked = None
        grad_x = torch.zeros((B, 3), dtype=torch.float32, device=x.device)
        if t_x is not None:
            t_x = t_x.float().masked_fill(oob[:, None], 0.0)
            tdwc = (dwc * t_x[None, :, None, :]).sum(dim=-1)        # [L, B, 8]
            grad_g = grad_g + (tdwc[..., None] * rows_c).sum(dim=2)
            u2 = (tdwc[..., None] * gl[:, :, None, :]).reshape(L, B, 8 * C)
            grad_blocked = _scatter_rows(ctx.s_max, base, u2, spec).to(ctx.blocked_dtype)
            # d2 w / dx2 contracted with t_x, rows and g
            gr = (gl[:, :, None, :] * rows_c).sum(dim=-1)           # [L, B, 8]
            cols = []
            for dp in range(3):
                acc = 0.0
                for d in range(3):
                    if d == dp:
                        h = ddsel[..., dp] * prod_other[..., dp]
                    else:
                        h = dsel[..., d] * dsel[..., dp] * sel[..., 3 - d - dp]
                    acc = acc + (gr * h).sum(dim=(0, 2)) * t_x[:, d]
                cols.append(acc)
            grad_x = torch.stack(cols, dim=-1)
        if tb_c is not None:
            grad_g = grad_g + (wc[..., None] * tb_c).sum(dim=2)
            tbg = (tb_c * gl[:, :, None, :]).sum(dim=-1)            # [L, B, 8]
            grad_x = grad_x + (tbg[..., None] * dwc).sum(dim=(0, 2))
        grad_g = grad_g.masked_fill(oob[None, :, None], 0.0)
        grad_g = grad_g.transpose(0, 1).reshape(B, L * C).to(g.dtype)
        grad_x = grad_x.masked_fill(oob[:, None], 0.0).to(x.dtype)
        return grad_x, grad_blocked, grad_g, None, None, None


def hash_grid_indices(spec: HashGridSpec, x: torch.Tensor) -> torch.Tensor:
    """``hash`` indexing: the level-local row ``[L, B, 2^D]`` (int64, in
    ``[0, S_l)``) of each corner of each sample (``D = spec.input_dim``).

    Dense levels (``res^D <= S_l``) index row-major, hashed levels by the
    prime-XOR ``fast_hash``; the JAX package computes both in wrapping
    uint32.  Here they run in int64 (every product stays below 2^44: grid
    positions < 2^12, primes < 2^32), masked to 32 bits after the
    multiply/XOR and the sum, then reduced mod the level size: bit-equal.
    """
    dev, D = x.device, spec.input_dim
    scales = device_constant(spec.scales, x.dtype, dev)[:, None, None]
    pg = torch.floor(x[None] * scales).to(torch.int64)                # [L, B, D]
    cpos = pg[:, :, None, :] + device_constant(_corners(D), torch.int64, dev)
    res = device_constant(spec.resolutions, torch.int64, dev)[:, None, None]
    sizes = device_constant(spec.sizes, torch.int64, dev)[:, None, None]
    dense = device_constant([r**D <= s for r, s in
                             zip(spec.resolutions, spec.sizes)], torch.bool, dev)[:, None, None]
    c = cpos.unbind(-1)                                              # D x [L, B, 2^D]
    idx_dense, stride = c[0], res
    idx_hash = c[0] * _PRIMES[0]
    for d in range(1, D):
        idx_dense = idx_dense + c[d] * stride
        idx_hash = idx_hash ^ (c[d] * _PRIMES[d])
        stride = stride * res
    return torch.remainder(torch.where(dense, idx_dense & _U32, idx_hash & _U32), sizes)


def _hash_encode_impl(spec: HashGridSpec, x: torch.Tensor,
                      embeddings: torch.Tensor) -> torch.Tensor:
    """``hash`` forward ``[B, 3] -> [B, L*C]``, differentiable by autograd.

    The JAX package gathers from per-level tables padded to ``S_max``; the
    same rows are read here from the flat table at each level's offset.
    """
    L, C, D = spec.num_levels, spec.level_dim, spec.input_dim
    B = x.shape[0]
    idx = hash_grid_indices(spec, x)                                 # [L, B, 2^D]
    scales = device_constant(spec.scales, x.dtype, x.device)[:, None, None]
    pos = x[None] * scales
    f = pos - torch.floor(pos)
    w = f * f * (3.0 - 2.0 * f) if spec.interpolation == "smoothstep" else f
    corner = device_constant(_corners(D), torch.bool, x.device)      # [2^D, D]
    w4 = w[:, :, None, :]
    wsel = torch.where(corner, w4, 1.0 - w4)                         # [L, B, 2^D, D]
    weight = wsel[..., 0]
    for d in range(1, D):
        weight = weight * wsel[..., d]                               # [L, B, 2^D]
    offsets = device_constant(spec.offsets[:-1], torch.int64, x.device)[:, None, None]
    vals = embeddings.index_select(0, (idx + offsets).reshape(-1))
    vals = vals.reshape(L, B, 2**D, C).to(x.dtype)
    out = (weight[..., None] * vals).sum(dim=2)                      # [L, B, C]
    out = out.transpose(0, 1).reshape(B, L * C)
    return out.masked_fill(_oob(x)[:, None], 0.0)


def hash_encode(inputs: torch.Tensor, embeddings: torch.Tensor,
                spec: HashGridSpec, gate: Optional[EncoderGradGate] = None) -> torch.Tensor:
    """Encode inputs in [0, 1]^3 -> [..., L*C]; out-of-bound samples give 0.

    Differentiable to second order w.r.t. inputs and embeddings.  ``gate``
    applies to the hand-written ``rolled_tiled`` VJP only; autograd (the
    ``hash`` path) computes no table gradient unless asked for one.
    """
    prefix = inputs.shape[:-1]
    x = inputs.reshape(-1, spec.input_dim)
    if spec.indexing == "hash":
        out = _hash_encode_impl(spec, x, embeddings)
    elif spec.indexing == "rolled_tiled":
        blocked = build_blocked_tables(embeddings, spec)
        if spec.custom_grad:
            out = _RolledEncode.apply(x, blocked, spec, gate)
        else:
            out, _ = _rolled_encode_impl(spec, x, blocked)
    else:
        raise ValueError(f"unknown hash-grid indexing {spec.indexing!r}")
    return out.reshape(*prefix, spec.output_dim)


def hash_encode_from_world(xyz: torch.Tensor, embeddings: torch.Tensor,
                           spec: HashGridSpec, bound: float = 1.0,
                           gate: Optional[EncoderGradGate] = None) -> torch.Tensor:
    """World coords in [-bound, bound] -> [0, 1] -> encode."""
    return hash_encode((xyz + bound) / (2.0 * bound), embeddings, spec, gate)

"""CP-factorised multiresolution encoder.

Counterpart of ``envidr_tpu/ops/cp.py``.  Per level l and axis a the
features live in a 1-D table ``[R_l, rank]``; a point's feature on an axis is
the linear interpolation of two neighbouring rows, the three axis features
multiply (CP), and a per-level ``[rank, C]`` projection maps the product to
the ``[L*C]`` layout of the hash encoder.

The JAX package writes the interpolation as a dense two-hot matmul
(``formulation='twohot'``); at the train step's 262,144 points and R_l up to
2048 that matrix would hold 537M entries, so this port computes the same
numbers as a gather-lerp: only two columns of a two-hot row are non-zero.

``compute_dtype='bfloat16'`` (the default, as in the JAX package) rounds
what the JAX two-hot matmul rounds, in the forward and in every transpose
autodiff takes of it (``jax.make_jaxpr`` of its gradient shows the casts):

  * the weights: ``w1 = bf16(frac)``, ``w0 = bf16(1 - w1)`` (subtracted in
    bf16); the table rows are read as ``bf16(T)``; the two products are exact
    in f32 and summed in f32;
  * the table gradient is summed in f32 and rounded to bf16;
  * the gradient of each weight, ``g . bf16(T)``, is rounded to bf16, and the
    weights' two contributions to ``d frac`` are added in bf16.

Here each rounding is a ``.to(torch.bfloat16)`` in the autograd graph, so
autograd's backward (and its double backward, for the eikonal term) rounds
in the same places.  ``compute_dtype='float32'`` (either formulation) is the
plain f32 gather-lerp.

The two table rows of a point are read by ``ops/cp_rows.py``'s autograd
pair (on the card two CUDA kernels, a gather and its adjoint scatter; on the
CPU ``index_select`` and ``index_add_``), all ``L * 3`` tables in one
call, which is differentiable to any order; every other op has a double
backward in torch (products, casts, ``torch.where``), so the encoder is
twice differentiable.  ``floor`` carries
no gradient and ``frac = pos - i0`` carries d/dpos = 1, as in JAX.  Points
outside [0, 1]^3 encode to 0 through ``torch.where``: no boolean indexing,
nothing that blocks the host.

The rows read, ``v0`` and ``v1`` (``[L * 3, B, rank]`` f32 each, 12 KB a
point at rank 32), are what the lerp's backward needs, in the forward's graph
and in the graph the normals' double backward records.  Autograd does not
keep them: under :func:`rows_read_again` a saved row tensor is kept as what
reads it (the table, the indices), and each unpack reads the rows again, one
call of the gather for both.  The rows read again are the same numbers, so
every gradient is the one autograd computes from the kept rows, to the bit.
The rows are 12 of the ~22 KB a point that the encoder's forward kept; the
cost is a gather each time a backward reaches the lerp (three an encode in a
train step: the normals' gradient, and the step's backward through the
forward's and the double backward's nodes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from envidr_tpu_torch.ops.cp_rows import gather_pairs, row_pair


@dataclasses.dataclass(frozen=True)
class CPSpec:
    """Static geometry of the CP encoder (the JAX package's spec, same
    fields, defaults and per-level arithmetic)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2                 # C of the output, per level
    rank: int = 32                     # CP rank per level
    base_resolution: int = 16
    desired_resolution: Optional[int] = 2048
    per_level_scale: float = 2.0
    compute_dtype: str = "bfloat16"    # 'bfloat16' | 'float32'
    formulation: str = "twohot"        # 'twohot' | 'take' (equal maths here)

    resolutions: Tuple[int, ...] = dataclasses.field(init=False)
    scales: Tuple[float, ...] = dataclasses.field(init=False)

    def __post_init__(self):
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.formulation not in ("twohot", "take"):
            raise ValueError(f"formulation {self.formulation!r}")
        s = self.per_level_scale
        if self.desired_resolution is not None:
            s = float(np.exp2(
                np.log2(self.desired_resolution / self.base_resolution)
                / max(self.num_levels - 1, 1)))
        resolutions, scales = [], []
        for lvl in range(self.num_levels):
            scale = float(np.exp2(lvl * np.log2(s)) * self.base_resolution - 1.0)
            resolutions.append(int(np.ceil(scale)) + 1)
            scales.append(scale)
        object.__setattr__(self, "resolutions", tuple(resolutions))
        object.__setattr__(self, "scales", tuple(scales))

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def rounds_bf16(self) -> bool:
        """Whether the lerp rounds as the JAX bf16 two-hot matmul does
        (``take`` is f32 in the JAX package whatever the dtype)."""
        return self.compute_dtype == "bfloat16" and self.formulation == "twohot"


def init_cp_params(spec: CPSpec, std: float = 0.1,
                   generator: Optional[torch.Generator] = None):
    """``{"axes": [[Tx, Ty, Tz] per level], "proj": [P per level]}``: tables
    ``[R_l, rank]`` ~ N(0, std), projections ``[rank, C]`` ~ N(0, 1/rank)."""
    axes, proj = [], []
    for R in spec.resolutions:
        axes.append([torch.randn(R, spec.rank, generator=generator) * std
                     for _ in range(spec.input_dim)])
        proj.append(torch.randn(spec.rank, spec.level_dim, generator=generator)
                    * (1.0 / np.sqrt(spec.rank)))
    return {"axes": axes, "proj": proj}


_UPPER: dict = {}


# the _Rows that a graph still holds: none, and there is nothing to keep
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


class _Rows:
    """What reads one encode's row pair again: the stacked table (detached),
    the indices and each table's rows.  A read gathers both rows and keeps
    the one not asked for until it is asked for (autograd unpacks the two
    taps in two nodes of the lerp, one after the other)."""

    __slots__ = ("table", "i0", "rows", "spare", "__weakref__")

    def __init__(self, table: torch.Tensor, i0: torch.Tensor, rows: Tuple[int, ...]):
        self.table, self.i0, self.rows, self.spare = table, i0, rows, None
        _LIVE.add(self)

    def read(self, tap: int) -> torch.Tensor:
        if self.spare is not None and self.spare[0] == tap:
            v, self.spare = self.spare[1], None
            return v
        with torch.no_grad():
            v = gather_pairs(self.table, self.i0, self.rows)
        self.spare = (1 - tap, v[1 - tap])
        return v[tap]


class _Tap:
    """A saved row tensor as autograd keeps it under :func:`rows_read_again`."""

    __slots__ = ("rows", "tap")

    def __init__(self, rows: _Rows, tap: int):
        self.rows, self.tap = rows, tap


# the row tensors that may be kept as a _Tap, by the address of their
# storage: (a weak reference to the storage, its _Rows, which tap, shape,
# strides, offset).  A tensor is taken for one only if its storage is that
# storage object, so a stale entry can never be taken for another tensor
# that came to hold the address; an entry leaves with its storage.
_READABLE: dict = {}


def _readable(v: torch.Tensor, rows: _Rows, tap: int):
    storage = v.untyped_storage()
    key, ref = storage.data_ptr(), weakref.ref(storage)
    _READABLE[key] = (ref, rows, tap, v.shape, v.stride(), v.storage_offset())
    weakref.finalize(storage, _forget, key, ref)


def _forget(key: int, ref):
    entry = _READABLE.get(key)
    if entry is not None and entry[0] is ref:
        del _READABLE[key]


def _pack(t: torch.Tensor):
    if t.dim() == 3:
        storage = t.untyped_storage()
        entry = _READABLE.get(storage.data_ptr())
        if (entry is not None and entry[0]() is storage and entry[3] == t.shape
                and entry[4] == t.stride() and entry[5] == t.storage_offset()):
            return _Tap(entry[1], entry[2])
    return t


def _unpack(saved):
    if isinstance(saved, _Tap):
        v = saved.rows.read(saved.tap)
        _readable(v, saved.rows, saved.tap)      # the double backward saves it again
        return v
    return saved


def rows_read_again():
    """Saved-tensor hooks under which autograd keeps the encoder's row
    tensors (and the copies unpacked from them) as what reads them again,
    and every other tensor as it is.  :func:`cp_encode` saves its lerp under
    them; a caller that records a double backward through the encoder
    (``create_graph``) records it under them too.  While no graph holds an
    encode's rows (another encoder), it sets no hooks at all."""
    if not _LIVE:
        return contextlib.nullcontext()
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


def _upper_rows(spec: CPSpec, device) -> torch.Tensor:
    """``R_l - 2`` of each level as ``[L, 1, 1]`` f32 on ``device``, made
    once a spec and device: the last row a lerp may start at."""
    key = (spec, device)
    if key not in _UPPER:
        _UPPER[key] = torch.tensor([float(R - 2) for R in spec.resolutions],
                                   device=device).view(-1, 1, 1)
    return _UPPER[key]


def cp_encode(inputs: torch.Tensor, params, spec: CPSpec) -> torch.Tensor:
    """Encode inputs in [0, 1]^3 -> [..., L*C].  Out-of-bounds -> 0.

    Every level and axis at once: positions, rows and weights as ``[L, A,
    B]`` tensors, the ``L * A`` tables stacked and read by one call of the
    row pair (one launch a table), the lerp and the axes' product on ``[L,
    A, B, rank]``.  Each element is computed as a loop over levels and axes
    would compute it, and each level's position is its own product of the
    inputs with its scale, so that the inputs' gradient sums the levels in
    the order that loop's gradient did.  ``bf16`` rounds as the module
    docstring says; the lerp's saved rows are read again when unpacked
    (module docstring)."""
    prefix = inputs.shape[:-1]
    x = inputs.reshape(-1, spec.input_dim)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)
    L, A = spec.num_levels, spec.input_dim
    # [A, B] by a stack of the columns, not a transpose: the inputs' gradient
    # then comes back [B, A] contiguous, as the inputs are
    xt = torch.stack(x.unbind(-1))
    pos = torch.stack([xt * scale for scale in spec.scales])               # [L, A, B]
    i0f = torch.minimum(torch.clamp(torch.floor(pos.detach()), min=0.0),
                        _upper_rows(spec, x.device))
    frac = pos - i0f
    table = torch.cat([t for level in params["axes"] for t in level])      # [sum R, rank]
    if spec.rounds_bf16:
        w1 = frac.to(torch.bfloat16)
        w0 = (1.0 - w1).float()
        w1 = w1.float()
        table = table.to(torch.bfloat16).float()
    else:
        w0, w1 = 1.0 - frac, frac
    rows = tuple(R for R in spec.resolutions for _ in range(A))
    i0 = i0f.long().reshape(L * A, -1)
    v0, v1 = row_pair(table, i0, rows)                                       # [L*A, B, rank]
    again = _Rows(table.detach(), i0, rows)
    _readable(v0, again, 0)
    _readable(v1, again, 1)
    with rows_read_again():
        f = w0.reshape(L * A, -1, 1) * v0 + w1.reshape(L * A, -1, 1) * v1
    del v0, v1
    f = f.view(L, A, -1, spec.rank)
    # unbind, not indexing: a select's backward writes its gradient into a
    # zero tensor of the whole input, one such tensor a slice
    axes = f.unbind(1)
    prod = axes[0]
    for fa in axes[1:]:
        prod = prod * fa                                                   # [L, B, rank]
    out = torch.cat([p @ w for p, w in zip(prod.unbind(0), params["proj"])], dim=-1)
    out = torch.where(oob, torch.zeros((), device=out.device, dtype=out.dtype), out)
    return out.reshape(*prefix, spec.output_dim)


def cp_encode_from_world(xyz: torch.Tensor, params, spec: CPSpec,
                         bound: float = 1.0) -> torch.Tensor:
    return cp_encode((xyz + bound) / (2.0 * bound), params, spec)

"""The CP tables' two-tap row pair: a gather and its adjoint scatter, CUDA
kernels + plain versions, and the autograd pair built on them.

``ops/cp.py:cp_encode`` reads two neighbouring rows of a 1-D table for each
point, ``v0 = T[i0]`` and ``v1 = T[i0 + 1]``; the table gradient is the
adjoint, ``dT[i0] += dv0`` and ``dT[i0 + 1] += dv1``.

* :func:`gather_pair` ``(T [R, rank], i0 [N] i64) -> (v0, v1)``, each
  ``[N, rank]``;
* :func:`scatter_pair` ``(dv0, dv1, i0, R) -> dT [R, rank]``, either
  gradient ``None`` (a tap with no gradient);
* :func:`gather_pairs` ``(T [sum(rows), rank], i0 [S, N], rows) -> (v0,
  v1)``, each ``[S, N, rank]``, and :func:`scatter_pairs` ``(dv0, dv1, i0,
  rows) -> dT [sum(rows), rank]``: the same on S tables stacked one after
  another (``rows[s]`` rows each, ``i0[s]`` indexing table ``s``), one
  launch a table, so that the CP encoder reads all its tables in one call;
* :class:`CPRowGather` and :class:`CPRowScatter`: autograd Functions whose
  backward is the other one, on one table (``rows`` an int) or on stacked
  ones (a tuple).  Both are linear in their float inputs, so the
  pair is differentiable to any order (the eikonal term's double backward
  reaches ``CPRowScatter``; its backward is ``CPRowGather`` again).

The kernels take f32 (the encoder's dtype in both compute dtypes: the bf16
one rounds the table to bf16 and widens it back before the gather); the
plain versions any float dtype (the tests' f64 gradchecks).

Both kernels are ``csrc/cp_rows.cu``, one launch a call (the scatter after
one memset), each in a span of the entry point's name (``cp_rows.gather``,
``cp_rows.scatter``, tagged with the table's rows) and counted as
``launches.<symbol>``.  The scatter sums each run of repeated indices in
registers before it adds, into a block-private shared-memory copy of the
table where the table fits one, else into device memory; the counters ``cp_rows.scatter.shared`` and
``cp_rows.scatter.global`` say which path each launch took.  Its sums run in
another f32 order than ``index_add_``'s (whose atomics leave the order free
on the card as well).

A CUDA tensor always takes the kernel and raises if the build or the launch
fails.  A CPU tensor takes the plain version, the expressions the encoder
used before the pair: ``index_select``, and ``index_add_`` into zeros per tap, the
two taps' tables added, which is what autograd made of the two
``index_select``s.  No check reads a tensor's values, so nothing blocks the
host.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from envidr_tpu_torch import obs
from envidr_tpu_torch.ops._cuda import CudaLibrary, launch, on_card

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "cp_rows.cu"
GATHER = CudaLibrary(SOURCE, "cp_rows_gather_launch",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
SCATTER = CudaLibrary(SOURCE, "cp_rows_scatter_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2)
_INT32_MAX = 2**31 - 1


def _check_index(name: str, i0: torch.Tensor, rows: int):
    if i0.dim() != 1:
        raise ValueError(f"{name}: expected i0 [N], got {tuple(i0.shape)}")
    if i0.dtype != torch.int64:
        raise TypeError(f"{name}: i0 must be int64, got {i0.dtype}")
    if rows < 2:
        raise ValueError(f"{name}: a table of {rows} rows has no row pair")


def _check_card(name: str, n: int, rows: int, rank: int, *floats: torch.Tensor):
    """What the kernels take beyond the plain versions: f32 only, 16-byte
    rows, 32-bit offsets."""
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if rank <= 0 or rank % 4:
        raise ValueError(f"{name}: rank {rank} is not a positive multiple of 4 "
                         "(16-byte rows)")
    if n * rank > _INT32_MAX or rows * rank > _INT32_MAX:
        raise ValueError(f"{name}: {n} x {rank} and {rows} x {rank} exceed the "
                         "kernel's 32-bit offsets")


def gather_pair_plain(table: torch.Tensor, i0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: two ``index_select``s."""
    return table.index_select(0, i0), table.index_select(0, i0 + 1)


def gather_pair(table: torch.Tensor, i0: torch.Tensor,
                out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T[i0], T[i0 + 1])`` of a ``[R, rank]`` table and ``[N]`` int64
    indices in ``[0, R - 2]`` (not checked: the kernel clamps into it, the
    plain version raises outside ``[0, R - 1)``), written into ``out``, two
    contiguous ``[N, rank]`` tensors, where it is given."""
    if table.dim() != 2:
        raise ValueError(f"gather_pair: expected table [R, rank], got {tuple(table.shape)}")
    if not table.is_floating_point():
        raise TypeError(f"gather_pair: the table must be floating point, got {table.dtype}")
    R, rank = table.shape
    _check_index("gather_pair", i0, R)
    if not on_card("gather_pair", table, i0):
        if out is None:
            return gather_pair_plain(table, i0)
        torch.index_select(table, 0, i0, out=out[0])
        torch.index_select(table, 0, i0 + 1, out=out[1])
        return out
    N = i0.shape[0]
    _check_card("gather_pair", N, R, rank, table)
    table, i0 = table.contiguous(), i0.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("gather_pair: the table is not 16-byte aligned (16-byte loads)")
    if out is None:
        v0 = torch.empty((N, rank), dtype=torch.float32, device=table.device)
        v1 = torch.empty_like(v0)
    else:
        v0, v1 = out
    with obs.span("cp_rows.gather", tag=R):
        launch(GATHER, "cp_rows.gather", table.device, table.data_ptr(), i0.data_ptr(),
               v0.data_ptr(), v1.data_ptr(), N, R, rank)
    return v0, v1


def scatter_pair_plain(dv0: Optional[torch.Tensor], dv1: Optional[torch.Tensor],
                       i0: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain PyTorch version: per tap ``index_add_`` into zeros, the taps'
    tables added (autograd's backward of two ``index_select``s)."""
    taps = [torch.zeros((rows, dv.shape[1]), dtype=dv.dtype, device=dv.device)
            .index_add_(0, idx, dv) for dv, idx in ((dv0, i0), (dv1, i0 + 1)) if dv is not None]
    return taps[0] if len(taps) == 1 else taps[0] + taps[1]


def _check_grad(name: str, dv: Optional[torch.Tensor], n: int):
    if dv is None:
        return
    if dv.dim() != 2 or dv.shape[0] != n:
        raise ValueError(f"{name}: expected a gradient [{n}, rank], got {tuple(dv.shape)}")
    if not dv.is_floating_point():
        raise TypeError(f"{name}: gradients must be floating point, got {dv.dtype}")


def scatter_pair(dv0: Optional[torch.Tensor], dv1: Optional[torch.Tensor],
                 i0: torch.Tensor, rows: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dT [rows, rank]`` with ``dT[i0] += dv0`` and ``dT[i0 + 1] +=
    dv1``; either gradient may be ``None`` (it adds nothing), not both.
    Written into ``out``, a contiguous ``[rows, rank]`` tensor, where it is
    given."""
    _check_index("scatter_pair", i0, rows)
    N = i0.shape[0]
    _check_grad("scatter_pair", dv0, N)
    _check_grad("scatter_pair", dv1, N)
    given = [dv for dv in (dv0, dv1) if dv is not None]
    if not given:
        raise ValueError("scatter_pair: both gradients are None")
    if len(given) == 2 and (dv0.shape, dv0.dtype) != (dv1.shape, dv1.dtype):
        raise ValueError(f"scatter_pair: gradients {tuple(dv0.shape)} {dv0.dtype} and "
                         f"{tuple(dv1.shape)} {dv1.dtype}")
    rank = given[0].shape[1]
    if not on_card("scatter_pair", i0, *given):
        plain = scatter_pair_plain(dv0, dv1, i0, rows)
        return plain if out is None else out.copy_(plain)
    _check_card("scatter_pair", N, rows, rank, *given)
    i0 = i0.contiguous()
    dv0, dv1 = (None if dv is None else dv.contiguous() for dv in (dv0, dv1))
    if out is None:
        out = torch.empty((rows, rank), dtype=torch.float32, device=i0.device)
    took_shared = ctypes.c_int32(-1)
    with obs.span("cp_rows.scatter", tag=rows):
        launch(SCATTER, "cp_rows.scatter", i0.device,
               None if dv0 is None else dv0.data_ptr(), None if dv1 is None else dv1.data_ptr(),
               i0.data_ptr(), out.data_ptr(), N, rows, rank, ctypes.addressof(took_shared))
    obs.count("cp_rows.scatter.shared" if took_shared.value == 1 else "cp_rows.scatter.global")
    return out


def _check_stacked(name: str, i0: torch.Tensor, rows: Tuple[int, ...], total: int):
    if i0.dim() != 2 or i0.shape[0] != len(rows):
        raise ValueError(f"{name}: expected i0 [{len(rows)}, N], got {tuple(i0.shape)}")
    if sum(rows) != total:
        raise ValueError(f"{name}: tables of {sum(rows)} rows stacked, given {total}")


def gather_pairs(table: torch.Tensor, i0: torch.Tensor,
                 rows: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gather_pair` of each of S tables stacked in ``table``
    (``rows[s]`` rows each, in order) at its indices ``i0[s]``: ``[S, N,
    rank]`` each, one launch a table."""
    _check_stacked("gather_pairs", i0, rows, table.shape[0])
    dtype = torch.float32 if table.is_cuda else table.dtype
    v0 = torch.empty((len(rows), i0.shape[1], table.shape[1]), dtype=dtype, device=table.device)
    v1 = torch.empty_like(v0)
    start = 0
    for s, R in enumerate(rows):
        gather_pair(table[start:start + R], i0[s], out=(v0[s], v1[s]))
        start += R
    return v0, v1


def scatter_pairs(dv0: Optional[torch.Tensor], dv1: Optional[torch.Tensor], i0: torch.Tensor,
                  rows: Tuple[int, ...]) -> torch.Tensor:
    """The adjoint of :func:`gather_pairs`: ``dT [sum(rows), rank]``, each
    table's rows :func:`scatter_pair` of its ``[N, rank]`` slices of ``dv0``
    and ``dv1`` (``[S, N, rank]``, either ``None``), one launch a table."""
    given = [dv for dv in (dv0, dv1) if dv is not None]
    if not given:
        raise ValueError("scatter_pairs: both gradients are None")
    _check_stacked("scatter_pairs", i0, rows, sum(rows))
    dtype = torch.float32 if given[0].is_cuda else given[0].dtype
    out = torch.empty((sum(rows), given[0].shape[-1]), dtype=dtype, device=given[0].device)
    start = 0
    for s, R in enumerate(rows):
        scatter_pair(None if dv0 is None else dv0[s], None if dv1 is None else dv1[s], i0[s], R,
                     out=out[start:start + R])
        start += R
    return out


def _gather(table, i0, rows):
    return gather_pair(table, i0) if isinstance(rows, int) else gather_pairs(table, i0, rows)


def _scatter(dv0, dv1, i0, rows):
    return (scatter_pair(dv0, dv1, i0, rows) if isinstance(rows, int)
            else scatter_pairs(dv0, dv1, i0, rows))


class CPRowGather(torch.autograd.Function):
    """``(T, i0, rows) -> (T[i0], T[i0 + 1])``, of one table (``rows``
    ``None``) or of stacked ones (``rows`` a tuple, :func:`gather_pairs`);
    backward :class:`CPRowScatter`."""

    @staticmethod
    def forward(ctx, table, i0, rows=None):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(i0)
        ctx.rows = table.shape[0] if rows is None else tuple(rows)
        return _gather(table, i0, ctx.rows)

    @staticmethod
    def backward(ctx, dv0, dv1):
        if not ctx.needs_input_grad[0] or (dv0 is None and dv1 is None):
            return None, None, None
        (i0,) = ctx.saved_tensors
        return CPRowScatter.apply(dv0, dv1, i0, ctx.rows), None, None


class CPRowScatter(torch.autograd.Function):
    """``(dv0, dv1, i0, rows) -> dT`` (``rows`` an int, or a tuple for
    stacked tables); backward :class:`CPRowGather`."""

    @staticmethod
    def forward(ctx, dv0, dv1, i0, rows):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(i0)
        ctx.rows = rows
        return _scatter(dv0, dv1, i0, rows)

    @staticmethod
    def backward(ctx, d_table):
        if d_table is None or not any(ctx.needs_input_grad[:2]):
            return None, None, None, None
        (i0,) = ctx.saved_tensors
        g0, g1 = CPRowGather.apply(d_table, i0,
                                   None if isinstance(ctx.rows, int) else ctx.rows)
        return (g0 if ctx.needs_input_grad[0] else None,
                g1 if ctx.needs_input_grad[1] else None, None, None)


def row_pair(table: torch.Tensor, i0: torch.Tensor,
             rows: Optional[Tuple[int, ...]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T[i0], T[i0 + 1])`` through the autograd pair: of one table, or
    of the tables of ``rows`` stacked in ``table`` (``i0 [S, N]``)."""
    return CPRowGather.apply(table, i0, rows)

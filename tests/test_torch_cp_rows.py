"""The CP tables' row pair (envidr_tpu_torch/ops/cp_rows.py): the plain
versions against ``index_select`` / ``index_add_``, the autograd pair's
first and second order, the CP encoder through the pair against the
expressions it replaced, the wrappers' checks, and, on a card, the kernels
against the plain versions at the CP train step's shapes."""

import numpy as np
import pytest
import torch

from envidr_tpu_torch import obs
from envidr_tpu_torch.ops import _cuda, cp_rows
from envidr_tpu_torch.ops import cp as tcp
from envidr_tpu_torch.tools import cp_rows_cases

R, RANK = 9, 8


def _index(n=40, rows=R, seed=0):
    """A run of one repeated row, both end rows (0 and rows - 1 through
    i0 = rows - 2), and uniform rows."""
    g = torch.Generator().manual_seed(seed)
    run = torch.full((12,), 3, dtype=torch.int64)
    ends = torch.tensor([0, rows - 2, 0, rows - 2], dtype=torch.int64)
    rest = torch.randint(0, rows - 1, (n - 16,), generator=g)
    return torch.cat([rest[:8], run, ends, rest[8:]])


def _randn(*shape, dtype=torch.float32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).to(dtype)


def test_plain_pair_equals_index_select_and_its_backward():
    table = _randn(R, RANK).requires_grad_(True)
    i0 = _index()
    dv0, dv1 = _randn(len(i0), RANK, seed=2), _randn(len(i0), RANK, seed=3)
    v0, v1 = table.index_select(0, i0), table.index_select(0, i0 + 1)
    (want,) = torch.autograd.grad((v0 * dv0).sum() + (v1 * dv1).sum(), table)
    p0, p1 = cp_rows.gather_pair_plain(table.detach(), i0)
    assert torch.equal(p0, v0) and torch.equal(p1, v1)
    assert torch.equal(cp_rows.scatter_pair_plain(dv0, dv1, i0, R), want)
    # the CPU entry points and the autograd pair take the plain versions
    before = dict(_cuda.launch_counts())
    g0, g1 = cp_rows.row_pair(table, i0)
    (got,) = torch.autograd.grad((g0 * dv0).sum() + (g1 * dv1).sum(), table)
    assert torch.equal(g0, v0) and torch.equal(g1, v1) and torch.equal(got, want)
    assert _cuda.launch_counts() == before


@pytest.mark.parametrize("taps", ["both", "first", "second"])
def test_pair_gradcheck_and_gradgradcheck(taps):
    table = _randn(R, RANK, dtype=torch.float64).requires_grad_(True)
    i0 = _index(n=24)

    def gather(t):
        v0, v1 = cp_rows.CPRowGather.apply(t, i0)
        return {"both": (v0, v1), "first": v0, "second": v1}[taps]

    assert torch.autograd.gradcheck(gather, (table,))
    assert torch.autograd.gradgradcheck(gather, (table,))
    dv0 = _randn(len(i0), RANK, dtype=torch.float64, seed=2).requires_grad_(True)
    dv1 = _randn(len(i0), RANK, dtype=torch.float64, seed=3).requires_grad_(True)
    given = {"both": (dv0, dv1), "first": (dv0, None), "second": (None, dv1)}[taps]
    inputs = tuple(d for d in given if d is not None)

    def scatter(*ds):
        it = iter(ds)
        return cp_rows.CPRowScatter.apply(*(None if d is None else next(it) for d in given),
                                          i0, R)

    assert torch.autograd.gradcheck(scatter, inputs)
    assert torch.autograd.gradgradcheck(scatter, inputs)


def test_pair_is_each_others_adjoint():
    """<gather(T), dv> == <T, scatter(dv)>, in f64."""
    table = _randn(R, RANK, dtype=torch.float64)
    i0 = _index()
    dv0 = _randn(len(i0), RANK, dtype=torch.float64, seed=2)
    dv1 = _randn(len(i0), RANK, dtype=torch.float64, seed=3)
    v0, v1 = cp_rows.gather_pair(table, i0)
    lhs = float((v0 * dv0).sum() + (v1 * dv1).sum())
    rhs = float((table * cp_rows.scatter_pair(dv0, dv1, i0, R)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


SMALL = dict(num_levels=4, level_dim=2, rank=8, base_resolution=4, desired_resolution=32)
VARIANTS = [("float32", "twohot"), ("float32", "take"), ("bfloat16", "twohot"),
            ("bfloat16", "take")]


def _index_select_pair(table, i0):
    return table.index_select(0, i0), table.index_select(0, i0 + 1)


def _encoder_readings(spec, params, x, w, cot):
    """The forward, the first-order gradients of every leaf and x, and the
    eikonal pattern's mixed term: grads of a loss of d(encoding . w)/dx."""
    leaves = [*[a for lvl in params["axes"] for a in lvl], *params["proj"]]
    xx = x.clone().requires_grad_(True)
    out = tcp.cp_encode(xx, params, spec)
    first = torch.autograd.grad((out * cot).sum(), [*leaves, xx])
    xx = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((tcp.cp_encode(xx, params, spec) @ w).sum(), xx,
                                create_graph=True)
    second = torch.autograd.grad((gx ** 2).sum(), [*leaves, xx])
    return [out.detach(), *first, *second]


@pytest.mark.parametrize("dtype,form", VARIANTS)
def test_cp_encode_through_the_pair_equals_index_select(dtype, form, monkeypatch):
    spec = tcp.CPSpec(**SMALL, compute_dtype=dtype, formulation=form)
    g = torch.Generator().manual_seed(0)
    params = tcp.init_cp_params(spec, generator=g)
    params = {"axes": [[a.requires_grad_(True) for a in lvl] for lvl in params["axes"]],
              "proj": [p.requires_grad_(True) for p in params["proj"]]}
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (256, 3)).astype(np.float32))
    x[:64] = 0.5                                  # empty slots: one point, one row pair
    w = torch.from_numpy(rng.standard_normal(spec.output_dim).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((256, spec.output_dim)).astype(np.float32))
    ours = _encoder_readings(spec, params, x, w, cot)
    monkeypatch.setattr(tcp, "row_pair", _index_select_pair)
    before = _encoder_readings(spec, params, x, w, cot)
    assert len(ours) == len(before)
    for a, b in zip(ours, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["i0_int32", "i0_float", "i0_2d", "table_int", "table_1d",
                                 "grad_rows", "grad_dtypes", "no_grads", "one_row",
                                 "mixed_gather", "mixed_scatter"])
def test_wrappers_reject_bad_input(bad):
    table, i0 = _randn(R, RANK), _index()
    dv = _randn(len(i0), RANK)
    meta = torch.empty(len(i0), dtype=torch.int64, device="meta")
    call = {
        "i0_int32": lambda: cp_rows.gather_pair(table, i0.int()),
        "i0_float": lambda: cp_rows.scatter_pair(dv, dv, i0.float(), R),
        "i0_2d": lambda: cp_rows.gather_pair(table, i0[None]),
        "table_int": lambda: cp_rows.gather_pair(table.long(), i0),
        "table_1d": lambda: cp_rows.gather_pair(table[0], i0),
        "grad_rows": lambda: cp_rows.scatter_pair(dv[1:], None, i0, R),
        "grad_dtypes": lambda: cp_rows.scatter_pair(dv, dv.double(), i0, R),
        "no_grads": lambda: cp_rows.scatter_pair(None, None, i0, R),
        "one_row": lambda: cp_rows.gather_pair(table[:1], torch.zeros_like(i0)),
        "mixed_gather": lambda: cp_rows.gather_pair(table, meta),
        "mixed_scatter": lambda: cp_rows.scatter_pair(dv, None, meta, R),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        call()


def test_cpu_pair_records_no_span_and_no_path_counter():
    table, i0 = _randn(R, RANK, dtype=torch.float64).requires_grad_(True), _index()
    counters = dict(obs.COUNTERS)
    with obs.recording():
        with obs.span("root"):
            v0, v1 = cp_rows.row_pair(table, i0)
            (v0.sum() + v1.sum()).backward()
    names = {s.name for s in obs.snapshot().spans}
    assert names == {"root"}
    assert {k: v for k, v in obs.COUNTERS.items() if k.startswith("cp_rows")} == \
        {k: v for k, v in counters.items() if k.startswith("cp_rows")}


def test_step_indices_pattern():
    i0 = cp_rows_cases.step_indices(213, n=64 * 32, generator=torch.Generator().manual_seed(0))
    per_ray = i0.reshape(-1, 32)
    assert int(i0.min()) >= 0 and int(i0.max()) <= 211
    assert (per_ray[:, 4:] == 106).all()
    assert float((i0 == 106).double().mean()) >= 28 / 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", cp_rows_cases.ROWS)
def test_kernels_match_plain_on_card(cuda_device, rows):
    """At the train step's shapes.  The gather copies: equal.  The scatter
    sums in another f32 order than index_add_ (registers along a run, then
    shared or device atomics): each element within 2^-20 of its row's sum
    of magnitudes (16 f32 ulps of it; any order of n adds is within
    n 2^-24 of it) of the f64 sum, as index_add_ on the card is."""
    g = torch.Generator().manual_seed(rows)
    n, rank = cp_rows_cases.N, cp_rows_cases.RANK
    i0 = cp_rows_cases.step_indices(rows, generator=g, device=cuda_device)
    table = torch.randn(rows, rank, generator=g).to(cuda_device)
    dv0 = torch.randn(n, rank, generator=g).to(cuda_device)
    dv1 = torch.randn(n, rank, generator=g).to(cuda_device)
    launches = cp_rows.GATHER.launches, cp_rows.SCATTER.launches
    path = "shared" if rows * rank * 4 <= 227 * 1024 else "global"
    counted = obs.COUNTERS.get(f"cp_rows.scatter.{path}", 0)
    v0, v1 = cp_rows.gather_pair(table, i0)
    out = cp_rows.scatter_pair(dv0, dv1, i0, rows)
    only0 = cp_rows.scatter_pair(dv0, None, i0, rows)
    torch.cuda.synchronize()
    assert (cp_rows.GATHER.launches, cp_rows.SCATTER.launches) == \
        (launches[0] + 1, launches[1] + 2)
    assert obs.COUNTERS.get(f"cp_rows.scatter.{path}", 0) == counted + 2
    p0, p1 = cp_rows.gather_pair_plain(table, i0)
    assert torch.equal(v0, p0) and torch.equal(v1, p1)
    for got, taps in ((out, (dv0, dv1)), (only0, (dv0, None))):
        exact = cp_rows.scatter_pair_plain(*(None if d is None else d.double() for d in taps),
                                           i0, rows)
        mags = cp_rows.scatter_pair_plain(*(None if d is None else d.double().abs()
                                            for d in taps), i0, rows)
        tol = 2.0**-20 * mags
        plain = cp_rows.scatter_pair_plain(*taps, i0, rows)
        assert bool(((plain.double() - exact).abs() <= tol).all())
        assert bool(((got.double() - exact).abs() <= tol).all())

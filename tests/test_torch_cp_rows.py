"""The CP tables' row pair (envidr_tpu_torch/ops/cp_rows.py): the plain
versions against ``index_select`` / ``index_add_``, the autograd pair's
first and second order, the CP encoder through the pair against the
expressions it replaced, the wrappers' checks, and, on a card, the kernels
against the plain versions at the CP train step's shapes."""

import contextlib
import gc

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


def _index_select_pair(table, i0, rows):
    """The stacked tables' rows read table by table with ``index_select``."""
    starts = np.cumsum((0,) + rows[:-1])
    return tuple(torch.stack([table[o:o + R].index_select(0, i + k)
                              for o, R, i in zip(starts, rows, i0)]) for k in (0, 1))


def _loop_encode(inputs, params, spec):
    """The encoder as a loop over levels and axes, one table at a time (the
    form ``cp_encode`` had before it read every table in one call)."""
    x = inputs.reshape(-1, spec.input_dim)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)
    feats = []
    for lvl in range(spec.num_levels):
        R, scale = spec.resolutions[lvl], spec.scales[lvl]
        prod = None
        for a in range(spec.input_dim):
            pos, table = x[:, a] * scale, params["axes"][lvl][a]
            i0f = torch.clamp(torch.floor(pos.detach()), 0, R - 2)
            frac = pos - i0f
            if spec.rounds_bf16:
                w1 = frac.to(torch.bfloat16)
                w0 = (1.0 - w1).float()
                w1 = w1.float()
                table = table.to(torch.bfloat16).float()
            else:
                w0, w1 = 1.0 - frac, frac
            v0, v1 = cp_rows.row_pair(table, i0f.long())
            f = w0[:, None] * v0 + w1[:, None] * v1
            prod = f if prod is None else prod * f
        feats.append(prod @ params["proj"][lvl])
    out = torch.where(oob, torch.zeros(()), torch.cat(feats, dim=-1))
    return out.reshape(*inputs.shape[:-1], spec.output_dim)


def _encoder_readings(spec, params, x, w, cot, encode=None):
    """The forward, the first-order gradients of every leaf and x, and the
    eikonal pattern's mixed term: grads of a loss of d(encoding . w)/dx."""
    leaves = [*[a for lvl in params["axes"] for a in lvl], *params["proj"]]
    encode = encode or tcp.cp_encode
    xx = x.clone().requires_grad_(True)
    out = encode(xx, params, spec)
    first = torch.autograd.grad((out * cot).sum(), [*leaves, xx])
    xx = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((encode(xx, params, spec) @ w).sum(), xx,
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


def _encoder_case(dtype, form):
    spec = tcp.CPSpec(**SMALL, compute_dtype=dtype, formulation=form)
    g = torch.Generator().manual_seed(0)
    params = tcp.init_cp_params(spec, generator=g)
    params = {"axes": [[a.requires_grad_(True) for a in lvl] for lvl in params["axes"]],
              "proj": [p.requires_grad_(True) for p in params["proj"]]}
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-0.05, 1.05, (256, 3)).astype(np.float32))
    x[:64] = 0.5                                  # empty slots: one point, one row pair
    w = torch.from_numpy(rng.standard_normal(spec.output_dim).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((256, spec.output_dim)).astype(np.float32))
    return spec, params, x, w, cot


@pytest.mark.parametrize("dtype,form", VARIANTS)
def test_encode_equals_the_loop_over_tables(dtype, form):
    """Every table in one call of the pair computes, bit for bit, what the
    loop over levels and axes computed: the forward, every first-order
    gradient and the eikonal pattern's mixed term, out-of-bounds points
    included; the inputs' gradient in the inputs' layout, as the loop gave
    it (a reduction over it downstream sums in the same order)."""
    spec, params, x, w, cot = _encoder_case(dtype, form)
    ours = _encoder_readings(spec, params, x, w, cot)
    loop = _encoder_readings(spec, params, x, w, cot, encode=_loop_encode)
    assert len(ours) == len(loop)
    for a, b in zip(ours, loop):
        assert torch.equal(a, b) and a.stride() == b.stride()


def _eikonal_step(spec, params, x, w, cot, monkeypatch, keep_rows):
    """The train step's pattern on the encoder, every save seen: the normals'
    gradient recorded under ``rows_read_again`` (a no-op with
    ``keep_rows``), then one backward of the colour-like and eikonal-like
    terms into every leaf and x.  Returns (the storages autograd kept as
    tensors, the gradients, the rows' gathers)."""
    kept, gathers = {}, [0]

    def keep(t):
        st = t.untyped_storage()
        kept[id(st)] = st
        return t

    inner, read = tcp._pack, tcp._Rows.read

    def pack(t):
        out = inner(t)
        return keep(t) if out is t else out

    def counted(self, tap):
        gathers[0] += not (self.spare is not None and self.spare[0] == tap)
        return read(self, tap)

    monkeypatch.setattr(tcp, "_pack", pack)
    monkeypatch.setattr(tcp._Rows, "read", counted)
    if keep_rows:
        monkeypatch.setattr(tcp, "rows_read_again", contextlib.nullcontext)
    leaves = [*[a for lvl in params["axes"] for a in lvl], *params["proj"]]
    with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
        xx = x.clone().requires_grad_(True)
        out = tcp.cp_encode(xx, params, spec)
        with tcp.rows_read_again():
            (gx,) = torch.autograd.grad((out @ w).sum(), xx, create_graph=True)
        grads = torch.autograd.grad((gx ** 2).sum() + (out * cot).sum(), [*leaves, xx])
    monkeypatch.undo()
    return kept, grads, gathers[0]


@pytest.mark.parametrize("dtype,form", VARIANTS)
def test_encode_keeps_no_rows_and_reads_them_again(dtype, form, monkeypatch):
    """Autograd keeps neither row tensor of the encode, in the forward's
    graph or in the one the normals' double backward records: the bytes it
    keeps fall by exactly both rows' bytes against the same step with the
    rows kept, every gradient of the step stays bit for bit, and the rows
    are gathered once for the normals and twice for the step's backward."""
    spec, params, x, w, cot = _encoder_case(dtype, form)
    kept, grads, gathers = _eikonal_step(spec, params, x, w, cot, monkeypatch, False)
    kept_rows, grads_rows, none = _eikonal_step(spec, params, x, w, cot, monkeypatch, True)
    row_bytes = spec.num_levels * spec.input_dim * x.shape[0] * spec.rank * 4
    assert sum(s.nbytes() for s in kept_rows.values()) - \
        sum(s.nbytes() for s in kept.values()) == 2 * row_bytes
    assert (gathers, none) == (3, 0)
    for a, b in zip(grads, grads_rows):
        assert torch.equal(a, b)


def test_a_freed_row_tensor_is_never_taken_for_another():
    """A tensor that comes to hold a freed row tensor's address, with its
    shape, is saved as itself."""
    rows = tcp._Rows(torch.zeros(3, 2), torch.zeros(1, 4, dtype=torch.long), (3,))
    v = torch.randn(1, 4, 2)
    tcp._readable(v, rows, 0)
    assert isinstance(tcp._pack(v), tcp._Tap)
    key = v.untyped_storage().data_ptr()
    ref = tcp._READABLE[key][0]
    del v
    assert key not in tcp._READABLE and ref() is None
    # an entry left behind is not taken for a tensor of another storage
    other = torch.randn(1, 4, 2)
    tcp._READABLE[other.untyped_storage().data_ptr()] = (ref, rows, 0, other.shape,
                                                          other.stride(), 0)
    try:
        assert tcp._pack(other) is other
    finally:
        tcp._READABLE.pop(other.untyped_storage().data_ptr(), None)


def test_no_hooks_while_no_graph_holds_rows():
    """Without an encode's graph alive (another encoder's step) the hooks
    are not set, so that step pays nothing for them."""
    gc.collect()
    assert isinstance(tcp.rows_read_again(), contextlib.nullcontext)
    spec, params, x, w, cot = _encoder_case("bfloat16", "twohot")
    out = tcp.cp_encode(x.clone().requires_grad_(True), params, spec)
    assert not isinstance(tcp.rows_read_again(), contextlib.nullcontext)
    del out
    gc.collect()
    assert isinstance(tcp.rows_read_again(), contextlib.nullcontext)


def _stacked(rows=(5, 9, 6), n=24):
    table = _randn(sum(rows), RANK, dtype=torch.float64)
    i0 = torch.stack([_index(n, R, seed=s)[:n] for s, R in enumerate(rows)])
    return table, i0, rows


def test_stacked_pair_equals_the_pair_table_by_table():
    table, i0, rows = _stacked()
    dv0 = _randn(len(rows), i0.shape[1], RANK, dtype=torch.float64, seed=2)
    dv1 = _randn(len(rows), i0.shape[1], RANK, dtype=torch.float64, seed=3)
    v0, v1 = cp_rows.gather_pairs(table, i0, rows)
    starts = np.cumsum((0,) + rows[:-1])
    for s, (o, R) in enumerate(zip(starts, rows)):
        p0, p1 = cp_rows.gather_pair_plain(table[o:o + R], i0[s])
        assert torch.equal(v0[s], p0) and torch.equal(v1[s], p1)
    for taps in ((dv0, dv1), (dv0, None), (None, dv1)):
        got = cp_rows.scatter_pairs(*taps, i0, rows)
        want = torch.cat([cp_rows.scatter_pair_plain(*(None if d is None else d[s] for d in taps),
                                                     i0[s], R) for s, R in enumerate(rows)])
        assert torch.equal(got, want)


def test_stacked_pair_gradcheck_and_gradgradcheck():
    table, i0, rows = _stacked()
    table.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: cp_rows.row_pair(t, i0, rows), (table,))
    assert torch.autograd.gradgradcheck(lambda t: cp_rows.row_pair(t, i0, rows), (table,))
    dv0 = _randn(len(rows), i0.shape[1], RANK, dtype=torch.float64, seed=2).requires_grad_(True)
    dv1 = _randn(len(rows), i0.shape[1], RANK, dtype=torch.float64, seed=3).requires_grad_(True)

    def scatter(a, b):
        return cp_rows.CPRowScatter.apply(a, b, i0, rows)

    assert torch.autograd.gradcheck(scatter, (dv0, dv1))
    assert torch.autograd.gradgradcheck(scatter, (dv0, dv1))


@pytest.mark.parametrize("bad", ["i0_1d", "i0_segments", "rows_total", "no_grads"])
def test_stacked_wrappers_reject_bad_input(bad):
    table, i0, rows = _stacked()
    dv = _randn(len(rows), i0.shape[1], RANK, dtype=torch.float64)
    call = {
        "i0_1d": lambda: cp_rows.gather_pairs(table, i0[0], rows),
        "i0_segments": lambda: cp_rows.gather_pairs(table, i0[:2], rows),
        "rows_total": lambda: cp_rows.gather_pairs(table[1:], i0, rows),
        "no_grads": lambda: cp_rows.scatter_pairs(None, None, i0, rows),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        call()


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


@pytest.mark.cuda
def test_stacked_kernels_match_plain_on_card(cuda_device):
    """The CP train step's tables stacked (three axes of the 213-row level
    and one of the 2048-row level: both scatter paths), one launch a table:
    the gathers equal the plain version; each table's scatter within
    ``test_kernels_match_plain_on_card``'s bound of the f64 sum."""
    g = torch.Generator().manual_seed(5)
    n, rank = cp_rows_cases.N, cp_rows_cases.RANK
    rows = (213, 213, 213, 2048)
    i0 = torch.stack([cp_rows_cases.step_indices(R, generator=g, device=cuda_device)
                      for R in rows])
    table = torch.randn(sum(rows), rank, generator=g).to(cuda_device)
    dv0 = torch.randn(len(rows), n, rank, generator=g).to(cuda_device)
    dv1 = torch.randn(len(rows), n, rank, generator=g).to(cuda_device)
    launches = cp_rows.GATHER.launches, cp_rows.SCATTER.launches
    v0, v1 = cp_rows.gather_pairs(table, i0, rows)
    out = cp_rows.scatter_pairs(dv0, dv1, i0, rows)
    torch.cuda.synchronize()
    assert (cp_rows.GATHER.launches, cp_rows.SCATTER.launches) == \
        (launches[0] + len(rows), launches[1] + len(rows))
    start = 0
    for s, R in enumerate(rows):
        p0, p1 = cp_rows.gather_pair_plain(table[start:start + R], i0[s])
        assert torch.equal(v0[s], p0) and torch.equal(v1[s], p1)
        exact = cp_rows.scatter_pair_plain(dv0[s].double(), dv1[s].double(), i0[s], R)
        mags = cp_rows.scatter_pair_plain(dv0[s].double().abs(), dv1[s].double().abs(), i0[s], R)
        assert bool(((out[start:start + R].double() - exact).abs() <= 2.0**-20 * mags).all())
        start += R

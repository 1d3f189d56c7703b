"""The port's counterparts of the micro-benchmarks' Pallas kernels
(``tools/bench_scatter.py``, ``bench_scatter2.py``, ``bench_gs4.py``) against
those kernels, run in interpret mode on the CPU at small sizes.

On the CPU each wrapper takes its plain PyTorch version; the CUDA half
(kernel against plain version) needs a card and skips without one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from envidr_tpu_torch.ops import _cuda, gather, scatter
from test_torch_helpers import load_tool_functions

B, S, S_SMALL, W = 8192, 8192, 1024, 16
SMALL = dict(B=B, S=S, W=W, L=1, S_small=S_SMALL, BLK=1024, BLK_B=1024, TILE_S=2048)
F32_ATOL = 1e-5           # f32 sums of ~8 unit-normal rows, in another order
BF16_ROWS_ATOL = 1e-5     # f32 sums of bf16-rounded rows (both round to nearest even)
BF16_ACC_RTOL = 2.0**-7   # of max |ref|: bf16 sums, a few bf16 ulps in another order
BF16_ORDER_RTOL = 2.0**-5  # of max |ref|: on the card both sides sum in orders that
                           # atomics choose, which differ by up to 2 ulps of the largest
                           # sums, 2^-7 of max |ref| or more (chip_smoke.py's bf16
                           # accumulator readings, PERF.md); 2^-5 is 4-8 ulps


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, S, B).astype(np.int32)
    rows = rng.standard_normal((B, W)).astype(np.float32)
    table = rng.standard_normal((S, W)).astype(np.float32)
    return idx, rows, table


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["g_pallas_take", "g_pallas_taa"])
def test_gather_small_table_matches_pallas(data, name):
    idx, _, table = data
    fn = load_tool_functions("bench_scatter.py", [name, "pl_gather_kernel",
                                                  "pl_gather_kernel2"], SMALL)[name]
    idx_s, table_s = idx % S_SMALL, table[:S_SMALL]
    ref = np.asarray(fn(jnp.asarray(table_s), jnp.asarray(idx_s)))
    ours = gather.gather_rows(_t(table_s), _t(idx_s))
    np.testing.assert_array_equal(ours.numpy(), ref)          # a gather is exact


def test_onehot_gather_matches_pallas(data):
    idx, _, table = data
    fn = load_tool_functions("bench_scatter.py", ["g_pallas_onehot",
                                                  "pl_onehot_gather_kernel"],
                             SMALL)["g_pallas_onehot"]
    # tools/bench_scatter.py:254-263 lists idx first in in_specs but calls the
    # pallas_call with (table, idx), which JAX refuses; called here with the
    # arguments in in_specs order, its body computes f32(bf16(table[idx]))
    ref = np.asarray(fn(jnp.asarray(idx), jnp.asarray(table)))
    ours = gather.gather_rows(_t(table), _t(idx), round_bf16=True)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert np.abs(ours.numpy() - table[idx]).max() > 0      # it does round


def test_onehot_scatter_matches_pallas(data):
    idx, rows, _ = data
    fn = load_tool_functions("bench_scatter.py", ["s_pallas_onehot",
                                                  "pl_onehot_scatter_kernel"],
                             SMALL)["s_pallas_onehot"]
    ref = np.asarray(fn(jnp.asarray(idx), jnp.asarray(rows)))
    ours = scatter.scatter_add_rows(_t(idx[None]), _t(rows[None]), S, round_bf16=True)[0]
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=BF16_ROWS_ATOL)


def test_fori_scatter_matches_pallas(data):
    idx, rows, _ = data
    fn = load_tool_functions("bench_scatter.py", ["s_pallas_fori",
                                                  "pl_fori_scatter_kernel"],
                             SMALL)["s_pallas_fori"]
    idx_s = idx % S_SMALL
    ref = np.asarray(fn(jnp.asarray(idx_s), jnp.asarray(rows)))
    ours = scatter.scatter_rows_tiled(_t(idx_s), _t(rows), S_SMALL)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("K", [2, 4])
def test_multi_accumulator_scatter_matches_pallas(data, K):
    idx, rows, _ = data
    make = load_tool_functions("bench_scatter2.py", ["make_pallas_multi"],
                               SMALL)["make_pallas_multi"]
    idx_s = idx % S_SMALL
    ref = np.asarray(make(S_SMALL, K)(jnp.asarray(idx_s), jnp.asarray(rows)))
    ours = scatter.scatter_rows_tiled(_t(idx_s), _t(rows), S_SMALL)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("n_tiles,K,acc", [(4, 2, "float32"), (2, 1, "bfloat16")])
def test_tiled_scatter_matches_pallas(data, n_tiles, K, acc):
    idx, rows, _ = data
    make = load_tool_functions("bench_gs4.py", ["make_tiled"], SMALL)["make_tiled"]
    ref = np.asarray(make(n_tiles, K, getattr(jnp, acc))(jnp.asarray(idx), jnp.asarray(rows)))
    ours = scatter.scatter_rows_tiled(_t(idx), _t(rows), S, getattr(torch, acc))
    atol = F32_ATOL if acc == "float32" else BF16_ACC_RTOL * np.abs(ref).max()
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=atol)


def test_cpu_tensors_take_plain_versions_and_count_nothing(data):
    idx, rows, table = data
    libs = [gather.KERNEL, gather.KERNEL_BF16, scatter.KERNEL_BF16, *scatter.TILED.values()]
    before = [lib.launches for lib in libs]
    i, r, t = _t(idx % 64), _t(rows[:, :8]), _t(table[:64, :8])
    assert torch.equal(gather.gather_rows(t, i), gather.gather_rows_plain(t, i))
    assert torch.equal(gather.gather_rows(t, i, True), gather.gather_rows_plain(t, i, True))
    for acc in (torch.float32, torch.bfloat16):
        assert torch.equal(scatter.scatter_rows_tiled(i, r, 64, acc),
                           scatter.scatter_rows_tiled_plain(i, r, 64, acc))
    assert [lib.launches for lib in libs] == before


@pytest.mark.parametrize("fn", ["gather", "tiled"])
@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "acc"])
def test_wrappers_reject_bad_input(fn, bad):
    idx = torch.zeros(8, dtype=torch.int32)
    tab = torch.zeros((16, 16))
    kw = {}
    if bad == "dtype":
        tab = tab.double()
    elif bad == "shape":
        tab = tab[None]
    elif bad == "device":                       # neither CPU nor CUDA: no silent path
        idx, tab = idx.to("meta"), tab.to("meta")
    elif fn == "tiled":
        kw = {"acc_dtype": torch.float16}
    else:
        idx = idx.float()
    with pytest.raises((TypeError, ValueError)):
        if fn == "gather":
            gather.gather_rows(tab, idx)
        else:
            scatter.scatter_rows_tiled(idx, tab[:8] if tab.dim() == 2 else tab, 16, **kw)


def test_libraries_are_keyed_by_source():
    for lib, stem in ((gather.KERNEL, "gather_rows"),
                      (scatter.TILED[torch.float32], "scatter_rows_tiled"),
                      (scatter.KERNEL_BF16, "scatter_add_rows")):
        p = lib.library_path()
        assert p.parent == _cuda.BUILD_DIR and p.name.startswith(stem + "-")
    assert gather.KERNEL.library_path() == gather.KERNEL_BF16.library_path()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device, data):
    idx, rows, table = (_t(a).to(cuda_device) for a in data)
    idx_s = idx % S_SMALL
    cases = [
        (gather.KERNEL, lambda: gather.gather_rows(table, idx),
         lambda: gather.gather_rows_plain(table, idx), 0.0),
        (gather.KERNEL_BF16, lambda: gather.gather_rows(table, idx, True),
         lambda: gather.gather_rows_plain(table, idx, True), 0.0),
        (scatter.KERNEL_BF16,
         lambda: scatter.scatter_add_rows(idx[None], rows[None], S, round_bf16=True),
         lambda: scatter.scatter_add_rows_plain(idx[None], rows[None], S, True), F32_ATOL),
        (scatter.TILED[torch.float32], lambda: scatter.scatter_rows_tiled(idx_s, rows, S_SMALL),
         lambda: scatter.scatter_rows_tiled_plain(idx_s, rows, S_SMALL), F32_ATOL),
        (scatter.TILED[torch.bfloat16],
         lambda: scatter.scatter_rows_tiled(idx, rows, S, torch.bfloat16),
         lambda: scatter.scatter_rows_tiled_plain(idx, rows, S, torch.bfloat16), None),
    ]
    for lib, run, plain, atol in cases:
        before = lib.launches
        out = run()
        torch.cuda.synchronize()
        assert lib.launches == before + 1
        ref = plain()
        atol = BF16_ORDER_RTOL * float(ref.abs().max()) if atol is None else atol
        assert float((out - ref).abs().max()) <= atol, lib.symbol

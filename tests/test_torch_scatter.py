"""The port's scatter_add_rows (ops/scatter.py) against the Pallas kernel it
replaces, run in interpret mode on the CPU, and against XLA's scatter-add.

On the CPU the wrapper takes its plain PyTorch version; the CUDA half (kernel
against plain version) needs a card and skips without one."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from envidr_tpu.ops.hashgrid import HashGridSpec as JaxSpec, _scatter_rows as jax_scatter_rows
from envidr_tpu.ops.pallas_scatter import scatter_add_rows as pallas_scatter
from envidr_tpu_torch.ops import _cuda, scatter
from envidr_tpu_torch.ops.hashgrid import HashGridSpec, _scatter_rows
from envidr_tpu_torch.tools import scatter_edges

ATOL = 1e-5      # f32 sums of a handful of unit-normal rows, any order


def _data(L, B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, S, (L, B)).astype(np.int32)
    rows = rng.standard_normal((L, B, W)).astype(np.float32)
    return idx, rows


def test_plain_matches_pallas_interpret_and_xla():
    B, S, W = 5000, 4096, 16            # B is not a multiple of the Pallas block
    idx, rows = _data(1, B, S, W)
    ours = scatter.scatter_add_rows_plain(torch.from_numpy(idx), torch.from_numpy(rows), S)[0]
    pallas = np.asarray(pallas_scatter(jnp.asarray(idx[0]), jnp.asarray(rows[0]), S=S,
                                       interpret=True))
    xla = np.asarray(jnp.zeros((S, W), jnp.float32).at[jnp.asarray(idx[0])].add(
        jnp.asarray(rows[0])))
    np.testing.assert_allclose(ours.numpy(), pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), xla, rtol=0, atol=ATOL)


@pytest.mark.parametrize("scatter_impl", ["mixed", "xla"])
def test_batched_matches_jax_scatter_rows(scatter_impl):
    kw = dict(num_levels=4, level_dim=2, base_resolution=4, desired_resolution=64,
              log2_hashmap_size=12, indexing="rolled_tiled", scatter_impl=scatter_impl)
    jspec, tspec = JaxSpec(**kw), HashGridSpec(**kw)
    B, W = 3000, 16
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, s, B) for s in tspec.sizes]).astype(np.int32)
    rows = rng.standard_normal((4, B, W)).astype(np.float32)
    s_max = tspec.s_max
    like = jnp.zeros((4, s_max, W), jnp.float32)
    ref = np.asarray(jax_scatter_rows(like, jnp.asarray(idx), jnp.asarray(rows), jspec))
    ours = _scatter_rows(s_max, torch.from_numpy(idx).long(), torch.from_numpy(rows), tspec)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    idx, rows = _data(2, 100, 64, 8)
    before = scatter.KERNEL.launches
    out = scatter.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(rows), 64)
    assert scatter.KERNEL.launches == before
    ref = scatter.scatter_add_rows_plain(torch.from_numpy(idx), torch.from_numpy(rows), 64)
    assert torch.equal(out, ref)


def test_padding_rows_stay_zero():
    idx, rows = _data(2, 50, 10, 4)
    out = scatter.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(rows), 32)
    assert out.shape == (2, 32, 4)
    assert torch.count_nonzero(out[:, 10:]) == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrapper_rejects_bad_input(bad):
    idx = torch.zeros((2, 8), dtype=torch.int32)
    rows = torch.zeros((2, 8, 16))
    if bad == "dtype":
        rows = rows.double()
    elif bad == "shape":
        rows = rows[:, :4]
    else:                                   # neither CPU nor CUDA: no silent path
        idx, rows = idx.to("meta"), rows.to("meta")
    with pytest.raises((TypeError, ValueError)):
        scatter.scatter_add_rows(idx, rows, 16)


def test_library_path_is_keyed_by_source():
    p = scatter.KERNEL.library_path()
    assert p.parent == _cuda.BUILD_DIR and p.suffix == ".so"
    assert p.name.startswith("scatter_rows-")


def test_library_key_covers_included_headers(tmp_path):
    """An edit to a header that a source includes with quotes, directly or
    through another header, must give the source a new library, or a stale
    one would be loaded from _build/."""
    csrc = tmp_path / "csrc"
    shutil.copytree(scatter.SOURCE.parent, csrc)
    source = csrc / scatter.SOURCE.name
    source.write_bytes(b'#include "common.cuh"\n' + source.read_bytes())
    (csrc / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("#pragma once\n")
    lib = _cuda.CudaLibrary(source, "unused", [])
    _cuda.LIBRARIES.remove(lib)
    before = lib.library_path()
    (csrc / "gather_rows.cu").write_text("// not included\n")
    assert lib.library_path() == before
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert lib.library_path() != before
    assert lib.library_path().name.startswith("scatter_rows-")


def test_edge_sweep_runs_on_cpu():
    """The card's edge-shape sweep builds and runs every case; on the CPU both
    sides are the plain version."""
    recs = scatter_edges.run("cpu", log=lambda line: None)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in recs)
    assert len(recs) == len(scatter_edges.cases("cpu"))
    kernels = {r["kernel"] for r in recs}
    assert kernels == {"scatter_rows_tiled", "scatter_add_rows", "gather_rows"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    spec = HashGridSpec(indexing="rolled_tiled", scatter_impl="mixed")
    B, W = 65536, 16
    rng = np.random.default_rng(2)
    idx = np.stack([rng.integers(0, s, B) for s in spec.sizes]).astype(np.int32)
    rows = rng.standard_normal((spec.num_levels, B, W)).astype(np.float32)
    idx_t, rows_t = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(rows).to(cuda_device)
    before = scatter.KERNEL.launches
    out = scatter.scatter_add_rows(idx_t, rows_t, spec.s_max)
    torch.cuda.synchronize()
    assert scatter.KERNEL.launches == before + 1
    ref = scatter.scatter_add_rows_plain(idx_t, rows_t, spec.s_max)
    # atomics add in another order than index_add_: f32 rounding of ~16-row sums
    assert float((out - ref).abs().max()) <= 1e-4
    # the edge shapes (one slot per level, few rows, levels of different
    # sizes, W = 4 and 8, int64 indices, no rows), padding zero
    edges = [c for c in scatter_edges.cases(cuda_device) if c.kernel == "scatter_add_rows"]
    assert edges
    for c in edges:
        ref = c.plain()
        out = c.run()
        assert float((out - ref).abs().max()) <= c.atol, c.name
        for l, size in enumerate(c.padding):
            assert torch.count_nonzero(out[l, size:]) == 0, c.name

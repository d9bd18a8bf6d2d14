"""Static fused R-MCL vs the reference-semantics stream driver.

When the selection cap S exceeds every row's survivor count, the static
loop must match the dynamic one exactly (same prune math, util.cc:4-69).
"""

import numpy as np
import pytest

from sparse_matrix_with_flops_tpu.formats.csr import CSR
from sparse_matrix_with_flops_tpu.io import load_coo
from sparse_matrix_with_flops_tpu.models.rmcl import rmcl, rmcl_init
from sparse_matrix_with_flops_tpu.models.rmcl_ell import (
    ell_to_csr,
    mt_to_ell,
    plan_rmcl_ell,
    rmcl_ell,
)


def _compare(a: CSR, b: CSR, tol=1e-5) -> bool:
    return bool(
        a.make_ordered()
        ._drop_explicit_zeros()
        .is_raw_equal(b.make_ordered()._drop_explicit_zeros(), tol=tol)
    )


def test_ell_roundtrip_init():
    graph = load_coo("tests/tdatas/tdata.snap", extra_capacity=16)
    mt0 = rmcl_init(graph)
    cols, vals = mt_to_ell(mt0, S=8)
    back = ell_to_csr(cols, vals, mt0.ncols)
    assert _compare(back, mt0)


@pytest.mark.parametrize("iters", [1, 3])
def test_static_matches_dynamic_tdata(iters):
    graph = load_coo("tests/tdatas/tdata.snap", extra_capacity=16)
    mt0 = rmcl_init(graph)
    ref = rmcl(mt0, max_iters=iters, mode="loop")
    got, hist = rmcl_ell(mt0, max_iters=iters, S=8)
    assert _compare(got, ref.mt)
    assert int(hist["truncated_rows"].sum()) == 0
    np.testing.assert_allclose(
        hist["differs"], ref.differs_history, rtol=1e-3, atol=1e-5
    )


def test_static_matches_dynamic_random(rng):
    n = 24
    mask = rng.random((n, n)) < 0.25
    np.fill_diagonal(mask, True)
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    mt0 = CSR.from_dense(dense).aver_and_norm_rows()
    ref = rmcl(mt0, max_iters=3, mode="loop")
    got, hist = rmcl_ell(mt0, max_iters=3, S=32)
    assert int(hist["truncated_rows"].sum()) == 0
    assert _compare(got, ref.mt)


def test_static_huge_row_dense_path(rng):
    # one hub row forces the dense branch (degree > max_tile/S)
    n = 32
    mask = rng.random((n, n)) < 0.15
    np.fill_diagonal(mask, True)
    mask[3, :] = True  # hub
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    mt0 = CSR.from_dense(dense).aver_and_norm_rows()
    plan = plan_rmcl_ell(mt0, S=32, max_tile=32 * 8)  # Dmax = 8 < 32
    assert plan.huge_rows.size >= 1
    ref = rmcl(mt0, max_iters=2, mode="loop")
    got, hist = rmcl_ell(mt0, max_iters=2, S=32, max_tile=32 * 8)
    assert int(hist["truncated_rows"].sum()) == 0
    assert _compare(got, ref.mt)


def test_selection_cap_truncates():
    # S=2 on a denser graph must truncate and stay row-stochastic
    rng = np.random.default_rng(5)
    n = 16
    mask = rng.random((n, n)) < 0.5
    np.fill_diagonal(mask, True)
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    mt0 = CSR.from_dense(dense).aver_and_norm_rows()
    got, hist = rmcl_ell(mt0, max_iters=2, S=2)
    rowsums = np.asarray(got.to_dense()).sum(axis=1)
    np.testing.assert_allclose(rowsums, 1.0, atol=1e-5)


def test_plan_no_degree_gap(rng):
    # regression: S not a pow2 divisor of max_tile must not leave degrees
    # unbinned (they were neither binned nor huge -> silently empty rows)
    n = 128
    mask = rng.random((n, n)) < 0.6  # rows with degree ~77 > last pow2 bin
    np.fill_diagonal(mask, True)
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    mt0 = CSR.from_dense(dense).aver_and_norm_rows()
    plan = plan_rmcl_ell(mt0, S=96, max_tile=8192)  # dmax_tile=85 -> dmax=64
    deg = np.diff(np.asarray(mt0.row_ptr))
    covered = set()
    for d, rows, _ in plan.bins:
        covered.update(rows.tolist())
    covered.update(plan.huge_rows.tolist())
    assert covered == set(np.nonzero(deg > 0)[0].tolist())


def test_symbolic_api_works(rng):
    from sparse_matrix_with_flops_tpu.ops.ell_esc import (
        plan_ell,
        spgemm_ell_symbolic,
    )
    from sparse_matrix_with_flops_tpu.ops.spgemm import spgemm_dense_oracle

    a = CSR.from_dense(
        np.where(rng.random((24, 24)) < 0.2, 1.0, 0.0).astype(np.float32)
    )
    rp, nnz = spgemm_ell_symbolic(a, a, plan_ell(a, a, chunk=8, max_w=64))
    want = spgemm_dense_oracle(a, a)
    assert int(nnz) == int(want.nnz)
    np.testing.assert_array_equal(
        np.asarray(rp), np.asarray(want.row_ptr)
    )


def test_hub_bf16_close_to_f32(rng):
    n = 32
    mask = rng.random((n, n)) < 0.15
    np.fill_diagonal(mask, True)
    mask[3, :] = True  # hub
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    mt0 = CSR.from_dense(dense).aver_and_norm_rows()
    f32, _ = rmcl_ell(mt0, max_iters=2, S=32, max_tile=32 * 8)
    b16, _ = rmcl_ell(
        mt0, max_iters=2, S=32, max_tile=32 * 8, hub_precision="bf16"
    )
    a = np.asarray(f32.to_dense())
    b = np.asarray(b16.to_dense())
    assert np.allclose(a, b, rtol=0.05, atol=0.02)


@pytest.mark.parametrize("width", [2048, 8192])
def test_sort_dedup_rows_exact_on_wide_tiles(width):
    """Run totals on a wide tile stay at the rounding of their own run.
    Large runs early in the row push a whole-row prefix sum to ~1e6, so a
    cumsum difference would lose the small runs after them (~0.06 abs);
    the segmented sums keep every total within float32 rounding."""
    import jax.numpy as jnp

    from sparse_matrix_with_flops_tpu.ops.segments import sort_dedup_rows

    rng = np.random.default_rng(width)
    ncols = 4 * width
    cols = rng.integers(0, ncols, size=(4, width)).astype(np.int32)
    cols[:, : width // 2] = np.sort(cols[:, : width // 2], axis=1) % 64
    vals = np.where(
        cols < 64, 1e3, 1e-3 * rng.random((4, width))
    ).astype(np.float32)
    cols[:, -5:] = ncols  # padding lanes
    key, got = sort_dedup_rows(jnp.asarray(cols), jnp.asarray(vals), ncols)
    key, got = np.asarray(key), np.asarray(got)
    for r in range(4):
        live = cols[r] < ncols
        want_c, inv = np.unique(cols[r][live], return_inverse=True)
        want_v = np.bincount(
            inv, weights=vals[r][live].astype(np.float64)
        )
        k = want_c.size
        np.testing.assert_array_equal(key[r, :k], want_c)
        assert np.all(key[r, k:] == ncols) and np.all(got[r, k:] == 0)
        np.testing.assert_allclose(got[r, :k], want_v, rtol=2e-6, atol=0)

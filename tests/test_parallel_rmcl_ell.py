"""Distributed static R-MCL vs the single-chip drivers (8-device CPU mesh)."""

import numpy as np
import pytest

from sparse_matrix_with_flops_tpu.formats.csr import CSR
from sparse_matrix_with_flops_tpu.io import load_coo
from sparse_matrix_with_flops_tpu.models.rmcl import rmcl, rmcl_init
from sparse_matrix_with_flops_tpu.models.rmcl_ell import rmcl_ell
from sparse_matrix_with_flops_tpu.parallel import make_mesh
from sparse_matrix_with_flops_tpu.parallel.rmcl_ell import sharded_rmcl_ell


def _compare(a: CSR, b: CSR, tol=1e-5) -> bool:
    return bool(
        a.make_ordered()
        ._drop_explicit_zeros()
        .is_raw_equal(b.make_ordered()._drop_explicit_zeros(), tol=tol)
    )


@pytest.mark.parametrize("exchange", ["ring", "all_gather"])
@pytest.mark.parametrize("nd", [2, 8])
def test_sharded_static_matches_dynamic(nd, exchange):
    mesh = make_mesh(nd)
    graph = load_coo("tests/tdatas/tdata.snap", extra_capacity=16)
    mt0 = rmcl_init(graph)
    ref = rmcl(mt0, max_iters=3, mode="loop")
    got, hist = sharded_rmcl_ell(
        mt0, mesh, max_iters=3, S=8, exchange=exchange
    )
    assert int(hist["truncated_rows"].sum()) == 0
    assert _compare(got, ref.mt)
    np.testing.assert_allclose(
        hist["differs"], ref.differs_history, rtol=1e-3, atol=1e-5
    )


@pytest.mark.parametrize("exchange", ["ring", "all_gather"])
def test_sharded_static_matches_single_chip_random(rng, exchange):
    mesh = make_mesh(4)
    n = 32
    mask = rng.random((n, n)) < 0.2
    np.fill_diagonal(mask, True)
    mask[5, :] = True  # hub row exercises the dense branch on one shard
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    mt0 = CSR.from_dense(dense).aver_and_norm_rows()
    ref, rhist = rmcl_ell(mt0, max_iters=2, S=32, max_tile=32 * 8)
    got, hist = sharded_rmcl_ell(
        mt0, mesh, max_iters=2, S=32, max_tile=32 * 8, exchange=exchange
    )
    assert _compare(got, ref)
    np.testing.assert_allclose(
        hist["differs"], rhist["differs"], rtol=1e-3, atol=1e-5
    )


def test_sharded_balanced_matches_unbalanced(rng):
    mesh = make_mesh(4)
    n = 32
    mask = rng.random((n, n)) < 0.25
    np.fill_diagonal(mask, True)
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    mt0 = CSR.from_dense(dense).aver_and_norm_rows()
    ref, _ = sharded_rmcl_ell(mt0, mesh, max_iters=2, S=32)
    got, _ = sharded_rmcl_ell(mt0, mesh, max_iters=2, S=32, balance=True)
    assert _compare(got, ref)


@pytest.mark.parametrize("exchange", ["fused_ring", "pallas_ring", "bogus"])
def test_exchange_rejects_unknown_modes(exchange):
    """Only the XLA-collective exchanges exist: "ring" and "all_gather"."""
    mesh = make_mesh(2)
    graph = load_coo("tests/tdatas/tdata.snap", extra_capacity=16)
    with pytest.raises(ValueError, match="exchange must be one of"):
        sharded_rmcl_ell(
            rmcl_init(graph), mesh, max_iters=1, S=8, exchange=exchange
        )

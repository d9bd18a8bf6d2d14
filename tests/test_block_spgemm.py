"""Dense-block SpGEMM (ops/block_spgemm) vs oracles."""

import numpy as np
import pytest

from sparse_matrix_with_flops_tpu.formats.csr import CSR
from sparse_matrix_with_flops_tpu.ops.block_spgemm import (
    block_fill_estimate,
    block_spgemm,
    block_spgemm_tiled,
    plan_block,
)
from sparse_matrix_with_flops_tpu.utils.generate import banded_csr, rmat_csr

from conftest import random_csr_np


def _scipy_product(a):
    import scipy.sparse as sp

    rp = np.asarray(a.row_ptr)
    nnz = int(rp[-1])
    sa = sp.csr_matrix(
        (np.asarray(a.values)[:nnz], np.asarray(a.col_ind)[:nnz], rp),
        shape=a.shape,
    )
    return (sa @ sa).sorted_indices()


def _assert_exact(a, bs):
    want = _scipy_product(a)
    plan = plan_block(a, a, bs=bs)
    got = block_spgemm(a, a, plan)
    grp = np.asarray(got.row_ptr)
    gn = int(grp[-1])
    assert gn == want.nnz
    np.testing.assert_array_equal(np.asarray(got.col_ind)[:gn], want.indices)
    np.testing.assert_allclose(
        np.asarray(got.values)[:gn], want.data, rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_block_banded_exact(bs):
    _assert_exact(banded_csr(200, bandwidth=9, seed=0), bs)


def test_block_banded_cantlike_exact():
    # 65-entry band rows, non-multiple of bs (exercises tail blocks)
    _assert_exact(banded_csr(300, bandwidth=32, seed=2), 128)


def test_block_powerlaw_exact():
    _assert_exact(rmat_csr(7, edge_factor=6, seed=3, weights="random"), 16)


def test_block_random_rect_chain(rng):
    # rectangular A [40, 56] x B [56, 48], bs not dividing any dim
    rp_a, ca, va = random_csr_np(rng, 40, 56, 0.15)
    a = CSR.from_arrays(rp_a, ca, va, ncols=56)
    rp_b, cb, vb = random_csr_np(rng, 56, 48, 0.2)
    b = CSR.from_arrays(rp_b, cb, vb, ncols=48)
    import scipy.sparse as sp

    sa = sp.csr_matrix(
        (np.asarray(a.values), np.asarray(a.col_ind), np.asarray(a.row_ptr)),
        shape=a.shape,
    )
    sb = sp.csr_matrix(
        (np.asarray(b.values), np.asarray(b.col_ind), np.asarray(b.row_ptr)),
        shape=b.shape,
    )
    want = (sa @ sb).sorted_indices()
    got = block_spgemm(a, b, plan_block(a, b, bs=16))
    gn = int(np.asarray(got.row_ptr)[-1])
    assert gn == want.nnz
    np.testing.assert_array_equal(np.asarray(got.col_ind)[:gn], want.indices)
    np.testing.assert_allclose(
        np.asarray(got.values)[:gn], want.data, rtol=1e-4, atol=1e-5
    )


def test_block_explicit_zero_is_structural(rng):
    # framework convention (same as the ELL pipeline, and the
    # reference's Gustavson which never value-prunes mid-multiply):
    # an explicit zero value still creates STRUCTURAL output entries.
    # (scipy's csr matmul prunes exact-zero products, so this corner is
    # checked against the in-repo ELL kernel instead.)
    from sparse_matrix_with_flops_tpu.ops.ell_esc import plan_ell, spgemm_ell

    rp = np.array([0, 1, 2, 2, 2, 2, 2, 2, 2], np.int32)
    ci = np.array([1, 0], np.int32)
    v = np.array([0.0, 2.0], np.float32)  # explicit zero at (0, 1)
    a = CSR.from_arrays(rp, ci, v, ncols=8)
    got = block_spgemm(a, a, plan_block(a, a, bs=8))
    ref = spgemm_ell(a, a, plan_ell(a, a, chunk=4, max_w=16))
    got_n = int(np.asarray(got.row_ptr)[-1])
    ref_n = int(np.asarray(ref.row_ptr)[-1])
    assert got_n == ref_n == 2  # (0,0) and (1,1) kept structurally


def test_block_tiled_form_ops(rng):
    a = banded_csr(96, bandwidth=5, seed=1)
    t = block_spgemm_tiled(a, a, plan_block(a, a, bs=16))
    want = _scipy_product(a)
    x = rng.standard_normal(96).astype(np.float32)
    yw = want @ x
    import jax.numpy as jnp

    np.testing.assert_allclose(
        np.asarray(t.spmv(jnp.asarray(x))), yw, rtol=1e-3, atol=1e-4
    )


def test_block_fill_estimate_routing():
    band = banded_csr(512, bandwidth=32, seed=2)
    assert block_fill_estimate(band, band) > 0.05  # route to the block engine
    pl = rmat_csr(10, edge_factor=4, seed=7)
    assert block_fill_estimate(pl, pl) < 0.05  # stay on the lane pipeline


def test_spgemm_auto_routes_and_matches():
    from sparse_matrix_with_flops_tpu.ops.dispatch import spgemm_auto

    for a in (
        banded_csr(200, bandwidth=9, seed=0),  # -> block path
        rmat_csr(7, edge_factor=6, seed=3, weights="random"),  # -> lane
    ):
        got = spgemm_auto(a, a, bs=16)
        want = _scipy_product(a)
        gn = int(np.asarray(got.row_ptr)[-1])
        assert gn == want.nnz
        np.testing.assert_array_equal(
            np.asarray(got.col_ind)[:gn], want.indices
        )
        np.testing.assert_allclose(
            np.asarray(got.values)[:gn], want.data, rtol=1e-4, atol=1e-5
        )

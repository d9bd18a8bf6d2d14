"""Blocked formats + kernels: BCSR/ELL/MCSR/PCSR/DenseMatrix vs oracles."""

import numpy as np
import jax.numpy as jnp
import pytest

from sparse_matrix_with_flops_tpu.formats import (
    BCSR,
    CSR,
    DenseMatrix,
    ELL,
    MCSR,
    PCSR,
)
from sparse_matrix_with_flops_tpu.ops.spmm import (
    bcsr_spmm_xla,
    csr_spmm_dense,
    csr_spmv,
)

from conftest import random_csr_np


def _random_csr(rng, rows, cols, density):
    rp, c, v = random_csr_np(rng, rows, cols, density)
    return CSR.from_arrays(rp, c, v, ncols=cols)


# ---- BCSR ------------------------------------------------------------------
def test_bcsr_roundtrip(rng):
    a = _random_csr(rng, 50, 70, 0.2)
    b = BCSR.from_csr(a, br=8, bc=16)
    assert b.is_equal(a)
    assert 0.0 < float(b.nonzero_density()) <= 1.0


def test_bcsr_spmm_xla_matches_dense(rng):
    a = _random_csr(rng, 40, 60, 0.15)
    bl = BCSR.from_csr(a, br=8, bc=16)
    x = rng.standard_normal((60, 24)).astype(np.float32)
    got = bcsr_spmm_xla(bl, jnp.asarray(x))
    want = np.asarray(a.to_dense()) @ x
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


# ---- CSR spmv / spmm ------------------------------------------------------
def test_csr_spmv(rng):
    a = _random_csr(rng, 33, 29, 0.3)
    x = rng.standard_normal(29).astype(np.float32)
    got = csr_spmv(a, jnp.asarray(x))
    want = np.asarray(a.to_dense()) @ x
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_csr_spmm_dense(rng):
    a = _random_csr(rng, 20, 30, 0.25)
    b = rng.standard_normal((30, 17)).astype(np.float32)
    got = csr_spmm_dense(a, jnp.asarray(b))
    want = np.asarray(a.to_dense()) @ b
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


# ---- ELL -------------------------------------------------------------------
def test_ell_roundtrip_and_spmv(rng):
    a = _random_csr(rng, 26, 31, 0.2)
    e = ELL.from_csr(a)
    np.testing.assert_allclose(
        np.asarray(e.to_dense()), np.asarray(a.to_dense()), atol=1e-6
    )
    x = rng.standard_normal(31).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(e.spmv(jnp.asarray(x))),
        np.asarray(a.to_dense()) @ x,
        rtol=1e-4,
        atol=1e-4,
    )


def test_ell_spmm(rng):
    a = _random_csr(rng, 16, 22, 0.3)
    e = ELL.from_csr(a)
    b = rng.standard_normal((22, 9)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(e.spmm(jnp.asarray(b))),
        np.asarray(a.to_dense()) @ b,
        rtol=1e-4,
        atol=1e-4,
    )


# ---- MCSR -----------------------------------------------------------------
def test_mcsr_split_and_ops(rng):
    a = _random_csr(rng, 30, 30, 0.3)
    m = MCSR.from_csr(a, block_rows=8, block_cols=16)
    np.testing.assert_allclose(
        np.asarray(m.to_dense()), np.asarray(a.to_dense()), atol=1e-6
    )
    x = rng.standard_normal(30).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(m.spmv(jnp.asarray(x))),
        np.asarray(a.to_dense()) @ x,
        rtol=1e-4,
        atol=1e-4,
    )
    b = rng.standard_normal((30, 11)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(m.spmm(jnp.asarray(b))),
        np.asarray(a.to_dense()) @ b,
        rtol=1e-4,
        atol=1e-4,
    )


# ---- PCSR -----------------------------------------------------------------
def test_pcsr_stripes_and_striped_spgemm(rng):
    a = _random_csr(rng, 24, 24, 0.25)
    p = PCSR.from_csr(a, num_stripes=3)
    assert p.num_stripes == 3
    back = p.to_csr()
    assert bool(back.is_equal(a.make_ordered()))
    # striped SpGEMM vs plain (pcsrTest.cc:32-57 role)
    b = _random_csr(rng, 24, 24, 0.25)
    pb = PCSR.from_csr(b, num_stripes=3)
    c_striped = pb.striped_spgemm(a).to_csr()
    from sparse_matrix_with_flops_tpu.ops.spgemm import matmul

    c_plain = matmul(a, b).make_ordered()
    assert bool(
        c_striped._drop_explicit_zeros().is_raw_equal(
            c_plain._drop_explicit_zeros(), tol=1e-5
        )
    )


# ---- DenseMatrix ----------------------------------------------------------
def test_dense_matmul_oracle(rng):
    a = _random_csr(rng, 12, 14, 0.4)
    b = _random_csr(rng, 14, 10, 0.4)
    da, db = DenseMatrix.from_csr(a), DenseMatrix.from_csr(b)
    got = da.matmul(db).data
    want = np.asarray(a.to_dense()) @ np.asarray(b.to_dense())
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)

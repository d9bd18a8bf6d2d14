"""Every float32 contraction on the main paths runs at
config.MATMUL_PRECISION (true f32): a jaxpr audit of each path."""

from functools import partial

import pytest

import jax
import jax.numpy as jnp

from sparse_matrix_with_flops_tpu.config import MATMUL_PRECISION
from sparse_matrix_with_flops_tpu.formats.bcsr import BCSR
from sparse_matrix_with_flops_tpu.formats.dense import DenseMatrix
from sparse_matrix_with_flops_tpu.formats.mcsr import MCSR
from sparse_matrix_with_flops_tpu.utils.generate import banded_csr, rmat_csr


def _eqns(jaxpr):
    """All equations of a jaxpr, recursing into every sub-jaxpr."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


def _f32_dots(fn, *args):
    closed = jax.make_jaxpr(fn)(*args)
    dots = [
        e
        for e in _eqns(closed.jaxpr)
        if e.primitive.name == "dot_general"
        and any(v.aval.dtype == jnp.float32 for v in e.invars)
    ]
    return dots


def _hub_spgemm():
    from sparse_matrix_with_flops_tpu.ops.ell_esc import _tiles_impl, plan_ell

    a = rmat_csr(8, edge_factor=8, seed=3, weights="random")
    plan = plan_ell(a, a, chunk=16, max_w=256, split_hub=False)
    assert plan.hub_groups
    return partial(_tiles_impl, plan=plan, chunk=plan.chunk), (a, a)


def _block_spgemm():
    from sparse_matrix_with_flops_tpu.ops.block_spgemm import (
        block_spgemm_tiled,
        plan_block,
    )

    a = banded_csr(256, bandwidth=8)
    plan = plan_block(a, a, bs=32)
    return (lambda x: block_spgemm_tiled(x, x, plan)), (a,)


def _rmcl_hub_step():
    from sparse_matrix_with_flops_tpu.models.rmcl_ell import (
        _dense_huge,
        mt_to_ell,
        plan_rmcl_ell,
        rmcl_ell_step,
    )

    a = rmat_csr(7, edge_factor=8, seed=1, weights="random")
    mt = a.aver_and_norm_rows().make_ordered()
    plan = plan_rmcl_ell(mt, S=16, max_tile=64)
    assert plan.huge_rows.size
    cols, vals = mt_to_ell(mt, 16)
    return (
        lambda m, d, c, v: rmcl_ell_step(plan, m, d, c, v)[:2],
        (mt, _dense_huge(mt, plan), cols, vals),
    )


def _sharded_ring_step():
    from sparse_matrix_with_flops_tpu.models.rmcl_ell import mt_to_ell
    from sparse_matrix_with_flops_tpu.parallel import make_mesh
    from sparse_matrix_with_flops_tpu.parallel.rmcl_ell import (
        plan_sharded_rmcl_ell,
        sharded_rmcl_ell_scan,
    )

    d = 4
    a = rmat_csr(7, edge_factor=8, seed=1, weights="random")
    mt = a.aver_and_norm_rows().make_ordered()
    plan, arrays, smgt = plan_sharded_rmcl_ell(mt, d, S=16, max_tile=64)
    assert plan.hmax
    cols, vals = mt_to_ell(mt, 16)
    cols = jnp.where(cols >= mt.ncols, plan.n, cols)
    pad = plan.n - mt.rows
    cols = jnp.concatenate([cols, jnp.full((pad, 16), plan.n, cols.dtype)])
    vals = jnp.concatenate([vals, jnp.zeros((pad, 16), vals.dtype)])
    fn = partial(
        sharded_rmcl_ell_scan,
        make_mesh(d),
        plan,
        max_iters=1,
        exchange="ring",
    )
    return (
        lambda s, arr, c, v: fn(s, arr, c, v)[:2],
        (
            smgt,
            arrays,
            cols.reshape(d, plan.lr, 16),
            vals.reshape(d, plan.lr, 16),
        ),
    )


def _bcsr_spmm():
    from sparse_matrix_with_flops_tpu.ops.spmm import bcsr_spmm_xla

    a = banded_csr(64, bandwidth=5)
    x = jnp.ones((64, 16), jnp.float32)
    return bcsr_spmm_xla, (BCSR.from_csr(a, br=8, bc=8), x)


def _mcsr():
    a = banded_csr(32, bandwidth=3)
    m = MCSR.from_csr(a, 8, 8)
    x = jnp.ones((32, 4), jnp.float32)
    return (lambda mm, b: (mm.spmm(b), mm.spmv(b[:, 0]))), (m, x)


def _dense():
    d = DenseMatrix(jnp.ones((8, 8), jnp.float32))
    return (lambda p, q: p.matmul(q).data), (d, d)


PATHS = {
    "spgemm_ell_hub": _hub_spgemm,
    "block_spgemm": _block_spgemm,
    "rmcl_ell_step_hub": _rmcl_hub_step,
    "sharded_rmcl_ring_step": _sharded_ring_step,
    "bcsr_spmm_xla": _bcsr_spmm,
    "mcsr_spmm_spmv": _mcsr,
    "dense_matmul": _dense,
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_f32_contractions_use_configured_precision(path):
    fn, args = PATHS[path]()
    dots = _f32_dots(fn, *args)
    assert dots, f"{path}: no f32 contraction traced"
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == MATMUL_PRECISION for p in prec
        ), f"{path}: dot_general at precision {prec}"


def test_precision_is_true_f32():
    assert MATMUL_PRECISION == jax.lax.Precision.HIGHEST

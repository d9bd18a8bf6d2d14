"""Blocked SpMM / SpMV: BCSR × dense.

The reference ships BCSR/MCSR as formats with *no kernels* (SURVEY.md
§2.2: "No BCSR SpMM/SpMV kernel exists — format + verification only");
this package supplies real ones:

* :func:`bcsr_spmm_xla` — batched-einsum formulation: gather B's block-rows
  per stored block, one big batched (br×bc)@(bc×N) matmul, scatter-add into
  block rows.
* :func:`csr_spmv` — y = A·x as gather + segment-sum.
* :func:`csr_spmm_dense` — the unblocked oracle for ``bcsr_spmm_xla``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import INDEX_DTYPE, MATMUL_PRECISION, QVALUE_DTYPE
from ..formats.bcsr import BCSR
from ..formats.csr import CSR


def _pad_b(a: BCSR, b: jax.Array) -> jax.Array:
    kpad = a.nbcols * a.bc
    if b.shape[0] < kpad:
        b = jnp.pad(b, ((0, kpad - b.shape[0]), (0, 0)))
    return b


@jax.jit
def bcsr_spmm_xla(a: BCSR, b: jax.Array) -> jax.Array:
    """C[rows, N] = A · B via gather → batched matmul → scatter."""
    assert b.ndim == 2 and b.shape[0] == a.cols
    n = b.shape[1]
    bp = _pad_b(a, b).reshape(a.nbcols, a.bc, n)
    safe = jnp.clip(a.block_col, 0, a.nbcols - 1)
    gathered = jnp.take(bp, safe, axis=0)  # [bcap, bc, n]
    prods = jnp.einsum(
        "kij,kjn->kin",
        a.blocks,
        gathered,
        preferred_element_type=jnp.float32,
        precision=MATMUL_PRECISION,
    )
    valid = (a.block_col < a.nbcols)[:, None, None]
    prods = jnp.where(valid, prods, 0.0)
    brows = jnp.searchsorted(
        a.block_row_ptr,
        jnp.arange(a.block_capacity, dtype=INDEX_DTYPE),
        side="right",
    ).astype(INDEX_DTYPE) - 1
    out = jnp.zeros((a.nbrows, a.br, n), QVALUE_DTYPE)
    out = out.at[brows].add(prods, mode="drop")
    return out.reshape(a.nbrows * a.br, n)[: a.rows].astype(QVALUE_DTYPE)


@jax.jit
def csr_spmv(a: CSR, x: jax.Array) -> jax.Array:
    """y = A·x: gather + segment-sum (the SpMV the reference never wrote)."""
    assert x.shape[0] == a.ncols
    safe = jnp.clip(a.col_ind, 0, a.ncols - 1)
    prods = jnp.where(a.entry_valid(), a.values * jnp.take(x, safe), 0.0)
    erow = a.entry_rows()
    return jax.ops.segment_sum(
        prods, erow, num_segments=a.rows + 1
    )[: a.rows].astype(QVALUE_DTYPE)


@jax.jit
def csr_spmm_dense(a: CSR, b: jax.Array) -> jax.Array:
    """C = A·B with dense B via per-entry gather of B rows + segment-sum
    over row segments (vmapped SpMV; the unblocked oracle for bcsr_spmm_xla)."""
    assert b.shape[0] == a.ncols
    safe = jnp.clip(a.col_ind, 0, a.ncols - 1)
    rows_b = jnp.take(b, safe, axis=0)  # [cap, N]
    rows_b = jnp.where(
        a.entry_valid()[:, None], rows_b * a.values[:, None], 0.0
    )
    erow = a.entry_rows()
    return jax.ops.segment_sum(rows_b, erow, num_segments=a.rows + 1)[
        : a.rows
    ].astype(QVALUE_DTYPE)

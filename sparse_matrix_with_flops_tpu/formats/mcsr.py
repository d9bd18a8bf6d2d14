"""MCSR: mixed dense-region + sparse-remainder matrix.

Re-design of the reference's ``struct MCSR : public CSR, BCSR``
(nlibs/MCSR.h:6, MCSR.cc:16-93): there, a dense top-left
``blockRows × blockCols`` region is stored as BCSR and the remainder as
CSR, split by ``col < blockCols``; no kernel exists.  Here the
dense region is an actual dense array (a matmul operand), the remainder stays
CSR, and SpMV/SpMM is dense-matmul + sparse path summed — the natural
hybrid for matrices with a dense corner (e.g. reordered power-law graphs
whose hubs are permuted to the front, CSR::rowDescendingOrderPermutation,
CSR.cc:484-494).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MATMUL_PRECISION, QVALUE_DTYPE
from .csr import CSR


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("dense", "rest"),
    meta_fields=("block_rows", "block_cols"),
)
@dataclasses.dataclass(frozen=True)
class MCSR:
    dense: jax.Array  # f32[block_rows, block_cols] top-left region
    rest: CSR  # everything outside the dense region
    block_rows: int
    block_cols: int

    @property
    def rows(self) -> int:
        return self.rest.rows

    @property
    def ncols(self) -> int:
        return self.rest.ncols

    @staticmethod
    def from_csr(a: CSR, block_rows: int, block_cols: int) -> "MCSR":
        """Split by (row < block_rows) & (col < block_cols)
        (MCSR ctor semantics, MCSR.cc:16-44)."""
        rp = np.asarray(a.row_ptr, dtype=np.int64)
        nnz = int(rp[-1])
        col = np.asarray(a.col_ind)[:nnz]
        val = np.asarray(a.values)[:nnz]
        erow = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(rp))
        in_dense = (erow < block_rows) & (col < block_cols)
        dense = np.zeros((block_rows, block_cols), dtype=np.float32)
        np.add.at(dense, (erow[in_dense], col[in_dense]), val[in_dense])
        keep = ~in_dense
        kcounts = np.bincount(erow[keep], minlength=a.rows)
        krp = np.zeros(a.rows + 1, dtype=np.int64)
        np.cumsum(kcounts, out=krp[1:])
        rest = CSR.from_arrays(
            krp.astype(np.int32), col[keep], val[keep], a.ncols
        )
        return MCSR(
            jnp.asarray(dense, QVALUE_DTYPE), rest, block_rows, block_cols
        )

    def to_dense(self) -> jax.Array:
        out = self.rest.to_dense()
        return out.at[: self.block_rows, : self.block_cols].add(self.dense)

    def spmv(self, x: jax.Array) -> jax.Array:
        from ..ops.spmm import csr_spmv

        y = csr_spmv(self.rest, x)
        yd = jnp.dot(
            self.dense, x[: self.block_cols], precision=MATMUL_PRECISION
        )
        return y.at[: self.block_rows].add(yd)

    def spmm(self, b: jax.Array) -> jax.Array:
        from ..ops.spmm import csr_spmm_dense

        c = csr_spmm_dense(self.rest, b)
        cd = jnp.dot(
            self.dense,
            b[: self.block_cols],
            preferred_element_type=jnp.float32,
            precision=MATMUL_PRECISION,
        )
        return c.at[: self.block_rows].add(cd).astype(QVALUE_DTYPE)

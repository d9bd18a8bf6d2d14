"""BCSR: block-compressed sparse rows with dense (br × bc) tiles.

The reference has the format but no kernel (nlibs/BCSR.h:6-64, BCSR.cc —
"format + verification only", SURVEY.md §2.2); this framework gives it
a real job: dense blocks feed batched matmuls, so BCSR carries the
blocked SpMM/SpMV paths (ops/spmm.py).

Layout choices vs the reference:

* blocks are stored as one dense ``[nblocks, br, bc]`` array (the reference
  stores a flat 4096-aligned values slab, BCSR.cc:34) — XLA-friendly and
  directly feedable to ``jnp.einsum``;
* default block shape is (8, 128) — a wide, matmul-friendly tile — instead of
  the reference's register-blocking default (2, 8) (process_args.h:33-34);
* static capacity padding like CSR: block slots in [nblocks, capacity) are
  zero blocks pointing at block-column ``nbcols`` (sentinel).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from .csr import CSR


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("block_row_ptr", "block_col", "blocks"),
    meta_fields=("rows", "cols", "br", "bc"),
)
@dataclasses.dataclass(frozen=True)
class BCSR:
    """Block CSR; rows/cols are the *unpadded* logical matrix shape."""

    block_row_ptr: jax.Array  # int32[nbrows + 1]
    block_col: jax.Array  # int32[bcap]; sentinel nbcols for padding
    blocks: jax.Array  # f32[bcap, br, bc]
    rows: int
    cols: int
    br: int
    bc: int

    @property
    def nbrows(self) -> int:
        return self.block_row_ptr.shape[0] - 1

    @property
    def nbcols(self) -> int:
        return -(-self.cols // self.bc)

    @property
    def block_capacity(self) -> int:
        return self.block_col.shape[0]

    @property
    def nblocks(self) -> jax.Array:
        return self.block_row_ptr[-1]

    def nonzero_density(self) -> jax.Array:
        """Fill ratio of stored blocks (BCSR::nonzeroDensity, BCSR.h:61-63)."""
        nb = self.nblocks
        nz = jnp.sum(jnp.abs(self.blocks) > 0)
        return nz / jnp.maximum(nb * self.br * self.bc, 1)

    # ---- conversion --------------------------------------------------------
    @staticmethod
    def from_csr(a: CSR, br: int = 8, bc: int = 128) -> "BCSR":
        """Two-pass CSR→BCSR: symbolic block-pattern then numeric fill —
        the same structure as the reference's bitmap symbolic + index
        numeric conversion (BCSR.cc:10-66), vectorised on host."""
        rp = np.asarray(a.row_ptr, dtype=np.int64)
        nnz = int(rp[-1])
        col = np.asarray(a.col_ind)[:nnz]
        val = np.asarray(a.values)[:nnz]
        erow = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(rp))
        brow = erow // br
        bcol = col // bc
        nbrows = -(-a.rows // br)
        nbcols = -(-a.cols // bc)
        key = brow * nbcols + bcol
        order = np.argsort(key, kind="stable")
        skey = key[order]
        first = np.ones(skey.shape[0], dtype=bool)
        first[1:] = skey[1:] != skey[:-1]
        block_id = np.cumsum(first) - 1
        nblocks = int(block_id[-1]) + 1 if skey.size else 0
        ukey = skey[first]
        ubrow = (ukey // nbcols).astype(np.int64)
        ubcol = (ukey % nbcols).astype(np.int32)
        counts = np.bincount(ubrow, minlength=nbrows)
        brp = np.zeros(nbrows + 1, dtype=np.int32)
        np.cumsum(counts, out=brp[1:])
        blocks = np.zeros((max(nblocks, 1), br, bc), dtype=np.float32)
        rr = (erow[order] % br).astype(np.int64)
        cc = (col[order] % bc).astype(np.int64)
        np.add.at(blocks, (block_id, rr, cc), val[order])
        bcol_arr = np.full(max(nblocks, 1), nbcols, dtype=np.int32)
        bcol_arr[:nblocks] = ubcol[:nblocks]
        return BCSR(
            block_row_ptr=jnp.asarray(brp, INDEX_DTYPE),
            block_col=jnp.asarray(bcol_arr, INDEX_DTYPE),
            blocks=jnp.asarray(blocks, QVALUE_DTYPE),
            rows=a.rows,
            cols=a.cols,
            br=br,
            bc=bc,
        )

    def to_dense(self) -> jax.Array:
        """Scatter blocks to a dense (padded) matrix, then crop."""
        nbc = self.nbcols
        pr, pc = self.nbrows * self.br, nbc * self.bc
        brows = jnp.searchsorted(
            self.block_row_ptr,
            jnp.arange(self.block_capacity, dtype=INDEX_DTYPE),
            side="right",
        ).astype(INDEX_DTYPE) - 1
        out = jnp.zeros((self.nbrows, nbc, self.br, self.bc), QVALUE_DTYPE)
        out = out.at[brows, self.block_col].add(self.blocks, mode="drop")
        dense = out.transpose(0, 2, 1, 3).reshape(pr, pc)
        return dense[: self.rows, : self.cols]

    def is_equal(self, a: CSR, tol: float = 1e-6) -> bool:
        """Differential check vs the CSR it came from (BCSR::isEqual,
        BCSR.cc:67-116)."""
        return bool(
            jnp.all(jnp.abs(self.to_dense() - a.to_dense()) <= tol)
        )

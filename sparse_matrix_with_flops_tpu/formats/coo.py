"""COO: triplet container + graph-ingestion ops.

Device counterpart of the reference's ``class COO`` (nlibs/COO.h,
COO.cc).  Ingestion (file parsing) lives in :mod:`..io`; this class holds
the triplets as device arrays with a static capacity and provides the
jit-friendly versions of the reference's preprocessing ops:

* ``add_self_loops``        — COO::addSelfLoopIfNeeded (COO.cc:160-188)
* ``make_ordered``          — COO::makeOrdered (COO.cc:222-235)
* ``sum_duplicates``        — COO::orderedAndDuplicatesRemoving (COO.cc:237-265)
* ``to_csr``                — COO::toCSR (COO.cc:268-291)

Padding convention: slots in [nnz, capacity) hold (row=rows, col=cols,
val=0) — the sentinel sorts after every real entry.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..ops.segments import exclusive_cumsum, segment_boundaries
from .csr import CSR


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("row", "col", "val", "nnz"),
    meta_fields=("nrows", "ncols"),
)
@dataclasses.dataclass(frozen=True)
class COO:
    row: jax.Array  # int32[capacity]
    col: jax.Array  # int32[capacity]
    val: jax.Array  # f32[capacity]
    nnz: jax.Array  # int32 scalar (traced)
    nrows: int
    ncols: int

    @property
    def rows(self) -> int:
        return self.nrows

    @property
    def cols(self) -> int:
        return self.ncols

    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    def valid(self) -> jax.Array:
        return jnp.arange(self.capacity) < self.nnz

    # ---- constructors -----------------------------------------------------
    @staticmethod
    def from_numpy(
        row, col, val, nrows: int, ncols: int, capacity: int | None = None
    ) -> "COO":
        row = np.asarray(row, dtype=np.int32)
        col = np.asarray(col, dtype=np.int32)
        val = np.asarray(val, dtype=np.float32)
        nnz = row.shape[0]
        cap = nnz if capacity is None else int(capacity)
        if cap < nnz:
            raise ValueError(f"capacity {cap} < nnz {nnz}")
        pr = np.full(cap, nrows, dtype=np.int32)
        pc = np.full(cap, ncols, dtype=np.int32)
        pv = np.zeros(cap, dtype=np.float32)
        pr[:nnz], pc[:nnz], pv[:nnz] = row, col, val
        return COO(
            row=jnp.asarray(pr, INDEX_DTYPE),
            col=jnp.asarray(pc, INDEX_DTYPE),
            val=jnp.asarray(pv, QVALUE_DTYPE),
            nnz=jnp.asarray(nnz, INDEX_DTYPE),
            nrows=int(nrows),
            ncols=int(ncols),
        )

    # ---- preprocessing ops --------------------------------------------------
    def add_self_loops(self) -> "COO":
        """Append (i, i, 1.0) for every row without a diagonal entry
        (COO::addSelfLoopIfNeeded, COO.cc:160-188).

        Requires square shape and capacity >= nnz + rows (appends at most
        ``rows`` entries; the padded tail absorbs them).
        """
        assert self.nrows == self.ncols, "self loops need a square matrix"
        n = self.nrows
        valid = self.valid()
        has_diag = jnp.zeros((n,), dtype=bool)
        diag = valid & (self.row == self.col)
        has_diag = has_diag.at[jnp.where(diag, self.row, n)].set(True, mode="drop")
        missing = ~has_diag  # rows needing a loop
        need = jnp.cumsum(missing.astype(INDEX_DTYPE))  # inclusive
        total_new = need[-1]
        # target slot for row i's new loop: nnz + need[i] - 1
        slot = jnp.where(missing, self.nnz + need - 1, self.capacity)
        row = self.row.at[slot].set(jnp.arange(n, dtype=INDEX_DTYPE), mode="drop")
        col = self.col.at[slot].set(jnp.arange(n, dtype=INDEX_DTYPE), mode="drop")
        val = self.val.at[slot].set(1.0, mode="drop")
        return COO(row, col, val, self.nnz + total_new, self.nrows, self.ncols)

    def make_ordered(self) -> "COO":
        """Sort triplets by (row, col) (COO::makeOrdered, COO.cc:222-235)."""
        row, col, val = jax.lax.sort(
            (self.row, self.col, self.val), num_keys=2, is_stable=True
        )
        return COO(row, col, val, self.nnz, self.nrows, self.ncols)

    def sum_duplicates(self) -> "COO":
        """Sort and merge duplicate (row, col) entries by summing values
        (COO::orderedAndDuplicatesRemoving, COO.cc:237-265)."""
        c = self.make_ordered()
        valid = c.valid()
        flags = segment_boundaries(c.row, c.col, valid)
        seg = jnp.cumsum(flags.astype(INDEX_DTYPE)) - 1
        seg = jnp.where(valid, seg, c.capacity - 1)
        cap = c.capacity
        new_val = jax.ops.segment_sum(
            jnp.where(valid, c.val, 0.0), seg, num_segments=cap
        )
        sentinel_r = jnp.full((cap,), self.nrows, dtype=INDEX_DTYPE)
        sentinel_c = jnp.full((cap,), self.ncols, dtype=INDEX_DTYPE)
        new_row = sentinel_r.at[seg].min(jnp.where(valid, c.row, self.nrows))
        new_col = sentinel_c.at[seg].min(jnp.where(valid, c.col, self.ncols))
        new_nnz = jnp.sum(flags.astype(INDEX_DTYPE))
        slot = jnp.arange(cap)
        new_val = jnp.where(slot < new_nnz, new_val, 0.0)
        new_row = jnp.where(slot < new_nnz, new_row, self.nrows)
        new_col = jnp.where(slot < new_nnz, new_col, self.ncols)
        return COO(new_row, new_col, new_val, new_nnz, self.nrows, self.ncols)

    def to_csr(self) -> CSR:
        """Ordered COO -> CSR (COO::toCSR, COO.cc:268-291)."""
        counts = jnp.bincount(
            jnp.where(self.valid(), self.row, self.nrows),
            length=self.nrows + 1,
        )[: self.nrows]
        row_ptr = exclusive_cumsum(counts.astype(INDEX_DTYPE)).astype(INDEX_DTYPE)
        return CSR(row_ptr, self.col, self.val, self.ncols)

    def transpose(self) -> "COO":
        """Swap rows/cols (the reference reads graphs pre-transposed,
        COO.cc:141-148; this provides the op explicitly)."""
        return COO(self.col, self.row, self.val, self.nnz, self.ncols, self.nrows)

    def to_dense(self) -> jax.Array:
        out = jnp.zeros((self.nrows, self.ncols), dtype=self.val.dtype)
        return out.at[self.row, self.col].add(self.val, mode="drop")

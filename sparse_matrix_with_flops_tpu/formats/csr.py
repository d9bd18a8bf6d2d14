"""CSR: the central sparse container, as a static-shape JAX pytree.

Re-design of the reference's ``struct CSR`` (nlibs/CSR.h:23-38):
``{values, colInd, rowPtr, rows, cols, nnz}``.  Differences forced by the
XLA compilation model:

* **Static capacity**: ``col_ind``/``values`` are allocated at a fixed
  ``capacity >= nnz``; slots in ``[nnz, capacity)`` are padding with
  ``col == ncols`` (an out-of-range sentinel that sorts after every real
  column) and ``value == 0``.  This lets one jitted program serve a whole
  R-MCL run even though nnz changes every iteration (the reference reallocs
  per iteration instead, e.g. omp_csr_kernel.cc:166-168).
* **nnz is data, not metadata**: ``nnz == row_ptr[rows]`` is a traced scalar
  so pruning can change it without retriggering compilation.
* rows/ncols are static (they shape every kernel grid).

The comparator trio mirrors CSR.h: ``is_equal`` (exact structure + 1e-7 abs,
CSR.h:195-245), ``is_raw_equal`` (ignores explicit zeros, CSR.h:249-282),
``is_relative_equal`` (CSR.h:284-321).  Permutation ops mirror
CSR.cc:431-494.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ABS_TOL, INDEX_DTYPE, QVALUE_DTYPE
from ..ops.segments import entry_rows, exclusive_cumsum


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("row_ptr", "col_ind", "values"),
    meta_fields=("ncols",),
)
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with padded static capacity."""

    row_ptr: jax.Array  # int32[rows + 1]
    col_ind: jax.Array  # int32[capacity]; padding slots hold ncols
    values: jax.Array  # f32[capacity]; padding slots hold 0
    ncols: int

    # ---- static geometry ---------------------------------------------------
    @property
    def rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def cols(self) -> int:
        return self.ncols

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.ncols)

    @property
    def capacity(self) -> int:
        return self.col_ind.shape[0]

    # ---- traced quantities ---------------------------------------------------
    @property
    def nnz(self) -> jax.Array:
        """Number of stored entries (traced scalar)."""
        return self.row_ptr[-1]

    def entry_rows(self) -> jax.Array:
        """Row id per slot; sentinel ``rows`` for padding slots."""
        return entry_rows(self.row_ptr, self.capacity)

    def entry_valid(self) -> jax.Array:
        return jnp.arange(self.capacity) < self.nnz

    def row_counts(self) -> jax.Array:
        """nnz per row (CSR.h rowCount analogue)."""
        return self.row_ptr[1:] - self.row_ptr[:-1]

    # ---- constructors --------------------------------------------------------
    @staticmethod
    def from_arrays(
        row_ptr, col_ind, values, ncols: int, capacity: int | None = None
    ) -> "CSR":
        """Build from tight host arrays, padding out to ``capacity``."""
        row_ptr = np.asarray(row_ptr, dtype=np.int32)
        col_ind = np.asarray(col_ind, dtype=np.int32)
        values = np.asarray(values, dtype=np.float32)
        nnz = int(row_ptr[-1])
        cap = nnz if capacity is None else int(capacity)
        if cap < nnz:
            raise ValueError(f"capacity {cap} < nnz {nnz}")
        pc = np.full(cap, ncols, dtype=np.int32)
        pv = np.zeros(cap, dtype=np.float32)
        pc[:nnz] = col_ind[:nnz]
        pv[:nnz] = values[:nnz]
        out = CSR(
            row_ptr=jnp.asarray(row_ptr, dtype=INDEX_DTYPE),
            col_ind=jnp.asarray(pc, dtype=INDEX_DTYPE),
            values=jnp.asarray(pv, dtype=QVALUE_DTYPE),
            ncols=int(ncols),
        )
        # the host arrays are authoritative here — seed the planner-side
        # host-view cache (utils/nphost.csr_host) so planning never pays
        # a device->host fetch for host-constructed matrices
        object.__setattr__(
            out, "_host_rp_ci", (row_ptr.astype(np.int64), pc)
        )
        return out

    @staticmethod
    def from_dense(dense) -> "CSR":
        """Dense (host) matrix -> CSR; parity with CSR.h:54-82 dense ctor."""
        dense = np.asarray(dense)
        rows, cols = dense.shape
        mask = dense != 0
        counts = mask.sum(axis=1)
        row_ptr = np.zeros(rows + 1, dtype=np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        r, c = np.nonzero(mask)
        return CSR.from_arrays(row_ptr, c, dense[r, c], ncols=cols)

    def to_dense(self) -> jax.Array:
        """Scatter to dense; padding (col == ncols / row == rows) is dropped."""
        erow = self.entry_rows()
        out = jnp.zeros((self.rows, self.ncols), dtype=self.values.dtype)
        return out.at[erow, self.col_ind].add(self.values, mode="drop")

    def with_capacity(self, capacity: int) -> "CSR":
        """Grow/shrink padding (host-side; nnz must fit)."""
        row_ptr = np.asarray(self.row_ptr)
        return CSR.from_arrays(
            row_ptr,
            np.asarray(self.col_ind),
            np.asarray(self.values),
            self.ncols,
            capacity,
        )

    def deep_copy(self) -> "CSR":
        """Parity with CSR::deepCopy (CSR.cc:97-106); pytrees are immutable so
        this is a shallow rebuild, provided for API familiarity."""
        return CSR(self.row_ptr, self.col_ind, self.values, self.ncols)

    def to_abs(self) -> "CSR":
        """values <- |values| (CSR::toAbs, CSR.h:152-157; the GPU driver
        applies it before the binned pipeline, nGpuSpMM.cc:292)."""
        return CSR(
            self.row_ptr, self.col_ind, jnp.abs(self.values), self.ncols
        )

    def to_one_based(self):
        """Host (row_ptr+1, col_ind+1) arrays for 1-based interop
        (CSR::toOneBasedCSR, CSR.h:170-180 — the MKL convention)."""
        rp = np.asarray(self.row_ptr) + 1
        nnz = int(rp[-1]) - 1
        return rp, np.asarray(self.col_ind)[:nnz] + 1, np.asarray(self.values)[:nnz]

    @staticmethod
    def from_one_based(row_ptr, col_ind, values, ncols: int) -> "CSR":
        """Inverse of to_one_based (CSR::toZeroBasedCSR, CSR.h:182-190)."""
        rp = np.asarray(row_ptr) - 1
        return CSR.from_arrays(
            rp, np.asarray(col_ind) - 1, values, ncols
        )

    def output(self, path: str | None = None, name: str = "csr") -> str:
        """Text dump (CSR::output debugging aid, CSR.h:109-128;
        nrmcl.cc:22-25 writes the iterate under #ifdef debugging)."""
        import io as _io

        rp = np.asarray(self.row_ptr)
        nnz = int(rp[-1])
        col = np.asarray(self.col_ind)[:nnz]
        val = np.asarray(self.values)[:nnz]
        buf = _io.StringIO()
        buf.write(f"{name} rows={self.rows} cols={self.ncols} nnz={nnz}\n")
        for i in range(self.rows):
            ent = " ".join(
                f"({col[j]},{val[j]:.6g})" for j in range(rp[i], rp[i + 1])
            )
            buf.write(f"{i}: {ent}\n")
        text = buf.getvalue()
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    # ---- ordering -------------------------------------------------------------
    def make_ordered(self) -> "CSR":
        """Sort columns within each row (CSR::makeOrdered, CSR.cc:73-86).

        One lexicographic device sort over (entry_row, col) — padding rows
        (sentinel ``rows``) sort to the tail and stay padding.
        """
        erow = self.entry_rows()
        _, col, val = jax.lax.sort(
            (erow, self.col_ind, self.values), num_keys=2, is_stable=True
        )
        return CSR(self.row_ptr, col, val, self.ncols)

    # ---- R-MCL init helper ------------------------------------------------------
    def aver_and_norm_rows(self) -> "CSR":
        """values[j] = 1 / rowCount(row(j)) (CSR::averAndNormRowQValue,
        CSR.cc:88-95) — the column-stochastic init of R-MCL (input is stored
        transposed, so rows here are the stochastic direction)."""
        counts = self.row_counts()
        erow = self.entry_rows()
        cnt = jnp.take(counts, jnp.clip(erow, 0, self.rows - 1))
        val = jnp.where(
            self.entry_valid(),
            1.0 / jnp.maximum(cnt, 1).astype(QVALUE_DTYPE),
            0.0,
        )
        return CSR(self.row_ptr, self.col_ind, val.astype(QVALUE_DTYPE), self.ncols)

    # ---- permutation ops (CSR.cc:431-494) -----------------------------------------
    def permute_rows(self, p: jax.Array) -> "CSR":
        """P·M: out row i = in row p[i] (CSR::PM semantics)."""
        counts = self.row_counts()[p]
        row_ptr = exclusive_cumsum(counts).astype(INDEX_DTYPE)
        erow_out = entry_rows(row_ptr, self.capacity)
        safe_row = jnp.clip(erow_out, 0, self.rows - 1)
        src_row = p[safe_row]
        offset = jnp.arange(self.capacity, dtype=INDEX_DTYPE) - row_ptr[safe_row]
        src = self.row_ptr[src_row] + offset
        valid = erow_out < self.rows
        src = jnp.where(valid, src, self.capacity - 1)
        col = jnp.where(valid, self.col_ind[src], self.ncols)
        val = jnp.where(valid, self.values[src], 0.0)
        return CSR(row_ptr, col.astype(INDEX_DTYPE), val, self.ncols)

    def permute_cols(self, p_t: jax.Array) -> "CSR":
        """M·P with column map: out col = p_t[in col] (CSR::MP semantics).

        ``p_t`` maps old column -> new column.  Result is re-ordered.
        """
        safe = jnp.clip(self.col_ind, 0, self.ncols - 1)
        col = jnp.where(self.entry_valid(), p_t[safe], self.ncols)
        out = CSR(self.row_ptr, col.astype(INDEX_DTYPE), self.values, self.ncols)
        return out.make_ordered()

    def conjugate_permute(self, p: jax.Array) -> "CSR":
        """P·M·Pᵗ (CSR::PMPt): rows by p, cols by inverse of p."""
        p_t = jnp.zeros_like(p).at[p].set(jnp.arange(p.shape[0], dtype=p.dtype))
        return self.permute_rows(p).permute_cols(p_t)

    def row_descending_order_permutation(self) -> jax.Array:
        """Permutation sorting rows by descending nnz
        (CSR::rowDescendingOrderPermutation, CSR.cc:484-494, via the
        paired key/value sort exactly as the reference uses
        key_value_qsort with greaterThanFunction)."""
        from ..ops.segments import key_value_sort

        counts = self.row_counts()
        _, order = key_value_sort(
            counts,
            jnp.arange(self.rows, dtype=INDEX_DTYPE),
            descending=True,
        )
        return order.astype(INDEX_DTYPE)

    # ---- comparators (CSR.h:195-321) ------------------------------------------------
    def is_equal(self, other: "CSR", tol: float = ABS_TOL) -> jax.Array:
        """Exact structural equality + abs tolerance on values (CSR.h:195-245).

        Both sides should be make_ordered() first, as the reference does.
        """
        if self.shape != other.shape:
            return jnp.asarray(False)
        ok = self.nnz == other.nnz
        ok &= jnp.all(self.row_ptr == other.row_ptr)
        va = self.entry_valid()
        vb = other.entry_valid()
        ca = jnp.where(va, self.col_ind, -1)
        cb = jnp.where(vb, other.col_ind, -1)
        n = min(self.capacity, other.capacity)
        ok &= jnp.all(ca[:n] == cb[:n])
        if self.capacity > n:
            ok &= jnp.all(ca[n:] == -1)
        if other.capacity > n:
            ok &= jnp.all(cb[n:] == -1)
        da = jnp.where(va, self.values, 0.0)
        db = jnp.where(vb, other.values, 0.0)
        ok &= jnp.all(jnp.abs(da[:n] - db[:n]) <= tol)
        return ok

    def _drop_explicit_zeros(self) -> "CSR":
        """Compact away entries with value exactly 0 (isRawEqual semantics)."""
        erow = self.entry_rows()
        keep = self.entry_valid() & (self.values != 0)
        key = jnp.where(keep, erow, self.rows)
        key, col, val = jax.lax.sort(
            (key.astype(INDEX_DTYPE), self.col_ind, self.values),
            num_keys=1,
            is_stable=True,
        )
        counts = jnp.bincount(
            jnp.where(key < self.rows, key, self.rows),
            length=self.rows + 1,
        )[: self.rows]
        row_ptr = exclusive_cumsum(counts.astype(INDEX_DTYPE))
        nnz = row_ptr[-1]
        slot = jnp.arange(self.capacity)
        col = jnp.where(slot < nnz, col, self.ncols)
        val = jnp.where(slot < nnz, val, 0.0)
        return CSR(row_ptr.astype(INDEX_DTYPE), col, val, self.ncols)

    def is_raw_equal(self, other: "CSR", tol: float = ABS_TOL) -> jax.Array:
        """Equality ignoring explicitly stored zeros (CSR.h:249-282)."""
        return self._drop_explicit_zeros().is_equal(
            other._drop_explicit_zeros(), tol
        )

    def is_relative_equal(self, other: "CSR", rel: float) -> jax.Array:
        """Structure-equal + relative value tolerance (CSR.h:284-321)."""
        if self.shape != other.shape:
            return jnp.asarray(False)
        ok = self.nnz == other.nnz
        ok &= jnp.all(self.row_ptr == other.row_ptr)
        va = self.entry_valid()
        ca = jnp.where(va, self.col_ind, -1)
        cb = jnp.where(other.entry_valid(), other.col_ind, -1)
        n = min(self.capacity, other.capacity)
        ok &= jnp.all(ca[:n] == cb[:n])
        da = jnp.where(va, self.values, 0.0)[:n]
        db = jnp.where(other.entry_valid(), other.values, 0.0)[:n]
        denom = jnp.maximum(jnp.abs(da), jnp.abs(db))
        ok &= jnp.all(jnp.abs(da - db) <= rel * jnp.maximum(denom, 1e-30))
        return ok

    # ---- diff metrics (CSR.cc:213-240, 381-415) ------------------------------------
    def differs(self, other: "CSR") -> jax.Array:
        """Relative L2 distance ||A - B||_F / ||A||_F over the union pattern
        (CSR::differs analogue, CSR.cc:213-240) — used as the R-MCL
        convergence metric."""
        da = self.to_dense()
        db = other.to_dense()
        num = jnp.sqrt(jnp.sum((da - db) ** 2))
        den = jnp.sqrt(jnp.sum(da**2))
        return num / jnp.maximum(den, 1e-30)

    def row_growth_stats(self, other: "CSR", bounds=( -30.0, -20.0, -5.0, 0.0, 5.0, 20.0, 30.0, 100.0)) -> jax.Array:
        """Histogram of per-row nnz percent change (differsStats analogue,
        CSR.cc:381-415; bucket bounds from qrmcl.cc:17)."""
        ca = self.row_counts().astype(jnp.float32)
        cb = other.row_counts().astype(jnp.float32)
        pct = 100.0 * (cb - ca) / jnp.maximum(ca, 1.0)
        edges = jnp.asarray(bounds, dtype=jnp.float32)
        idx = jnp.searchsorted(edges, pct, side="left")
        return jnp.bincount(idx, length=len(bounds) + 1)

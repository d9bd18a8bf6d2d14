"""SpGEMM: C = A·B with sparse A, B, C — the framework's core op.

Device formulation: **ESC (expand–sort–compress)** over the whole
multiply.  The reference's GPU "mindex2" stream pipeline
(mindex2-cuda/kernel.cu:311-427, tryOutCompute.cu) already uses this shape —
write every partial product to a stream at its flops-prefix offset, sort by
(row, col), reduce duplicates — and it is exactly the formulation that maps
onto an accelerator: the expansion is a pair of gathers driven by a scatter+cumsum,
the sort is a lexicographic device sort, and the compress is a segment-sum.
No per-row hash tables, no serial scatters (the CPU kernels' dense-
accumulator trick, cpu_csr_kernel.h:140-188, does not vectorize).

The two-phase symbolic/numeric API of the CPU kernels
(cpu_csr_kernel.h:63-102: ``*_CSR_IC_nnzC`` then numeric) is preserved as
``spgemm_symbolic`` / ``spgemm``.

Static shapes: callers pass ``product_cap`` (>= total flops) and ``out_cap``
(>= nnz(C)).  ``spgemm_upper_bounds`` computes tight concrete values on
host.  Overflow is detectable: returned ``nnz``/flops are exact.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from .flops import entry_flops
from .segments import (
    exclusive_cumsum,
    repeat_segments,
    segment_boundaries,
)


# ---------------------------------------------------------------------------
# B-side view: lets the expansion consume either a plain CSR or a stack of
# gathered shard blocks (the distributed layer all-gathers the row-sharded
# iterate and exposes it through this view without restitching a CSR).
# ---------------------------------------------------------------------------
class BView(NamedTuple):
    """Row-indexed view of B: flat (col, val) arrays + per-row start/count."""

    col: jax.Array  # int32[flat_cap]
    val: jax.Array  # f32[flat_cap]
    row_start: jax.Array  # int32[rows] index of each row's first entry
    row_count: jax.Array  # int32[rows] entries per row
    ncols: int

    @property
    def rows(self) -> int:
        return self.row_start.shape[0]

    @property
    def capacity(self) -> int:
        return self.col.shape[0]


def bview_from_csr(b: CSR) -> BView:
    return BView(
        col=b.col_ind,
        val=b.values,
        row_start=b.row_ptr[:-1],
        row_count=b.row_counts(),
        ncols=b.ncols,
    )


def bview_from_blocks(row_ptr_blocks, col_blocks, val_blocks, ncols: int) -> BView:
    """View over D stacked local CSR blocks (e.g. a lax.all_gather result).

    ``row_ptr_blocks`` is int32[D, lr+1] of *local* offsets; block d's
    entries live at flat offset ``d * local_cap``.  Padding rows inside a
    block must have count 0 (standard local-CSR padding), so they simply
    never get gathered.
    """
    d, lcap = col_blocks.shape
    offs = (jnp.arange(d, dtype=INDEX_DTYPE) * lcap)[:, None]
    row_start = (row_ptr_blocks[:, :-1] + offs).reshape(-1)
    row_count = (row_ptr_blocks[:, 1:] - row_ptr_blocks[:, :-1]).reshape(-1)
    return BView(
        col=col_blocks.reshape(-1),
        val=val_blocks.reshape(-1),
        row_start=row_start,
        row_count=row_count.astype(INDEX_DTYPE),
        ncols=ncols,
    )


# ---------------------------------------------------------------------------
# expansion
# ---------------------------------------------------------------------------
def esc_expand_view(a: CSR, bv: BView, product_cap: int):
    """Materialise all partial products of A·B into flat streams.

    Returns (prow, pcol, pval) of length ``product_cap`` plus the exact
    product count.  Product q belongs to A entry p (found via scatter+cumsum
    over the flops prefix — the device analogue of the flops-offset array,
    flops.cu:133) and B entry ``bv.row_start[A.col[p]] + (q - start[p])``.
    Slots beyond the true flops hold the (rows, ncols, 0) sentinel.
    """
    safe_col = jnp.clip(a.col_ind, 0, bv.rows - 1)
    ef = jnp.where(
        a.entry_valid(), jnp.take(bv.row_count, safe_col), 0
    ).astype(INDEX_DTYPE)
    starts = exclusive_cumsum(ef)
    total = starts[-1]
    p = repeat_segments(starts[:-1], a.entry_valid() & (ef > 0), product_cap)
    q = jnp.arange(product_cap, dtype=INDEX_DTYPE)
    pvalid = q < total
    safe_p = jnp.clip(p, 0, a.capacity - 1)
    arow = jnp.take(a.entry_rows(), safe_p)
    acol = jnp.take(a.col_ind, safe_p)
    aval = jnp.take(a.values, safe_p)
    t = q - jnp.take(starts, safe_p)
    b_start = jnp.take(bv.row_start, jnp.clip(acol, 0, bv.rows - 1))
    b_idx = jnp.clip(b_start + t, 0, bv.capacity - 1)
    pcol = jnp.take(bv.col, b_idx)
    pval = aval * jnp.take(bv.val, b_idx)
    prow = jnp.where(pvalid, arow, a.rows).astype(INDEX_DTYPE)
    pcol = jnp.where(pvalid, pcol, bv.ncols).astype(INDEX_DTYPE)
    pval = jnp.where(pvalid, pval, 0.0).astype(QVALUE_DTYPE)
    return prow, pcol, pval, total


def esc_expand(a: CSR, b: CSR, product_cap: int):
    """CSR-to-CSR expansion (see esc_expand_view)."""
    return esc_expand_view(a, bview_from_csr(b), product_cap)


def esc_sort(prow, pcol, pval, rows: int):
    """Lexicographic (row, col) sort of the product streams; sentinels sink
    to the tail.  Returns sorted streams + segment-start flags + ids."""
    prow, pcol, pval = jax.lax.sort((prow, pcol, pval), num_keys=2)
    pvalid = prow < rows
    flags = segment_boundaries(prow, pcol, pvalid)
    seg = jnp.cumsum(flags.astype(INDEX_DTYPE)) - 1
    nnzc = jnp.sum(flags.astype(INDEX_DTYPE))
    return prow, pcol, pval, pvalid, flags, seg, nnzc


# ---------------------------------------------------------------------------
# numeric SpGEMM
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("product_cap", "out_cap"))
def spgemm(a: CSR, b: CSR, product_cap: int, out_cap: int) -> CSR:
    """C = A·B.  Exact-duplicate columns are summed; C is ordered by
    construction (rows ascending, cols ascending within rows).

    If out_cap < nnz(C) the trailing segments are dropped (detect via
    ``spgemm_symbolic``); if product_cap < flops the trailing products are
    dropped — both are caller-checked capacity bugs, like undersizing
    malloc in the reference.
    """
    assert a.ncols == b.rows, "inner dimensions must match"
    m, n = a.rows, b.ncols
    prow, pcol, pval, _ = esc_expand(a, b, product_cap)
    prow, pcol, pval, pvalid, flags, seg, _ = esc_sort(prow, pcol, pval, m)
    seg = jnp.where(pvalid, seg, out_cap)  # out-of-range -> dropped scatter
    cval = jnp.zeros((out_cap,), QVALUE_DTYPE).at[seg].add(pval, mode="drop")
    crow = jnp.full((out_cap,), m, INDEX_DTYPE).at[seg].min(prow, mode="drop")
    ccol = jnp.full((out_cap,), n, INDEX_DTYPE).at[seg].min(pcol, mode="drop")
    row_ptr = jnp.searchsorted(crow, jnp.arange(m + 1, dtype=INDEX_DTYPE)).astype(
        INDEX_DTYPE
    )
    return CSR(row_ptr, ccol, cval, n)


@partial(jax.jit, static_argnames=("product_cap",))
def spgemm_symbolic(a: CSR, b: CSR, product_cap: int):
    """Symbolic phase: exact per-row nnz of C and total nnz(C), without
    touching values (parity with ``*_CSR_IC_nnzC``, cpu_csr_kernel.h:63-102
    and gpu_CSR_IC_nnzC, gpu_csr_kernel.cu:44-82).

    Returns (row_ptr, nnzc, flops_total).
    """
    assert a.ncols == b.rows
    m = a.rows
    prow, pcol, pval, total = esc_expand(a, b, product_cap)
    prow, pcol = jax.lax.sort((prow, pcol), num_keys=2)
    pvalid = prow < m
    flags = segment_boundaries(prow, pcol, pvalid)
    counts = (
        jnp.zeros((m + 1,), INDEX_DTYPE)
        .at[prow]
        .add(flags.astype(INDEX_DTYPE), mode="drop")
    )[:m]
    row_ptr = exclusive_cumsum(counts).astype(INDEX_DTYPE)
    return row_ptr, row_ptr[-1], total


# ---------------------------------------------------------------------------
# capacity planning + convenience wrapper (host side)
# ---------------------------------------------------------------------------
def spgemm_upper_bounds(a: CSR, b: CSR) -> tuple[int, int]:
    """Concrete (product_cap, out_cap) on host: exact flops, out bounded by
    flops (int64 math; the device path is int32 — ~2^31 products already
    exceeds a single chip's ESC memory, so this is not the binding limit)."""
    b_counts = np.asarray(b.row_counts(), dtype=np.int64)
    col = np.asarray(a.col_ind)
    valid = np.asarray(a.entry_valid())
    safe = np.clip(col, 0, b.rows - 1)
    flops = int(np.where(valid, b_counts[safe], 0).sum())
    flops = max(flops, 1)
    return flops, flops


def matmul(a: CSR, b: CSR, out_cap: int | None = None) -> CSR:
    """Host-facing one-shot C = A·B with automatic capacity planning
    (the CSR::spmm façade, CSR.cc:59-71)."""
    product_cap, bound = spgemm_upper_bounds(a, b)
    if out_cap is None:
        out_cap = bound
    return spgemm(a, b, product_cap, int(out_cap))


def spgemm_dense_oracle(a: CSR, b: CSR) -> CSR:
    """Trivially-correct dense reference (the SEQ oracle role,
    cpu_csr_kernel.cc:76-119): densify, matmul, re-sparsify on host."""
    da = np.asarray(a.to_dense(), dtype=np.float64)
    db = np.asarray(b.to_dense(), dtype=np.float64)
    dc = da @ db
    # keep structural zeros out (matches ESC: only realised products appear);
    # products that cancel to exactly 0.0 remain absent from the oracle via
    # the pattern product.
    pattern = (np.abs(da) > 0).astype(np.float64) @ (np.abs(db) > 0).astype(
        np.float64
    )
    dc[pattern == 0] = 0.0
    out = CSR.from_dense(np.where(pattern > 0, dc, 0.0).astype(np.float32))
    return out

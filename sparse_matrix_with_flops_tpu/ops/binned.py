"""Flops-binned SpGEMM — the framework's namesake kernel strategy.

Device re-design of the reference's two binned SpGEMM engines:

* CPU ``group_CSR_SpMM`` (group_csr_kernel.cc:10-52): rows bucketed by
  flops into groups, each group dispatched with its own schedule;
* GPU "mindex2" (flops.cu:39-47, gnnz.cuh:19-70, gspgemm.cuh): rows sorted
  by flops, binned {f=1, 2-4, 5-16, ...}, each bin launched with a
  differently-shaped kernel (thread/sub-warp/warp/block per row) and a
  per-bin accumulator (sorting network / shared-mem hash / bitonic ESC).

Translation: a *bin* is a dense padded tile ``[R, W]`` of partial
products (rows of similar flops share a power-of-two lane width W — the
ELL-style padding that keeps shapes static).  Per bin:

1. gather the bin rows' products from the row-major expansion streams
   (the flops-offset array of flops.cu:133 gives each row a contiguous
   product range — no global sort needed, unlike the plain ESC pipeline);
2. sort each row along lanes (one minor-axis `lax.sort` over the whole
   tile — the vectorized counterpart of the per-row bitonic networks in
   tryOutCompute.cu:97-255);
3. dedup by run boundaries + lane-wise cumsum differences (the
   ReduceByKey, kernel.cu:248);
4. scatter each row's compacted entries to its slot in the output CSR.

Rows whose flops exceed the largest bin width are handled by the global
ESC sort restricted to their products (the 'olarge' escape hatch,
mindex2-cuda/\\:23-143).

The bin *plan* (which rows, which widths, how many) is computed host-side
from the per-row flops estimate — the reference does the same classify on
device then copies bin boundaries back to launch kernels
(flops.cu:171, nGpuSpMM.cc:48-83); under XLA the boundaries must be static,
so the classify runs on host once per sparsity structure.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from .segments import exclusive_cumsum
from .spgemm import esc_expand, esc_sort


DEFAULT_BIN_WIDTHS = (16, 64, 256, 1024, 4096)


@dataclasses.dataclass(frozen=True, eq=False)
class BinPlan:
    """Static per-structure dispatch plan (host-computed).

    ``bins``: tuple of (row_ids, width) — row_ids is an int32[R_b] numpy
    array (padded with -1 to a multiple of 8) of rows whose flops fit in
    ``width`` lanes.  ``huge_rows``: rows overflowing the largest width.

    Used as a jit static argument: hashed/compared by identity (build one
    plan per sparsity structure and reuse it — recompiles per plan object).
    """

    __hash__ = object.__hash__

    bins: tuple  # ((np.ndarray[R], W), ...)
    huge_rows: np.ndarray  # int32[.]
    huge_product_cap: int
    product_cap: int
    out_cap: int
    rows: int

    @property
    def num_bins(self) -> int:
        return len(self.bins)


def plan_bins(
    a: CSR,
    b: CSR,
    widths: tuple = DEFAULT_BIN_WIDTHS,
    out_cap: int | None = None,
) -> BinPlan:
    """Classify rows by flops into power-of-two lane widths (host side).

    Mirrors gpuFlopsClassify (flops.cu:110-140) + the CPU classifier
    (nGpuSpMM.cc:48-83), with static output: numpy row-id lists per bin.
    """
    b_counts = np.asarray(b.row_counts(), dtype=np.int64)
    col = np.asarray(a.col_ind)
    rp = np.asarray(a.row_ptr, dtype=np.int64)
    nnz = int(rp[-1])
    ef = b_counts[np.clip(col[:nnz], 0, b.rows - 1)]
    rf = np.zeros(a.rows, dtype=np.int64)
    np.add.at(rf, np.repeat(np.arange(a.rows), np.diff(rp)), ef)

    total = int(rf.sum())
    bins = []
    lo = 1
    for w in widths:
        sel = np.nonzero((rf >= lo) & (rf <= w))[0]
        lo = w + 1
        if sel.size == 0:
            continue
        pad = (-sel.size) % 8
        sel = np.concatenate([sel, np.full(pad, -1, dtype=sel.dtype)])
        bins.append((sel.astype(np.int32), int(w)))
    huge = np.nonzero(rf > widths[-1])[0].astype(np.int32)
    huge_cap = int(rf[huge].sum()) if huge.size else 1
    return BinPlan(
        bins=tuple(bins),
        huge_rows=huge,
        huge_product_cap=max(huge_cap, 1),
        product_cap=max(total, 1),
        out_cap=max(total, 1) if out_cap is None else int(out_cap),
        rows=a.rows,
    )


def _bin_tile_dedup(cols: jax.Array, vals: jax.Array, ncols: int):
    """Sort+dedup each row of a [R, W] product tile along lanes.

    Returns (sorted-unique cols [R, W], summed vals [R, W], per-row count).
    Padding lanes hold (ncols, 0) and sort to the tail.
    """
    cols, vals = jax.lax.sort((cols, vals), dimension=1, num_keys=1)
    valid = cols < ncols
    first = jnp.concatenate(
        [valid[:, :1], (cols[:, 1:] != cols[:, :-1]) & valid[:, 1:]], axis=1
    )
    w = cols.shape[1]
    run_id = jnp.cumsum(first.astype(INDEX_DTYPE), axis=1) - 1  # id per lane
    counts = jnp.sum(first, axis=1).astype(INDEX_DTYPE)  # uniques per row
    run_tgt = jnp.where(valid, run_id, w)
    rix = jax.lax.broadcasted_iota(INDEX_DTYPE, cols.shape, 0)
    run_vals = (
        jnp.zeros(cols.shape, QVALUE_DTYPE)
        .at[rix, run_tgt]
        .add(vals, mode="drop")
    )
    run_cols = (
        jnp.full(cols.shape, ncols, INDEX_DTYPE)
        .at[rix, run_tgt]
        .min(cols, mode="drop")
    )
    return run_cols, run_vals, counts


def _gather_bin_products(
    row_ids: jax.Array,
    width: int,
    pcol: jax.Array,
    pval: jax.Array,
    row_off: jax.Array,
    rf: jax.Array,
    ncols: int,
):
    """[R, W] product tile for the bin's rows from the row-major streams."""
    r = row_ids.shape[0]
    ok_row = row_ids >= 0
    safe_rows = jnp.clip(row_ids, 0, row_off.shape[0] - 2)
    base = jnp.take(row_off, safe_rows)
    lens = jnp.take(rf, safe_rows)
    lanes = jax.lax.broadcasted_iota(INDEX_DTYPE, (r, width), 1)
    idx = base[:, None] + lanes
    valid = ok_row[:, None] & (lanes < lens[:, None])
    idx = jnp.clip(idx, 0, pcol.shape[0] - 1)
    cols = jnp.where(valid, jnp.take(pcol, idx), ncols).astype(INDEX_DTYPE)
    vals = jnp.where(valid, jnp.take(pval, idx), 0.0).astype(QVALUE_DTYPE)
    return cols, vals


def _row_flops_device(a: CSR, b: CSR):
    from .flops import row_flops

    return row_flops(a, b)


@partial(jax.jit, static_argnames=("plan",))
def spgemm_binned(a: CSR, b: CSR, plan: BinPlan) -> CSR:
    """C = A·B via the binned pipeline; semantics identical to
    :func:`..ops.spgemm.spgemm` (ordered rows, summed duplicates)."""
    assert a.ncols == b.rows
    m, n = a.rows, b.ncols
    # row-major product streams — expansion only, no global sort
    prow, pcol, pval, _total = esc_expand(a, b, plan.product_cap)
    rf = _row_flops_device(a, b).astype(INDEX_DTYPE)
    row_off = exclusive_cumsum(rf)

    # per-row output counts, filled in bin by bin
    counts = jnp.zeros((m,), INDEX_DTYPE)
    bin_results = []
    for row_ids_np, w in plan.bins:
        row_ids = jnp.asarray(row_ids_np)
        cols, vals = _gather_bin_products(
            row_ids, w, pcol, pval, row_off, rf, n
        )
        ucols, uvals, ucnt = _bin_tile_dedup(cols, vals, n)
        tgt = jnp.where(row_ids >= 0, row_ids, m)
        counts = counts.at[tgt].add(
            jnp.where(row_ids >= 0, ucnt, 0), mode="drop"
        )
        bin_results.append((row_ids, ucols, uvals, ucnt))

    # huge rows: global-sort ESC restricted to their products
    if plan.huge_rows.size:
        hrows = jnp.asarray(plan.huge_rows)
        hmask = jnp.zeros((m + 1,), bool).at[hrows].set(True)
        sel = jnp.take(hmask, jnp.clip(prow, 0, m))
        hrow = jnp.where(sel, prow, m).astype(INDEX_DTYPE)
        hcol = jnp.where(sel, pcol, n).astype(INDEX_DTYPE)
        hval = jnp.where(sel, pval, 0.0)
        hrow, hcol, hval, hvalid, hflags, hseg, _ = esc_sort(
            hrow, hcol, hval, m
        )
        hcnt = (
            jnp.zeros((m + 1,), INDEX_DTYPE)
            .at[hrow]
            .add(hflags.astype(INDEX_DTYPE), mode="drop")[:m]
        )
        counts = counts + hcnt
    # output assembly
    out_rp = exclusive_cumsum(counts).astype(INDEX_DTYPE)
    out_rp = jnp.minimum(out_rp, plan.out_cap)
    ccol = jnp.full((plan.out_cap,), n, INDEX_DTYPE)
    cval = jnp.zeros((plan.out_cap,), QVALUE_DTYPE)
    for row_ids, ucols, uvals, ucnt in bin_results:
        r, w = ucols.shape
        lanes = jax.lax.broadcasted_iota(INDEX_DTYPE, (r, w), 1)
        ok = (row_ids[:, None] >= 0) & (lanes < ucnt[:, None])
        base = jnp.take(out_rp, jnp.clip(row_ids, 0, m - 1))
        tgt = jnp.where(ok, base[:, None] + lanes, plan.out_cap)
        ccol = ccol.at[tgt.reshape(-1)].min(ucols.reshape(-1), mode="drop")
        cval = cval.at[tgt.reshape(-1)].add(uvals.reshape(-1), mode="drop")
    if plan.huge_rows.size:
        # compact huge-row segments to their output slots
        useg = jnp.where(hvalid & hflags, 1, 0)
        # unique index within the row = running uniques minus the row's
        # unique offset (all products of a run share it -> adds accumulate)
        upos = jnp.cumsum(useg) - jnp.take(
            exclusive_cumsum(hcnt), jnp.clip(hrow, 0, m - 1)
        )
        base = jnp.take(out_rp, jnp.clip(hrow, 0, m - 1))
        utgt = jnp.where(hvalid, base + (upos - 1), plan.out_cap)
        ccol = ccol.at[utgt].min(hcol, mode="drop")
        cval = cval.at[utgt].add(hval, mode="drop")
    return CSR(out_rp, ccol, cval, n)

"""R-MCL row math: inflation, threshold pruning, renormalisation.

Semantics mirror the reference exactly (values are float32 / QValue):

* inflation: v <- v*v                      (arrayInflationR2, util.cc:41-45)
* threshold: t = 0.90·avg·(1 − 2·(max−avg)), clamped to [1e-7, max]
                                           (computeThreshold, util.cc:4-9)
  where avg = (row sum of inflated values) / (row count incl. explicit
  zeros) and max is the row max of inflated values.
* prune+normalize: keep entries with inflated value >= t, then divide the
  kept (inflated) values by their sum  (arrayThreshPruneNormalize,
  util.cc:47-69).

Device formulation: everything is a segment reduction over the entry streams
(rows are segments), followed by one stable sort to compact survivors —
no per-row loops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import (
    INDEX_DTYPE,
    MLMCL_PRUNE_A,
    MLMCL_PRUNE_B,
    PRUNE_FLOOR,
    QVALUE_DTYPE,
)
from ..formats.csr import CSR
from .segments import exclusive_cumsum


def compute_threshold(avg: jax.Array, rmax: jax.Array) -> jax.Array:
    """Vectorised computeThreshold (util.cc:4-9)."""
    t = MLMCL_PRUNE_A * avg * (1.0 - MLMCL_PRUNE_B * (rmax - avg))
    t = jnp.maximum(t, PRUNE_FLOOR)
    return jnp.minimum(t, rmax)


def inflate_prune_normalize_stream(
    erow: jax.Array,
    col: jax.Array,
    val: jax.Array,
    valid: jax.Array,
    rows: int,
    ncols: int,
    out_cap: int,
):
    """Fused inflate→threshold→prune→normalize over entry streams.

    ``erow`` must be non-decreasing over valid entries (CSR entry order) with
    sentinel ``rows`` on padding.  Returns (row_ptr, col, val, overflow)
    where the survivors are compacted to the front in (row, col) order and
    padded out to ``out_cap``; ``overflow`` flags survivors > out_cap.

    This is the kernel the reference fuses into its SpGEMM numeric phase
    (omp_CSR_RMCL_OneStep, omp_csr_kernel.cc:154-198; GPU analogue
    gpuRmclOneStepKernel, gpu_csr_kernel.cu:175-234).
    """
    cap = erow.shape[0]
    seg = jnp.where(valid, erow, rows).astype(INDEX_DTYPE)
    w = jnp.where(valid, val * val, 0.0).astype(QVALUE_DTYPE)  # inflation

    nseg = rows + 1
    rsum = jax.ops.segment_sum(w, seg, num_segments=nseg)[:rows]
    rmax = jnp.zeros((nseg,), QVALUE_DTYPE).at[seg].max(w, mode="drop")[:rows]
    rcount = jax.ops.segment_sum(
        valid.astype(QVALUE_DTYPE), seg, num_segments=nseg
    )[:rows]
    avg = rsum / jnp.maximum(rcount, 1.0)
    thresh = compute_threshold(avg, rmax)

    keep = valid & (w >= jnp.take(thresh, jnp.clip(erow, 0, rows - 1)))
    ksum = jax.ops.segment_sum(jnp.where(keep, w, 0.0), seg, num_segments=nseg)[
        :rows
    ]
    denom = jnp.take(jnp.maximum(ksum, PRUNE_FLOOR * 0.0 + 1e-30), jnp.clip(erow, 0, rows - 1))
    newval = jnp.where(keep, w / denom, 0.0).astype(QVALUE_DTYPE)

    # compact survivors: stable sort on keep-aware row key preserves column
    # order within each row (matrix_relocation / omp_matrix_relocation
    # analogue, cpu_csr_kernel.h:206-228, omp_csr_kernel.cc:201-236).
    key = jnp.where(keep, erow, rows).astype(INDEX_DTYPE)
    key, scol, sval = jax.lax.sort((key, col, newval), num_keys=1, is_stable=True)

    counts = jax.ops.segment_sum(
        keep.astype(INDEX_DTYPE), seg, num_segments=nseg
    )[:rows]
    row_ptr = exclusive_cumsum(counts).astype(INDEX_DTYPE)
    total = row_ptr[-1]
    overflow = total > out_cap

    slot = jnp.arange(out_cap, dtype=INDEX_DTYPE)
    take = jnp.minimum(slot, cap - 1)
    ocol = jnp.where(slot < total, jnp.take(scol, take), ncols).astype(INDEX_DTYPE)
    oval = jnp.where(slot < total, jnp.take(sval, take), 0.0).astype(QVALUE_DTYPE)
    row_ptr = jnp.minimum(row_ptr, out_cap)
    return row_ptr, ocol, oval, overflow


@partial(jax.jit, static_argnames=("out_cap",))
def prune_normalize(c: CSR, out_cap: int | None = None):
    """Unfused prune pass over an existing CSR (the SFOMP path,
    static_fair_CSR_RMCL_OneStep, static_omp_csr_kernel.cc:286-321).

    Returns (CSR, overflow flag)."""
    cap = c.capacity if out_cap is None else out_cap
    row_ptr, col, val, overflow = inflate_prune_normalize_stream(
        c.entry_rows(), c.col_ind, c.values, c.entry_valid(), c.rows, c.ncols, cap
    )
    return CSR(row_ptr, col, val, c.ncols), overflow

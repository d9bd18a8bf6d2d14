"""Segment / scan primitives shared by the sparse kernels.

These are the device equivalents of the reference's L0 scan toolbox
(``nlibs/tools/prefixSum.{h,cc}``, ``prefixSum64.*`` and the equal-cost
partitioner ``arrayEqualPartition`` in ``nlibs/tools/util.cc:123-149``).
Everything here is shape-static and jit-friendly: prefix sums are XLA
``cumsum``; the "repeat each segment by its length" expansion used by the
ESC SpGEMM is a scatter + cumsum (no per-row loops, no dynamic shapes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import INDEX_DTYPE


def exclusive_cumsum(x: jax.Array) -> jax.Array:
    """Exclusive prefix sum with the total appended: len(out) == len(x) + 1.

    Mirror of ``seqPrefixSum`` / ``noTileOmpPrefixSum`` (prefixSum.h:11-20,
    prefixSum.cc:31-61): ``out[i] = sum(x[:i])``, ``out[-1] = sum(x)``.
    """
    z = jnp.zeros((1,), dtype=x.dtype)
    return jnp.concatenate([z, jnp.cumsum(x)])


def entry_rows(row_ptr: jax.Array, capacity: int) -> jax.Array:
    """Row id of every entry slot of a CSR array, sentinel ``rows`` for padding.

    For slot q in [0, capacity): the row i with row_ptr[i] <= q < row_ptr[i+1],
    or ``rows`` (= len(row_ptr) - 1) if q >= nnz (padding).  This is the
    vectorized inverse of the reference's per-row loops over
    ``rowPtr[i]..rowPtr[i+1]`` (e.g. cpu_csr_kernel.h:140-188).

    Scatter + cumsum, NOT searchsorted: rid[q] = #{i >= 1 : row_ptr[i] <= q}
    via a +1 delta at every row start — m scattered writes plus one
    bandwidth-bound scan instead of a binary search per slot.
    """
    rows = row_ptr.shape[0] - 1
    d = jnp.zeros((capacity,), INDEX_DTYPE)
    d = d.at[row_ptr[1:]].add(1, mode="drop")
    rid = jnp.cumsum(d)
    q = jnp.arange(capacity, dtype=row_ptr.dtype)
    return jnp.where(q < row_ptr[-1], rid, rows).astype(INDEX_DTYPE)


def repeat_segments(starts: jax.Array, valid: jax.Array, total: int) -> jax.Array:
    """Map output position q in [0, total) to the segment index it belongs to.

    ``starts[p]`` is the exclusive prefix-sum offset of segment p (only
    segments with ``valid[p]`` participate; valid segments must have
    nonzero length so their starts are distinct).  Implemented as a
    scatter-max of segment ids at their start positions followed by a
    running max — O(total), no binary search, and zero-length/invalid
    segments are skipped because nothing is scattered for them.
    """
    num = starts.shape[0]
    seg_plus1 = jnp.where(valid, jnp.arange(num, dtype=INDEX_DTYPE) + 1, 0)
    idx = jnp.where(valid, starts, total)  # invalid -> dropped scatter
    marks = jnp.zeros((total,), dtype=INDEX_DTYPE).at[idx].max(
        seg_plus1, mode="drop"
    )
    return jax.lax.cummax(marks) - 1


def segment_boundaries(keys_a: jax.Array, keys_b: jax.Array, valid: jax.Array) -> jax.Array:
    """Flags marking the first element of each (keys_a, keys_b) run.

    Inputs must already be lexicographically sorted.  Invalid (padding)
    elements never start a segment.
    """
    first = jnp.ones((1,), dtype=bool)
    diff = (keys_a[1:] != keys_a[:-1]) | (keys_b[1:] != keys_b[:-1])
    return jnp.concatenate([first, diff]) & valid


def equal_partition(prefix_sum: jax.Array, num_parts: int) -> jax.Array:
    """Split [0, n) into ``num_parts`` contiguous ranges of ~equal cost.

    ``prefix_sum`` has length n+1 with prefix_sum[0] == 0 and
    prefix_sum[n] == total cost.  Returns ``ends`` of length num_parts+1 with
    ends[0] == 0 and ends[-1] == n.  Parity with ``arrayEqualPartition``
    (util.cc:137-149), except ranges are not forced non-empty (XLA grids
    tolerate empty tiles; the C version needed >=1 row per thread).
    """
    n = prefix_sum.shape[0] - 1
    total = prefix_sum[n]
    chunk = (total + num_parts - 1) // num_parts
    targets = chunk * jnp.arange(1, num_parts, dtype=prefix_sum.dtype)
    targets = jnp.minimum(targets, total)
    mids = jnp.searchsorted(prefix_sum, targets, side="right").astype(INDEX_DTYPE) - 1
    mids = jnp.clip(mids, 0, n)
    zero = jnp.zeros((1,), dtype=INDEX_DTYPE)
    last = jnp.full((1,), n, dtype=INDEX_DTYPE)
    return jnp.concatenate([zero, mids, last])


def prefix_sum_to_counts(prefix_sum: jax.Array) -> jax.Array:
    """Inverse of exclusive_cumsum (util.cc:117-121)."""
    return prefix_sum[1:] - prefix_sum[:-1]


def segment_sum(values: jax.Array, segment_ids: jax.Array, num_segments: int) -> jax.Array:
    return jax.ops.segment_sum(values, segment_ids, num_segments=num_segments)


def segment_max(values: jax.Array, segment_ids: jax.Array, num_segments: int) -> jax.Array:
    return jax.ops.segment_max(values, segment_ids, num_segments=num_segments)


def key_value_sort(keys: jax.Array, values: jax.Array, descending: bool = False):
    """Paired sort (key_value_qsort.h:14-42 parity).

    The reference's templated quicksort with pluggable comparators becomes
    one device sort; ``descending=True`` matches ``greaterThanFunction``
    (used by rowDescendingOrderPermutation, CSR.cc:484-494).
    """
    k = -keys if descending else keys
    k, v = jax.lax.sort((k, values), num_keys=1, is_stable=True)
    return (-k if descending else k), v


def sort_dedup_rows(tc: jax.Array, tv: jax.Array, sentinel: int):
    """Per row of an ``[R, W]`` product tile: sort by column, sum each run
    of equal columns, compact the run totals to the front.

    Returns ``(cols, vals)`` of the same shape; the tail holds
    ``sentinel`` / 0.0, and input lanes with ``col >= sentinel`` are
    padding.  Run totals come from a segmented scan that restarts at every
    run, so each total carries the rounding of its own run only (a
    difference of two whole-row prefix sums would carry the rounding of
    the row's running total).  This is the ESC sort-compress shared by the
    SpGEMM tiles and the R-MCL steps (kernel.cu:248 ReduceByKey role)."""
    tc, tv = jax.lax.sort((tc, tv), dimension=1, num_keys=1)
    r = tc.shape[0]
    first = jnp.concatenate(
        [jnp.ones((r, 1), bool), tc[:, 1:] != tc[:, :-1]], axis=1
    )

    def seg_add(x, y):
        sx, vx = x
        sy, vy = y
        return sx | sy, jnp.where(sy, vy, vx + vy)

    _, runsum = jax.lax.associative_scan(seg_add, (first, tv), axis=1)
    nxt = jnp.concatenate(
        [tc[:, 1:], jnp.full((r, 1), sentinel, tc.dtype)], axis=1
    )
    is_last = (tc != nxt) & (tc < sentinel)
    key = jnp.where(is_last, tc, sentinel)
    key, uval = jax.lax.sort((key, runsum), dimension=1, num_keys=1)
    return key, jnp.where(key < sentinel, uval, 0.0)

"""Flops estimation, histograms and row binning — the framework's namesake.

The central idea of the reference ("with_Flops"): estimate the per-row cost
of C = A·B up front, ``rowFlops[i] = Σ_{j in A[i,:]} nnz(B[j,:])``, and use
it to (a) load-balance (equal-flops partitioning, util.cc:123-149;
static_omp_csr_kernel.cc:119-141) and (b) bin rows by cost and dispatch
differently-shaped kernels (mindex2-cuda/flops.cu:39-47,110-140).

Device translation: the estimate is one gather + one segment-sum; binning is a
device-side sort + histogram (no host round trips), which then drives the
chunked/binned SpGEMM grids.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FLOPS_BIN_BOUNDS, INDEX_DTYPE
from ..formats.csr import CSR
from ..ops.segments import exclusive_cumsum


def entry_flops(a: CSR, b: CSR) -> jax.Array:
    """Per-A-entry product count: nnz of the B row each A entry touches.

    Padding entries contribute 0.  (The innermost quantity behind
    ``getSpMMFlops``, cpu_csr_kernel.cc:58-72.)
    """
    b_counts = b.row_counts()
    safe_col = jnp.clip(a.col_ind, 0, b.rows - 1)
    lens = jnp.take(b_counts, safe_col)
    return jnp.where(a.entry_valid(), lens, 0).astype(INDEX_DTYPE)


def row_flops(a: CSR, b: CSR) -> jax.Array:
    """Per-row single-count flops of C = A·B (flops.cu:65-83 analogue)."""
    ef = entry_flops(a, b)
    erow = a.entry_rows()
    return jax.ops.segment_sum(ef, erow, num_segments=a.rows + 1)[: a.rows]


def spgemm_flops(a: CSR, b: CSR) -> tuple[jax.Array, jax.Array]:
    """(per-row flops, total) single-count ("Oflops").

    The reference reports both single-count (bin_analysis) and double-count
    (×2 for multiply+add, ``flops= ...`` in tools/res.txt); callers multiply
    by 2 for GFLOPS accounting (perfTests/only-somp.cc:36-37).
    """
    rf = row_flops(a, b)
    return rf, jnp.sum(rf)


class FlopsBinning(NamedTuple):
    """Rows sorted by flops with bin boundaries — device-side counterpart of
    gpuFlopsClassify (flops.cu:110-140)."""

    sorted_rows: jax.Array  # int32[m] row ids, ascending flops
    sorted_flops: jax.Array  # int32[m]
    flops_offsets: jax.Array  # int32[m+1] exclusive prefix of sorted_flops
    bin_starts: jax.Array  # int32[nbins+1] boundaries into sorted_rows


def flops_bin_id(flops: jax.Array) -> jax.Array:
    """Map row flops -> bin id 1..7 per the reference bins
    {1: f=0, 2: f=1, 3: 2-4, 4: 5-16, 5: 17-64, 6: 65-512, 7: >512}
    (flops.cu:39-47)."""
    bounds = jnp.asarray(FLOPS_BIN_BOUNDS, dtype=flops.dtype)
    return (
        jnp.searchsorted(bounds, flops, side="left").astype(INDEX_DTYPE) + 1
    )


def classify_flops(a: CSR, b: CSR) -> FlopsBinning:
    """Sort rows by flops and compute bin boundaries, all on device.

    Mirrors the gpuFlopsClassify pipeline: per-row flops -> stable sort
    (rows by flops) -> inclusive scan of sorted flops (exact output slot per
    product) -> histogram of bin ids via searchsorted (flops.cu:96-140).
    """
    rf = row_flops(a, b)
    rows = jnp.arange(a.rows, dtype=INDEX_DTYPE)
    sorted_flops, sorted_rows = jax.lax.sort((rf, rows), num_keys=1, is_stable=True)
    offsets = exclusive_cumsum(sorted_flops)
    # bin b covers flops in (bounds[b-1], bounds[b]]; boundaries via
    # searchsorted on the sorted flops array.
    bounds = jnp.asarray((0,) + FLOPS_BIN_BOUNDS, dtype=sorted_flops.dtype)
    starts = jnp.searchsorted(sorted_flops, bounds, side="right").astype(INDEX_DTYPE)
    # bin_starts[0]=0 rows with f<=0 start at 0
    zero = jnp.zeros((1,), INDEX_DTYPE)
    last = jnp.full((1,), a.rows, INDEX_DTYPE)
    bin_starts = jnp.concatenate([zero, starts[:-1], last])
    return FlopsBinning(sorted_rows, sorted_flops, offsets, bin_starts)


# ---- histograms (stats.cc parity) ------------------------------------------------


def log2_histogram(x: jax.Array, num_buckets: int = 13) -> jax.Array:
    """Log2-bucket histogram: bucket k counts values in [2^(k-1), 2^k), with
    bucket 0 counting zeros/ones (pushToStats + flopsStats semantics,
    stats.cc:3-57)."""
    xf = jnp.maximum(x.astype(jnp.float32), 1.0)
    k = jnp.ceil(jnp.log2(xf)).astype(jnp.int32)
    k = jnp.clip(k, 0, num_buckets - 1)
    return jnp.bincount(k, length=num_buckets)


def flops_stats(a: CSR, b: CSR, num_buckets: int = 13):
    """Per-row flops histogram (flopsStats, stats.cc:29-57)."""
    rf = row_flops(a, b)
    return log2_histogram(rf, num_buckets), rf


def nnz_stats(c: CSR, num_buckets: int = 13):
    """Per-row nnz histogram (CSR::nnzStats, CSR.cc:242-249)."""
    return log2_histogram(c.row_counts(), num_buckets)


def print_stats(hist, title: str = "stats") -> None:
    """Textual histogram like outputStats (stats.cc:14-27)."""
    hist = np.asarray(hist)
    total = hist.sum()
    print(f"=== {title} (total {total}) ===")
    lo = 0
    for k, cnt in enumerate(hist):
        hi = 1 << k
        if cnt:
            print(f"  [{lo:>8} .. {hi:>8}): {cnt}")
        lo = hi


def footprint_row_costs(
    a: CSR, b: CSR, chunk: int | None = None
) -> np.ndarray:
    """Per-row partition cost with memory-footprint terms (host, int64).

    The reference's flagship partitions on *footprints*, not raw flops:
    ``(flops + cnnz + 32 + annz) >> 1`` per row
    (static_omp_csr_kernel.cc:28-62, footPrintsCrowiCount) — an
    output-write term and an A-read term on top of the multiply count.
    The ELL pipeline's cost unit is the padded tile chunk (its cost
    model takes kernel time ~ padded slots / chunk, untuned on the H100,
    see ROADMAP queue 1 #7), so this modernizes each term:

    * flops        -> padded descriptor slots (snap-to-lattice per entry)
    * cnnz (exact) -> min(flops, ncols) upper bound (the flat-cap law)
    * annz, +32    -> unchanged

    On cant-class (flops/cnnz ≈ 31) vs power-law (≈ 1.8) the flops-only
    estimate mis-ranks per-row cost by up to ~17x (VERDICT r3 #2).
    """
    from ..utils.nphost import csr_host, segment_sums, snap_chunks_arr

    rp, ci_all = csr_host(a)
    nnz = int(rp[-1])
    ci = ci_all[:nnz]
    bcnt = np.diff(csr_host(b)[0])
    elen = bcnt[np.clip(ci, 0, b.rows - 1)]
    if chunk is None:
        from .ell_esc import MAX_W, auto_chunk

        chunk = auto_chunk(elen, rp, b.ncols, MAX_W)
    maxlen = int(elen.max()) if elen.size else 0
    lens = np.arange(maxlen + 1, dtype=np.int64)
    wtbl = snap_chunks_arr(-(-lens // chunk)) * chunk
    wtbl[0] = 0
    pad_slots = segment_sums(wtbl[elen.astype(np.int32, copy=False)], rp)
    row_fl = segment_sums(elen, rp)
    annz = np.diff(rp)
    cnnz_est = np.minimum(row_fl, int(b.ncols))
    return pad_slots + cnnz_est + annz + 32

"""Row-partitioned SpGEMM driver: flat-CSR output at scales where the
single-dispatch pipeline's intermediates exceed one device's memory.

The ELL-ESC tiles phase materialises O(padded flops) intermediates and
the assembly a further O(nnz C) window source.  This driver splits A's
rows into flops-balanced groups, runs the full pipeline per group (each
its own dispatch, so peak device memory is the largest group's), and
stitches the per-group flat CSRs on the host.

It is the reference's private-output + stitch parallelism (P5,
/root/reference/original-matrix-perf/mvcsr.cc:124-226: per-thread PCSR
blocks concatenated after the fact) re-cut for the device memory limit:
the same flops-balanced partition law (P2, scost dealing), but applied
sequentially to bound MEMORY rather than concurrently to split time.
B stays device-resident across groups.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..utils.nphost import csr_host, segment_sums
from .ell_esc import plan_ell, spgemm_ell


def csr_row_slice(a: CSR, r0: int, r1: int) -> CSR:
    """Host-side row slice a[r0:r1, :] as a tight CSR."""
    rp = np.asarray(a.row_ptr)
    e0, e1 = int(rp[r0]), int(rp[r1])
    return CSR(
        jnp.asarray(rp[r0 : r1 + 1] - e0, dtype=INDEX_DTYPE),
        jnp.asarray(np.asarray(a.col_ind[e0:e1]), dtype=INDEX_DTYPE),
        jnp.asarray(np.asarray(a.values[e0:e1]), dtype=QVALUE_DTYPE),
        a.ncols,
    )


def csr_vstack(blocks: list[CSR], ncols: int) -> CSR:
    """Stack row blocks into one CSR (host arrays — the result may be
    bigger than device memory; ``jax.device_put`` it if it fits)."""
    rps, cis, vs = [np.zeros(1, np.int32)], [], []
    base = 0
    for blk in blocks:
        rp = np.asarray(blk.row_ptr)
        nnz = int(rp[-1])
        rps.append(rp[1:] + base)
        cis.append(np.asarray(blk.col_ind[:nnz]))
        vs.append(np.asarray(blk.values[:nnz]))
        base += nnz
    return CSR(
        jnp.asarray(np.concatenate(rps), dtype=INDEX_DTYPE),
        jnp.asarray(np.concatenate(cis), dtype=INDEX_DTYPE),
        jnp.asarray(np.concatenate(vs), dtype=QVALUE_DTYPE),
        ncols,
    )


def flops_prefix_partition(a: CSR, b: CSR, parts: int) -> list[int]:
    """Row cut points [0, r_1, ..., rows] splitting A into ``parts``
    contiguous groups of near-equal *footprint* cost (the reference's
    footPrintsCrowiCount partition, static_omp_csr_kernel.cc:28-62 +
    scost law cpu_csr_kernel.cc:317-334, applied to prefix sums instead
    of a dealt permutation — groups must stay contiguous so the stitch
    is a concatenation).  Footprints = padded descriptor slots + output
    writes + A reads, not raw flops: see ops.flops.footprint_row_costs."""
    from .flops import footprint_row_costs

    row_cost = footprint_row_costs(a, b)
    pref = np.concatenate([[0], np.cumsum(row_cost)])  # pref[r+1] = cost of rows [0, r]
    total = pref[-1]
    cuts = [0]
    for g in range(1, parts):
        cuts.append(int(np.searchsorted(pref, total * g // parts)))
    cuts.append(a.rows)
    return sorted(set(cuts))


def spgemm_ell_partitioned(
    a: CSR, b: CSR, parts: int = 4, exact: bool = True
) -> CSR:
    """C = A·B with A row-partitioned into flops-balanced groups, each
    multiplied through the full ELL-ESC pipeline, stitched on the host.

    Peak device memory ~ 1/parts of the monolithic pipeline's; use for
    flat-CSR export past the single-dispatch scale (s16+)."""
    cuts = flops_prefix_partition(a, b, parts)
    blocks = []
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        a_g = csr_row_slice(a, r0, r1)
        plan = plan_ell(a_g, b)
        blocks.append(spgemm_ell(a_g, b, plan, exact=exact))
    return csr_vstack(blocks, b.ncols)

"""2-D sharded SpGEMM: rows × column stripes over a 2-D mesh.

The mesh generalisation of the reference's PCSR column striping
(nlibs/PCSR.cc:3-56; striped SpGEMM correctTests/pcsrTest.cc:7-19) crossed
with row partitioning: on a mesh ('x', 'y'),

* A is row-sharded over 'x' and replicated over 'y';
* B is row-sharded over 'x' and column-striped over 'y' (each device
  holds the (row-block, col-stripe) of B with *local* column ids);
* the kernel all-gathers B's row blocks along 'x' (each device then owns
  its full column stripe) and runs the local ESC SpGEMM of its A row
  block against it;
* C comes out 2-D sharded: row blocks over 'x', column stripes over 'y',
  with no cross-device reduction (Gustavson rows are independent, and a
  column stripe of C depends only on the same stripe of B).

Bandwidth: each device receives 1/y-th of B per step (vs the full B in
the 1-D layout) — the memory/interconnect win that makes matrices larger
than one device's memory tractable.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..ops.spgemm import bview_from_blocks, esc_expand_view, esc_sort
from .sharded import ShardedCSR, shard_csr, unshard_csr


def shard_csr_2d(b: CSR, nx: int, ny: int, local_capacity: int | None = None):
    """Host-side 2-D partition: row blocks × column stripes.

    Returns stacked arrays with leading axes [nx, ny]: row_ptr
    [nx, ny, lr+1] (local offsets), col_ind/values [nx, ny, lcap] with
    *stripe-local* column ids.
    """
    stripe = -(-b.ncols // ny)
    rp_list, ci_list, v_list = [], [], []
    lcap = 0
    parts = []
    for y in range(ny):
        lo, hi = y * stripe, min((y + 1) * stripe, b.ncols)
        rp = np.asarray(b.row_ptr, np.int64)
        nnz = int(rp[-1])
        col = np.asarray(b.col_ind)[:nnz]
        val = np.asarray(b.values)[:nnz]
        erow = np.repeat(np.arange(b.rows), np.diff(rp))
        sel = (col >= lo) & (col < hi)
        counts = np.bincount(erow[sel], minlength=b.rows)
        srp = np.zeros(b.rows + 1, dtype=np.int64)
        np.cumsum(counts, out=srp[1:])
        stripe_csr = CSR.from_arrays(
            srp.astype(np.int32), col[sel] - lo, val[sel], stripe
        )
        s = shard_csr(stripe_csr, nx)
        parts.append(s)
        lcap = max(lcap, s.local_capacity)
    if local_capacity is not None:
        lcap = max(lcap, int(local_capacity))
    rp2 = np.stack(
        [np.asarray(s.row_ptr) for s in parts], axis=1
    )  # [nx, ny, lr+1]
    ci2 = np.full((nx, ny, lcap), stripe, np.int32)
    v2 = np.zeros((nx, ny, lcap), np.float32)
    for y, s in enumerate(parts):
        c = np.asarray(s.col_ind)
        v = np.asarray(s.values)
        ci2[:, y, : c.shape[1]] = c
        v2[:, y, : v.shape[1]] = v
    return (
        jnp.asarray(rp2, INDEX_DTYPE),
        jnp.asarray(ci2, INDEX_DTYPE),
        jnp.asarray(v2, QVALUE_DTYPE),
        stripe,
        b.rows,
    )


@partial(
    jax.jit,
    static_argnames=("mesh", "stripe", "b_rows", "product_cap", "out_cap"),
)
def sharded_spgemm_2d(
    mesh,
    a: ShardedCSR,
    b_rp,
    b_ci,
    b_v,
    stripe: int,
    b_rows: int,
    product_cap: int,
    out_cap: int,
):
    """C[x-block, y-stripe] = A[x-block] · B[:, y-stripe].

    ``a`` is a ShardedCSR over 'x' (its stacked arrays are additionally
    replicated over 'y' by shard_map).  Returns C blocks with leading
    [nx, ny] axes and stripe-local columns.
    """

    def kernel(a_rp, a_ci, a_v, rp, ci, v):
        g_rp = jax.lax.all_gather(rp[0, 0], "x")  # [nx, lr+1]
        g_ci = jax.lax.all_gather(ci[0, 0], "x")
        g_v = jax.lax.all_gather(v[0, 0], "x")
        bv = bview_from_blocks(g_rp, g_ci, g_v, stripe)
        A = CSR(a_rp[0], a_ci[0], a_v[0], b_rows)
        m = A.rows
        prow, pcol, pval, flops = esc_expand_view(A, bv, product_cap)
        prow, pcol, pval, pvalid, flags, seg, nnzc = esc_sort(
            prow, pcol, pval, m
        )
        seg = jnp.where(pvalid, seg, out_cap)
        cval = jnp.zeros((out_cap,), QVALUE_DTYPE).at[seg].add(pval, mode="drop")
        crow = jnp.full((out_cap,), m, INDEX_DTYPE).at[seg].min(prow, mode="drop")
        ccol = (
            jnp.full((out_cap,), stripe, INDEX_DTYPE)
            .at[seg]
            .min(pcol, mode="drop")
        )
        c_rp = jnp.searchsorted(
            crow, jnp.arange(m + 1, dtype=INDEX_DTYPE)
        ).astype(INDEX_DTYPE)
        return c_rp[None, None], ccol[None, None], cval[None, None]

    # A blocks: sharded over 'x', replicated over 'y'
    a_spec = P("x")
    b_spec = P("x", "y")
    c_rp, c_ci, c_v = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(a_spec,) * 3 + (b_spec,) * 3,
        out_specs=(b_spec,) * 3,
        check_vma=False,
    )(a.row_ptr, a.col_ind, a.values, b_rp, b_ci, b_v)
    return c_rp, c_ci, c_v


def unshard_2d(c_rp, c_ci, c_v, stripe: int, global_rows: int, ncols: int) -> CSR:
    """Stitch [nx, ny] blocks back to one CSR (host side, tests only)."""
    import numpy as np

    c_rp = np.asarray(c_rp)
    c_ci = np.asarray(c_ci)
    c_v = np.asarray(c_v)
    nx, ny = c_rp.shape[0], c_rp.shape[1]
    dense = None
    for x in range(nx):
        for y in range(ny):
            blk = CSR(
                jnp.asarray(c_rp[x, y]),
                jnp.asarray(c_ci[x, y]),
                jnp.asarray(c_v[x, y]),
                stripe,
            )
            d = np.asarray(blk.to_dense())
            if dense is None:
                lr = d.shape[0]
                dense = np.zeros((nx * lr, ny * stripe), np.float32)
            dense[x * lr : (x + 1) * lr, y * stripe : y * stripe + d.shape[1]] += d
    return CSR.from_dense(dense[:global_rows, :ncols])

"""ShardedCSR: a CSR row-partitioned into D equal local blocks.

Device replacement for the reference's two partitioned formats:

* PCSR column stripes (nlibs/PCSR.cc:3-56) — there, stripes feed per-stripe
  CPU SpGEMM (correctTests/pcsrTest.cc:7-19); here, partitioning is the
  *sharding layout* of the distributed SpGEMM.
* the per-thread private-output PCSR of the "vcsr" kernel
  (original-matrix-perf/mvcsr.cc:51-122) — each shard owns a private local
  CSR block, stitched only when a host-global view is needed.

Layout: every per-row array gains a leading shard axis of size D and every
block has identical static shapes (XLA requirement), so the stack can be
sharded with `PartitionSpec('x')` and passed straight into shard_map.
Row r lives on shard r // local_rows as local row r % local_rows; rows
beyond the true row count are padding rows with zero entries.

Load balance across shards uses the reference's equal-cost idea
(arrayEqualPartition, nlibs/tools/util.cc:123-149) reshaped for static
shapes: instead of variable-length contiguous ranges, a row *permutation*
deals rows over shards so per-shard flops are near-equal while every shard
keeps exactly local_rows rows (:func:`flops_balanced_permutation`).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("row_ptr", "col_ind", "values"),
    meta_fields=("ncols", "global_rows"),
)
@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """D stacked local CSR blocks with identical static shapes."""

    row_ptr: jax.Array  # int32[D, local_rows + 1] (local offsets)
    col_ind: jax.Array  # int32[D, local_cap]; padding slots hold ncols
    values: jax.Array  # f32[D, local_cap]; padding slots hold 0
    ncols: int
    global_rows: int  # true (unpadded) row count

    @property
    def num_shards(self) -> int:
        return self.row_ptr.shape[0]

    @property
    def local_rows(self) -> int:
        return self.row_ptr.shape[1] - 1

    @property
    def local_capacity(self) -> int:
        return self.col_ind.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.local_rows

    @property
    def nnz(self) -> jax.Array:
        return jnp.sum(self.row_ptr[:, -1])

    def local_block(self, d: int) -> CSR:
        """Host-side convenience: shard d as a standalone CSR."""
        return CSR(self.row_ptr[d], self.col_ind[d], self.values[d], self.ncols)


def shard_csr(
    a: CSR, num_shards: int, local_capacity: int | None = None
) -> ShardedCSR:
    """Host-side block row partition of ``a`` into ``num_shards`` equal
    blocks (rows padded up to a multiple of D; padding rows are empty)."""
    rp = np.asarray(a.row_ptr, dtype=np.int64)
    col = np.asarray(a.col_ind)
    val = np.asarray(a.values)
    rows = a.rows
    lr = -(-rows // num_shards)
    counts = rp[1:] - rp[:-1]
    counts = np.concatenate(
        [counts, np.zeros(num_shards * lr - rows, dtype=np.int64)]
    )
    per_shard = counts.reshape(num_shards, lr)
    shard_nnz = per_shard.sum(axis=1)
    lcap = int(shard_nnz.max()) if local_capacity is None else int(local_capacity)
    lcap = max(lcap, 1)
    if lcap < shard_nnz.max():
        raise ValueError(f"local_capacity {lcap} < max shard nnz {shard_nnz.max()}")

    out_rp = np.zeros((num_shards, lr + 1), dtype=np.int32)
    np.cumsum(per_shard, axis=1, out=out_rp[:, 1:])
    out_col = np.full((num_shards, lcap), a.ncols, dtype=np.int32)
    out_val = np.zeros((num_shards, lcap), dtype=np.float32)
    nnz = int(rp[min(rows, num_shards * lr)])
    for d in range(num_shards):
        lo = int(rp[min(d * lr, rows)])
        hi = int(rp[min((d + 1) * lr, rows)])
        out_col[d, : hi - lo] = col[lo:hi]
        out_val[d, : hi - lo] = val[lo:hi]
    del nnz
    return ShardedCSR(
        row_ptr=jnp.asarray(out_rp, INDEX_DTYPE),
        col_ind=jnp.asarray(out_col, INDEX_DTYPE),
        values=jnp.asarray(out_val, QVALUE_DTYPE),
        ncols=a.ncols,
        global_rows=rows,
    )


def unshard_csr(s: ShardedCSR) -> CSR:
    """Stitch shard blocks back into one global CSR (host side) — the
    ``PCSR::toCSR`` role (original-matrix-perf/mvcsr.cc:80-121)."""
    rp = np.asarray(s.row_ptr, dtype=np.int64)
    col = np.asarray(s.col_ind)
    val = np.asarray(s.values)
    d, lr = rp.shape[0], rp.shape[1] - 1
    counts = (rp[:, 1:] - rp[:, :-1]).reshape(-1)[: s.global_rows]
    grp = np.zeros(s.global_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=grp[1:])
    nnz = int(grp[-1])
    gcol = np.full(max(nnz, 1), s.ncols, dtype=np.int32)
    gval = np.zeros(max(nnz, 1), dtype=np.float32)
    pos = 0
    for b in range(d):
        n = int(rp[b, -1])
        gcol[pos : pos + n] = col[b, :n]
        gval[pos : pos + n] = val[b, :n]
        pos += n
    return CSR.from_arrays(grp.astype(np.int32), gcol, gval, s.ncols)


def flops_balanced_permutation(row_flops: np.ndarray, num_shards: int) -> np.ndarray:
    """Row permutation that deals rows across shards in near-equal flops.

    Static-shape analogue of arrayEqualPartition (util.cc:123-149): sort
    rows by descending cost, deal them boustrophedon ("snake") over the
    D shard buckets so every shard gets exactly ceil(rows/D) rows with
    near-equal total flops.  Returns ``perm`` such that new row i = old row
    perm[i]; apply with ``CSR.permute_rows(perm)`` before :func:`shard_csr`.
    """
    rows = row_flops.shape[0]
    d = num_shards
    lr = -(-rows // d)
    order = np.argsort(-np.asarray(row_flops, dtype=np.int64), kind="stable")
    # shard_csr appends the D*lr - rows empty padding rows at the GLOBAL
    # tail, so shard k must receive exactly min(lr, rows - k*lr) real rows
    # — the "hole" slots live at the end of the trailing shards' buckets.
    # Deal real rows boustrophedon over the remaining (valid) slots only;
    # a naive deal-then-compact would shift rows across shard boundaries
    # whenever rows % D != 0.
    sizes = np.clip(rows - np.arange(d, dtype=np.int64) * lr, 0, lr)
    valid = np.arange(lr)[:, None] < sizes[None, :]  # [round, shard]
    cols2d = np.tile(np.arange(d), (lr, 1))
    cols2d[1::2] = cols2d[1::2, ::-1]  # snake to cancel systematic skew
    flatpos = (np.repeat(np.arange(lr), d) * d + cols2d.reshape(-1))
    sel = flatpos[valid.reshape(-1)[flatpos]]  # valid slots, snake order
    grid = np.full(lr * d, -1, dtype=np.int64)
    grid[sel] = order
    perm = grid.reshape(lr, d).T.reshape(-1)
    return perm[perm >= 0].astype(np.int32)

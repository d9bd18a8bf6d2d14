"""Dense-block (BCSR x BCSR) SpGEMM on the matrix units.

The role: FEM/band-class matrices (the reference's own anchors — cant.mtx,
consph, shipsec; tools/res.txt) have their nonzeros concentrated in a
narrow diagonal band, so bs x bs blocks along the band are 15-40% dense.
For these the lane-wise sort/dedup pipeline (ops/ell_esc.py) is the wrong
shape — band rows are a cache's best case and a sort network's worst.
The answer here is to make the multiply DENSE at block granularity:

  1. densify A and B's occupied bs x bs blocks (one scatter each),
  2. per C block, one matmul over all its structural pairs (i,k)x(k,j)
     at once: the pairs' A blocks side by side times their B blocks
     stacked, a [bs, K·bs] x [K·bs, bs] product (K = most pairs of any C
     block, short lists padded with a zero block; planned on host) — one
     batched matmul for all C blocks, with no scatter of products,
  3. per block row, one lane sort compacts the dense rows back to sparse.

Block-level waste (1/fill) is paid in dense matmul flops, the cheapest
resource on the device.
The exact structural nnz(C) (scipy/Gustavson semantics, explicit zeros
included) is preserved by running the same batched matmul over 0/1
structure blocks.

Reference parity: this plays the role of the reference's per-bin kernel
escalation for its FEM corpus rows (gspgemm.cuh bin zoo; tools/res.txt
anchors) — re-designed for dense matmuls rather than translated.  The planner
(:func:`plan_block`) is host structure analysis like gnnz.cuh's
dispatcher; its cost is reported as plan_ms by the benchmark drivers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from ..config import INDEX_DTYPE, MATMUL_PRECISION, QVALUE_DTYPE
from ..formats.csr import CSR
from ..formats.tiled import TiledCSR
from ..utils.nphost import (
    concat_ranges,
    csr_host,
    fast_repeat,
    repeat_idx,
)


@dataclasses.dataclass(frozen=True, eq=False)
class BlockPlan:
    """Static block-structure plan (identity-hashed jit static arg)."""

    bs: int
    m: int  # A rows
    n: int  # C cols (= B cols)
    nnz_a: int
    nnz_b: int
    # A-block scatter: block id + within-block coords per A entry
    a_blk: np.ndarray  # int32[nnz_a]
    a_r: np.ndarray  # int32[nnz_a]
    a_c: np.ndarray  # int32[nnz_a]
    n_ablk: int
    b_blk: np.ndarray  # int32[nnz_b]
    b_r: np.ndarray  # int32[nnz_b]
    b_c: np.ndarray  # int32[nnz_b]
    n_bblk: int
    # block product pairs grouped by output block: row c lists the A and
    # B blocks of C block c's pairs, padded with the zero blocks n_ablk /
    # n_bblk
    c_pair_a: np.ndarray  # int32[n_cblk, K]
    c_pair_b: np.ndarray  # int32[n_cblk, K]
    n_cblk: int
    # C extraction: block ids per block row (-1 padded) + their col blocks
    bob: np.ndarray  # int32[mbr, kmax] C block ids
    bob_colblk: np.ndarray  # int32[mbr, kmax] block col ids (-1 pads)
    kmax: int
    # diagnostics
    fill_a: float
    fill_b: float

    __hash__ = object.__hash__


_OCC_GRID_MAX = 1 << 26  # occupancy-bitmap inverse up to a 64M-cell grid


def _unique_inverse_grid(blk_r: np.ndarray, blk_c: np.ndarray, n_c: int,
                         grid: int):
    """``np.unique(blk_r * n_c + blk_c, return_inverse=True)`` in O(nnz)
    via an occupancy bitmap over the (bounded) block grid — no nnz-scale
    sort.  The grid is #blockrows x #blockcols cells: tiny next to nnz
    for every single-chip-feasible shape (cant: 239k cells vs 4M nnz;
    the nnz-scale argsort inside np.unique was ~80% of plan_block's
    ~500 ms, VERDICT r4 next-round #1).  Falls back to np.unique past
    _OCC_GRID_MAX cells."""
    if grid <= _OCC_GRID_MAX:
        key = blk_r * np.int32(n_c) + blk_c  # int32: grid < 2^26
        occ = np.zeros(grid, np.bool_)
        occ[key] = True
        id_of = np.cumsum(occ, dtype=np.int32)
        uniq = np.flatnonzero(occ)
        return uniq, id_of[key] - 1
    key = blk_r.astype(np.int64) * n_c + blk_c.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    return uniq, inv.astype(np.int32, copy=False)


def _blk_coords(rp: np.ndarray, ci: np.ndarray, bs: int, cache_on=None):
    """Per-entry (row, col, row//bs, col//bs) in int32, shift-based when
    bs is a power of two.  With ``cache_on`` (a CSR), the result is
    memoised on the instance keyed by ``bs`` so the auto-dispatch fill
    estimate and a following plan_block share one pass (csr_host's
    caching pattern)."""
    if cache_on is not None:
        cached = getattr(cache_on, "_blk_coords_cache", None)
        if cached is not None and cached[0] == bs:
            return cached[1]
    nnz = int(rp[-1])
    r = repeat_idx(np.diff(rp), nnz)  # int32
    c = ci[:nnz]
    if bs & (bs - 1) == 0:
        s = bs.bit_length() - 1
        out = (r, c, r >> s, c >> s)
    else:
        out = (r, c, r // bs, c // bs)
    if cache_on is not None:
        try:
            object.__setattr__(cache_on, "_blk_coords_cache", (bs, out))
        except (AttributeError, TypeError):
            pass
    return out


def plan_block(a: CSR, b: CSR, bs: int = 128) -> BlockPlan:
    """Host block-structure analysis for C = A·B.

    Cost: O(nnz) scatter/gather passes + block-grid-scale scans (no
    nnz-scale sort) — the gnnz.cuh dispatcher role, reported in plan_ms
    by the drivers.  When ``a is b`` (the corpus' A·A multiplies) the
    block structure is derived once and shared."""
    rp_a, ci_a = csr_host(a)
    nnz_a = int(rp_a[-1])
    nbk = -(-b.rows // bs)  # block rows of B = block cols of A
    ncb = -(-b.ncols // bs)  # block cols of B / C
    mbr = -(-a.rows // bs)

    ar, ac, arb, acb = _blk_coords(rp_a, ci_a, bs, cache_on=a)
    aub, a_blk = _unique_inverse_grid(arb, acb, nbk, mbr * nbk)
    n_ablk = int(aub.size)
    if a is b and nbk == ncb:
        rp_b, ci_b = rp_a, ci_a
        nnz_b = nnz_a
        br, bc = ar, ac
        bub, b_blk, n_bblk = aub, a_blk, n_ablk
    else:
        rp_b, ci_b = csr_host(b)
        nnz_b = int(rp_b[-1])
        br, bc, brb, bcb = _blk_coords(rp_b, ci_b, bs, cache_on=b)
        bub, b_blk = _unique_inverse_grid(brb, bcb, ncb, nbk * ncb)
        n_bblk = int(bub.size)

    # B block-CSR over block rows (bub is sorted by (block row, block col))
    b_brow = bub // ncb
    b_bcol = (bub % ncb).astype(np.int64)
    brp = np.zeros(nbk + 1, np.int64)
    np.add.at(brp, b_brow + 1, 1)
    np.cumsum(brp, out=brp)

    # pairs: A block (i, k) x every B block in block row k
    a_brow = aub // nbk
    a_bcol = aub % nbk
    cnt = brp[a_bcol + 1] - brp[a_bcol]
    pair_a = fast_repeat(np.arange(n_ablk, dtype=np.int64), cnt)
    pair_b = concat_ranges(brp[a_bcol], brp[a_bcol + 1])
    cub, pair_c = _unique_inverse_grid(
        a_brow[pair_a].astype(np.int32),
        b_bcol[pair_b].astype(np.int32),
        ncb,
        mbr * ncb,
    )
    n_cblk = int(cub.size)
    order = np.argsort(pair_c, kind="stable")
    pair_a, pair_b, pair_c = pair_a[order], pair_b[order], pair_c[order]
    per_c = np.bincount(pair_c, minlength=n_cblk)
    kp = max(int(per_c.max()) if per_c.size else 0, 1)
    slot_p = np.arange(pair_c.size, dtype=np.int64) - (
        np.cumsum(per_c) - per_c
    )[pair_c]
    c_pair_a = np.full((n_cblk, kp), n_ablk, np.int32)
    c_pair_b = np.full((n_cblk, kp), n_bblk, np.int32)
    c_pair_a[pair_c, slot_p] = pair_a
    c_pair_b[pair_c, slot_p] = pair_b

    # C extraction layout: blocks per block row, -1 padded
    c_brow = (cub // ncb).astype(np.int64)
    c_bcol = (cub % ncb).astype(np.int64)
    per_brow = np.zeros(mbr, np.int64)
    np.add.at(per_brow, c_brow, 1)
    kmax = max(int(per_brow.max()) if per_brow.size else 0, 1)
    crp = np.zeros(mbr + 1, np.int64)
    np.cumsum(per_brow, out=crp[1:])
    bob = np.full((mbr, kmax), -1, np.int32)
    bobc = np.full((mbr, kmax), -1, np.int32)
    slot = np.arange(n_cblk, dtype=np.int64) - crp[c_brow]
    bob[c_brow, slot] = np.arange(n_cblk, dtype=np.int32)
    bobc[c_brow, slot] = c_bcol.astype(np.int32)

    return BlockPlan(
        bs=bs,
        m=a.rows,
        n=b.ncols,
        nnz_a=nnz_a,
        nnz_b=nnz_b,
        a_blk=a_blk.astype(np.int32, copy=False),
        a_r=(ar & (bs - 1) if bs & (bs - 1) == 0 else ar % bs),
        a_c=(ac & (bs - 1) if bs & (bs - 1) == 0 else ac % bs),
        n_ablk=n_ablk,
        b_blk=b_blk.astype(np.int32, copy=False),
        b_r=(br & (bs - 1) if bs & (bs - 1) == 0 else br % bs),
        b_c=(bc & (bs - 1) if bs & (bs - 1) == 0 else bc % bs),
        n_bblk=n_bblk,
        c_pair_a=c_pair_a,
        c_pair_b=c_pair_b,
        n_cblk=n_cblk,
        bob=bob,
        bob_colblk=bobc,
        kmax=kmax,
        fill_a=nnz_a / max(n_ablk * bs * bs, 1),
        fill_b=nnz_b / max(n_bblk * bs * bs, 1),
    )


def _occupied_blocks(rp, ci, bs: int, n_r: int, n_c: int, cache_on=None) -> int:
    """Occupied-block count in O(nnz) via the grid bitmap (no sort)."""
    _, _, rb, cb = _blk_coords(rp, ci, bs, cache_on=cache_on)
    grid = n_r * n_c
    if grid <= _OCC_GRID_MAX:
        occ = np.zeros(grid, np.bool_)
        occ[rb * np.int32(n_c) + cb] = True
        return int(np.count_nonzero(occ))
    return int(np.unique(rb.astype(np.int64) * n_c + cb).size)


def block_fill_estimate(a: CSR, b: CSR, bs: int = 128) -> float:
    """Cheap routing signal: min(block fill of A, of B) without the full
    plan.  The block path wins when the occupied blocks are dense enough
    that 1/fill block-flop waste still beats the lane pipeline (the
    threshold is ops.dispatch.BLOCK_FILL_THRESHOLD)."""
    rp_a, ci_a = csr_host(a)
    nnz_a = int(rp_a[-1])
    nbk = -(-b.rows // bs)
    mbr = -(-a.rows // bs)
    na = _occupied_blocks(rp_a, ci_a, bs, mbr, nbk, cache_on=a)
    fa = nnz_a / max(na * bs * bs, 1)
    if a is b and nbk == -(-b.ncols // bs):
        return fa
    rp_b, ci_b = csr_host(b)
    nnz_b = int(rp_b[-1])
    ncb = -(-b.ncols // bs)
    nb = _occupied_blocks(rp_b, ci_b, bs, nbk, ncb, cache_on=b)
    return min(fa, nnz_b / max(nb * bs * bs, 1))


def _densify(blk, r, c, vals, n_blocks, bs):
    """[n_blocks + 1, bs, bs] dense blocks; the last one stays zero (the
    pad target of short pair lists)."""
    out = jnp.zeros((n_blocks + 1, bs, bs), QVALUE_DTYPE)
    return out.at[jnp.asarray(blk), jnp.asarray(r), jnp.asarray(c)].set(
        vals, mode="drop"
    )


def block_spgemm_tiled(a: CSR, b: CSR, plan: BlockPlan) -> TiledCSR:
    """C = A·B in tile form via batched dense block matmuls.

    Exact structural nnz(C): the same pair matmul runs over 0/1
    structure blocks, and extraction keeps exactly the positions with a
    structural contribution (matching scipy/Gustavson, explicit zeros
    included)."""
    bs, m, n = plan.bs, plan.m, plan.n
    av = a.values[: plan.nnz_a]
    bv = b.values[: plan.nnz_b]
    a_blocks = _densify(plan.a_blk, plan.a_r, plan.a_c, av, plan.n_ablk, bs)
    b_blocks = _densify(plan.b_blk, plan.b_r, plan.b_c, bv, plan.n_bblk, bs)
    a_struct = _densify(
        plan.a_blk, plan.a_r, plan.a_c, jnp.ones_like(av), plan.n_ablk, bs
    )
    b_struct = _densify(
        plan.b_blk, plan.b_r, plan.b_c, jnp.ones_like(bv), plan.n_bblk, bs
    )
    pa = jnp.asarray(plan.c_pair_a)
    pb = jnp.asarray(plan.c_pair_b)

    def pairs_matmul(xa, xb):
        # C[c] = sum_k A[pa[c,k]] @ B[pb[c,k]]: contract k and the inner
        # block dimension together
        return jnp.einsum(
            "ckij,ckjl->cil",
            jnp.take(xa, pa, axis=0),
            jnp.take(xb, pb, axis=0),
            precision=MATMUL_PRECISION,
        )

    c_vals = pairs_matmul(a_blocks, b_blocks)
    c_struct = pairs_matmul(a_struct, b_struct)

    # extraction: [mbr, kmax] blocks -> [m_pad, W] dense rows -> lane sort
    bob = jnp.asarray(plan.bob)
    safe_bob = jnp.clip(bob, 0, plan.n_cblk - 1)
    W = plan.kmax * bs
    mbr = plan.bob.shape[0]

    def rows_of(blocks4):
        # [mbr, kmax, bs, bs] -> [mbr*bs, kmax*bs]
        g = jnp.take(blocks4, safe_bob, axis=0)
        return g.transpose(0, 2, 1, 3).reshape(mbr * bs, W)

    vals_rows = rows_of(c_vals)
    struct_rows = rows_of(c_struct)
    colblk = jnp.asarray(plan.bob_colblk)  # [mbr, kmax]
    lane = jnp.arange(bs, dtype=INDEX_DTYPE)
    gcol = (
        colblk[:, :, None].astype(INDEX_DTYPE) * bs + lane[None, None, :]
    ).reshape(mbr, W)
    gcol = jnp.where(
        (colblk[:, :, None] >= 0).repeat(bs, axis=2).reshape(mbr, W),
        gcol,
        n,
    )
    gcol_rows = jnp.repeat(gcol, bs, axis=0)  # [mbr*bs, W]
    keys = jnp.where(
        (struct_rows > 0) & (gcol_rows < n), gcol_rows, n
    ).astype(INDEX_DTYPE)
    k2, v2 = jax.lax.sort((keys, vals_rows), dimension=1, num_keys=1)
    k2, v2 = k2[:m], v2[:m]
    counts = jnp.sum(k2 < n, axis=1).astype(INDEX_DTYPE)
    v2 = jnp.where(k2 < n, v2, 0.0)
    base = (jnp.arange(m, dtype=INDEX_DTYPE)) * W
    return TiledCSR(
        flat_col=k2.reshape(-1),
        flat_val=v2.reshape(-1),
        counts=counts,
        flat_base=base,
        ncols=n,
    )


def block_spgemm(
    a: CSR, b: CSR, plan: BlockPlan | None = None, bs: int = 128
) -> CSR:
    """C = A·B as exact flat CSR via the dense-block path."""
    if plan is None:
        plan = plan_block(a, b, bs=bs)
    return block_spgemm_tiled(a, b, plan).to_csr()

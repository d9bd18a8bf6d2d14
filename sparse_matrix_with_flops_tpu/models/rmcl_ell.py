"""Static-shape fused R-MCL: the production single-device clustering loop.

Key observation: in Mt' = prune(inflate(Mgt · Mt)) the left operand Mgt is
FIXED across iterations (qrmcl.cc:141 — `Mgt = Mt.deepCopy()` once), and
pruning keeps each row small.  Capping the iterate at ``S`` survivors per
row — the standard MCL *selection number*; the reference's threshold prune
(util.cc:47-69) almost always keeps far fewer — makes every shape in the
loop static:

* Mt lives as an ELL pair ``cols/vals [n, S]`` (sentinel-padded);
* expansion is ONE row gather: segment of A entry e = Mt row ``col_e``;
* row product tiles are planned once from Mgt's (fixed) degrees:
  a degree-2^d row's tile is ``[*, 2^d · S]``, assembled by a static row
  gather of its entries' segments;
* the ESC sort–compress, the inflate/threshold/prune math (util.cc:4-69
  constants), top-S selection (two value sorts), renormalisation, and the
  convergence norm are all lane-axis ops on those tiles;
* hub rows (degree beyond the largest tile) go through the dense
  path: precomputed dense Mgt_huge @ dense(Mt) + dense prune/select.

Result: ONE compiled step, `lax.scan`-able, iterate device-resident for
the whole run — the multi-iteration generalisation of gpuRmclIter
(gpu_csr_kernel.cu:281-311) with zero per-iteration host work.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import INDEX_DTYPE, MATMUL_PRECISION, QVALUE_DTYPE
from ..formats.csr import CSR
from ..ops.prune import compute_threshold
from ..ops.segments import sort_dedup_rows


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True, eq=False)
class RmclEllPlan:
    """Static structure derived from Mgt (fixed for the whole run)."""

    n: int
    S: int  # selection cap (iterate width)
    bins: tuple  # ((D, row_ids np.int32[R_b], ent_src np.int32[R_b*D]), ...)
    huge_rows: np.ndarray  # degrees > max tile
    huge_src: np.ndarray  # entry indices of huge rows (concatenated)
    huge_lens: np.ndarray
    hub_precision: str = "f32"  # "bf16" = single whole-width densify
    # hub contraction restricted to the union of iterate rows the hub
    # rows reference (Mgt is static, so the union is a plan constant) —
    # the ell_esc hub-union law: the densify cost is dense-array traffic
    # plus one element scatter per (union row, S), both ∝ kh/n
    hub_krows: np.ndarray | None = None  # int32[khp], -1 padded
    hub_kmap: np.ndarray | None = None  # int32[n]: global -> local, -1
    hub_kh: int = 0  # padded union size (multiple of 128)

    __hash__ = object.__hash__


def plan_rmcl_ell(
    mgt: CSR, S: int = 128, max_tile: int = 16384, hub_precision: str = "f32"
) -> RmclEllPlan:
    """Bin Mgt rows by degree class; ent_src holds each row's A-entry ids
    (sentinel -1 padding)."""
    rp = np.asarray(mgt.row_ptr, dtype=np.int64)
    m = mgt.rows
    deg = np.diff(rp)
    # largest power-of-two degree class that fits the tile budget; rows
    # above it go dense.  (Using max_tile//S directly leaves degrees in
    # (last pow2, max_tile//S] unbinned when S is not a pow2 divisor.)
    dmax = 1
    while dmax * 2 <= max(max_tile // S, 1):
        dmax *= 2
    bins = []
    d = 1
    while d <= dmax:
        lo = d // 2 + 1 if d > 1 else 1
        sel = np.nonzero((deg >= lo) & (deg <= d))[0]
        if sel.size:
            ent_src = np.full((sel.size, d), -1, dtype=np.int64)
            for k in range(d):
                has = deg[sel] > k
                ent_src[has, k] = rp[sel[has]] + k
            bins.append(
                (int(d), sel.astype(np.int32), ent_src.reshape(-1).astype(np.int32))
            )
        d *= 2
    huge = np.nonzero((deg > dmax))[0].astype(np.int32)
    huge_src = (
        np.concatenate([np.arange(rp[r], rp[r + 1]) for r in huge]).astype(np.int32)
        if huge.size
        else np.zeros(0, np.int32)
    )
    huge_lens = deg[huge].astype(np.int32)
    hub_krows, hub_kmap, hub_kh = None, None, 0
    if huge.size:
        ci = np.asarray(mgt.col_ind)
        krows = np.unique(np.clip(ci[huge_src], 0, m - 1))
        kh = int(krows.size)
        khp = max(128, -(-kh // 128) * 128)
        hub_krows = np.full(khp, -1, np.int32)
        hub_krows[:kh] = krows
        hub_kmap = np.full(m, -1, np.int32)
        hub_kmap[krows] = np.arange(kh, dtype=np.int32)
        hub_kh = khp
    return RmclEllPlan(
        n=m,
        S=int(S),
        bins=tuple(bins),
        huge_rows=huge,
        huge_src=huge_src,
        huge_lens=huge_lens,
        hub_precision=hub_precision,
        hub_krows=hub_krows,
        hub_kmap=hub_kmap,
        hub_kh=hub_kh,
    )


def mt_to_ell(mt: CSR, S: int):
    """Initial iterate: duplicate-sum + first-S truncation + renormalise
    (host).  The ELL iterate invariant — each row's columns sorted and
    UNIQUE — is established here and preserved by every step
    (_prune_select_lanes re-sorts and dedups); the hub densify's
    unique-target scatter-SET relies on it."""
    from ..utils.nphost import csr_host, repeat_idx

    rp, c_all = csr_host(mt)
    n = mt.rows
    nnz = int(rp[-1])
    c = c_all[:nnz].astype(np.int64)
    v = np.asarray(mt.values)[:nnz].astype(np.float64)
    # global (row, col) sort -> per-row unique prefix sums, all bulk ops
    # (the old per-row np.unique loop was minutes of Python at 1M rows,
    # VERDICT r3 Weak #6)
    erow = repeat_idx(np.diff(rp), nnz).astype(np.int64)
    order = np.argsort(erow * (mt.ncols + 1) + c, kind="stable")
    re, ce, ve = erow[order], c[order], v[order]
    first = np.ones(nnz, dtype=bool)
    first[1:] = (re[1:] != re[:-1]) | (ce[1:] != ce[:-1])
    seg = np.cumsum(first) - 1
    nseg = int(seg[-1]) + 1 if nnz else 0
    uv = np.zeros(nseg, np.float64)
    np.add.at(uv, seg, ve)
    ur = re[first]
    uc = ce[first]
    # rank of each unique col within its row (uniques are row-contiguous)
    row_start = np.zeros(n + 1, np.int64)
    np.add.at(row_start, ur + 1, 1)
    np.cumsum(row_start, out=row_start)
    rank = np.arange(nseg, dtype=np.int64) - row_start[ur]
    keep = rank < S
    cols = np.full((n, S), mt.ncols, np.int32)
    vals = np.zeros((n, S), np.float32)
    cols[ur[keep], rank[keep]] = uc[keep].astype(np.int32)
    vals[ur[keep], rank[keep]] = uv[keep].astype(np.float32)
    s = vals.sum(axis=1, keepdims=True)
    vals = np.where(s > 0, vals / np.maximum(s, 1e-30), vals)
    return jnp.asarray(cols), jnp.asarray(vals)


def ell_to_csr(cols, vals, ncols: int) -> CSR:
    """Iterate back to CSR (host side, end of run)."""
    cols_np = np.asarray(cols)
    vals_np = np.asarray(vals)
    n, S = cols_np.shape
    keep = cols_np < ncols
    counts = keep.sum(axis=1)
    rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=rp[1:])
    out_c = cols_np[keep]
    out_v = vals_np[keep]
    return CSR.from_arrays(rp.astype(np.int32), out_c, out_v, ncols)


def _prune_select_lanes(key, uval, n, S):
    """Fused inflate/threshold/prune + top-S selection + renormalise on a
    compacted [R, W] tile (util.cc:4-69 semantics + MCL selection)."""
    valid = key < n
    w = jnp.where(valid, uval * uval, 0.0)  # inflation v^2
    rsum = jnp.sum(w, axis=1)
    rmax = jnp.max(w, axis=1)
    rcount = jnp.sum(valid, axis=1).astype(QVALUE_DTYPE)
    avg = rsum / jnp.maximum(rcount, 1.0)
    thresh = compute_threshold(avg, rmax)
    keep = valid & (w >= thresh[:, None])
    truncated = jnp.sum(keep, axis=1) > S
    # top-S by inflated value: sort by (-w | +inf), slice, re-sort by col
    vkey = jnp.where(keep, -w, jnp.inf)
    _, sc, sw = jax.lax.sort((vkey, key, w), dimension=1, num_keys=1)
    sc = sc[:, :S]
    sw = sw[:, :S]
    kept = jnp.where(jnp.isfinite(_[:, :S]), True, False)
    sc = jnp.where(kept, sc, n)
    sw = jnp.where(kept, sw, 0.0)
    sc, sw = jax.lax.sort((sc, sw), dimension=1, num_keys=1)
    ksum = jnp.sum(sw, axis=1, keepdims=True)
    sw = jnp.where(sc < n, sw / jnp.maximum(ksum, 1e-30), 0.0)
    return sc.astype(INDEX_DTYPE), sw.astype(QVALUE_DTYPE), truncated


def _hub_dense_products(
    a_dense, cols, vals, n: int, precision: str = "f32",
    krows=None, khp: int = 0,
):
    """C_hub = A_hub_dense · dense(iterate) (shared by the single-chip and
    sharded steps).

    When ``krows/khp`` are given, ``a_dense`` is [H, khp] over the UNION
    of iterate rows the hub rows reference, and only those rows of the
    iterate are gathered and densified — both the dense-slab traffic and
    the per-(row, S) element scatter shrink by kh/n (the ell_esc
    hub-union law).  The dense slab budget is 512 MB, untuned on the
    H100, see ROADMAP queue 1 #7.

    ``precision="f32"`` multiplies at config.MATMUL_PRECISION (true f32).
    ``precision="bf16"``: bf16 densification + bf16 matmul with f32
    accumulation — half the bytes; hub-row values carry ~3 significant
    digits (the prune threshold math tolerates it; enable for large n).
    """
    S = cols.shape[1]
    if krows is not None:
        kr = jnp.asarray(krows)
        safe = jnp.clip(kr, 0, n - 1)
        ok = (kr >= 0)[:, None]
        cols = jnp.where(ok, jnp.take(cols, safe, axis=0), n)
        vals = jnp.where(ok, jnp.take(vals, safe, axis=0), 0.0)
        rows = khp
    else:
        rows = n
    rix = jax.lax.broadcasted_iota(INDEX_DTYPE, (rows, S), 0)
    lane_s = jax.lax.broadcasted_iota(INDEX_DTYPE, (rows, S), 1)
    dt = jnp.bfloat16 if precision == "bf16" else QVALUE_DTYPE
    slab = n
    while rows * slab * jnp.dtype(dt).itemsize > (1 << 29) and slab > 1024:
        slab = -(-slab // 2)
    parts = []
    for s0 in range(0, n, slab):
        loc = cols - s0
        # scatter-SET with genuinely unique targets (−25% vs scatter-ADD,
        # probe_rmcl_hub): each iterate row's columns are unique, and
        # out-of-slab/sentinel entries land on DISTINCT dummy columns
        # slab+lane so the unique_indices promise holds for them too
        tgt = jnp.where((loc >= 0) & (loc < slab), loc, slab + lane_s)
        md = jnp.zeros((rows, slab + S), dt)
        md = md.at[rix, tgt].set(
            vals.astype(dt), mode="promise_in_bounds", unique_indices=True
        )[:, :slab]
        parts.append(
            jnp.dot(
                a_dense.astype(dt),
                md,
                preferred_element_type=jnp.float32,
                precision=MATMUL_PRECISION,
            )
        )
    out = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    return out[:, :n]


def _ell_drift_sq(old_c, old_v, new_c, new_v, n: int):
    """(||new − old||_F², ||old||_F²) on merged sorted ELL rows (the
    CSR::differs role; shared by both steps)."""
    r = old_c.shape[0]
    mc = jnp.concatenate([old_c, new_c], axis=1)
    mv = jnp.concatenate([-old_v, new_v], axis=1)
    key2, runs = sort_dedup_rows(mc, mv, n)
    runs = jnp.where(key2 < n, runs, 0.0)
    return jnp.sum(runs * runs), jnp.sum(old_v * old_v)


@partial(jax.jit, static_argnames=("plan", "_stage"))
def rmcl_ell_step(
    plan: RmclEllPlan, a: CSR, a_dense_huge, mt_cols, mt_vals,
    _stage: int = 99,
):
    """One fused iteration on the ELL iterate.  ``a_dense_huge`` is the
    precomputed dense block of Mgt's hub rows ([H, n] or None-shaped
    (0, n)).

    ``_stage`` truncates for slope profiling (tools/profile_rmcl.py):
    0 = segments gather, 1 = + tile dedup, 2 = + prune/select, 3 = hub
    only, 99 = full.  Cutoffs only bill work whose outputs they return."""
    n, S = plan.n, plan.S

    # per-entry segments: one row gather of the iterate
    safe_col = jnp.clip(a.col_ind, 0, n - 1)
    seg_c = jnp.take(mt_cols, safe_col, axis=0)
    seg_v = jnp.take(mt_vals, safe_col, axis=0) * a.values[:, None]
    ev = a.entry_valid()[:, None]
    seg_c = jnp.where(ev, seg_c, n)
    seg_v = jnp.where(ev, seg_v, 0.0)
    # sentinel segment for ent_src == -1
    seg_c = jnp.concatenate([seg_c, jnp.full((1, S), n, INDEX_DTYPE)], axis=0)
    seg_v = jnp.concatenate([seg_v, jnp.zeros((1, S), QVALUE_DTYPE)], axis=0)
    sent = seg_c.shape[0] - 1
    if _stage == 0:
        return jnp.sum(seg_c), jnp.sum(seg_v), {}

    new_cols = jnp.full((n, S), n, INDEX_DTYPE)
    new_vals = jnp.zeros((n, S), QVALUE_DTYPE)
    nnz_out = jnp.zeros((), INDEX_DTYPE)
    trunc_rows = jnp.zeros((), INDEX_DTYPE)
    s1_acc = []
    for D, row_ids, ent_src in plan.bins:
        src = jnp.asarray(ent_src)
        src = jnp.where(src >= 0, src, sent)
        W = D * S
        tc = jnp.take(seg_c, src, axis=0).reshape(-1, W)
        tv = jnp.take(seg_v, src, axis=0).reshape(-1, W)
        key2, uval = sort_dedup_rows(tc, tv, n)
        if _stage == 1:
            s1_acc.append((jnp.sum(key2), jnp.sum(uval)))
            continue
        sc, sw, truncated = _prune_select_lanes(key2, uval, n, S)
        rid = jnp.asarray(row_ids)
        new_cols = new_cols.at[rid].set(sc, mode="drop")
        new_vals = new_vals.at[rid].set(sw, mode="drop")
        nnz_out = nnz_out + jnp.sum(sc < n)
        trunc_rows = trunc_rows + jnp.sum(truncated)
    if _stage == 1:
        return tuple(s1_acc), (), {}
    if _stage == 2:
        return jnp.sum(new_cols), jnp.sum(new_vals), {}

    if plan.huge_rows.size and _stage == 3:
        c_h = _hub_dense_products(
            a_dense_huge, mt_cols, mt_vals, n, plan.hub_precision,
            krows=plan.hub_krows, khp=plan.hub_kh,
        )
        lanes = jax.lax.broadcasted_iota(INDEX_DTYPE, c_h.shape, 1)
        key = jnp.where(c_h != 0, lanes, n)
        sc, sw, truncated = _prune_select_lanes(key, c_h, n, S)
        return jnp.sum(sc), jnp.sum(sw), {}
    if _stage == 3:  # hub-free plan: nothing to measure
        return jnp.zeros(()), jnp.zeros(()), {}
    if plan.huge_rows.size:
        # hub rows: dense matmul against the densified iterate,
        # restricted to the union of iterate rows the hub references
        c_h = _hub_dense_products(
            a_dense_huge, mt_cols, mt_vals, n, plan.hub_precision,
            krows=plan.hub_krows, khp=plan.hub_kh,
        )
        lanes = jax.lax.broadcasted_iota(INDEX_DTYPE, c_h.shape, 1)
        key = jnp.where(c_h != 0, lanes, n)
        sc, sw, truncated = _prune_select_lanes(key, c_h, n, S)
        hrid = jnp.asarray(plan.huge_rows)
        new_cols = new_cols.at[hrid].set(sc, mode="drop")
        new_vals = new_vals.at[hrid].set(sw, mode="drop")
        nnz_out = nnz_out + jnp.sum(sc < n)
        trunc_rows = trunc_rows + jnp.sum(truncated)

    # convergence drift ||new - old||_F / ||old||_F on merged ELL rows
    d2, n2 = _ell_drift_sq(mt_cols, mt_vals, new_cols, new_vals, n)
    differs = jnp.sqrt(d2) / jnp.maximum(jnp.sqrt(n2), 1e-30)

    stats = {"nnz": nnz_out, "truncated_rows": trunc_rows, "differs": differs}
    return new_cols, new_vals, stats


def _dense_huge(mgt: CSR, plan: RmclEllPlan):
    """Dense Mgt hub-row block over the UNION contraction space
    ([H, hub_kh]; columns remapped through hub_kmap)."""
    if not plan.huge_rows.size:
        return jnp.zeros((0, max(plan.hub_kh, 1)), QVALUE_DTYPE)
    rows_rep = jnp.asarray(
        np.repeat(
            np.arange(plan.huge_rows.size, dtype=np.int32), plan.huge_lens
        )
    )
    src = jnp.asarray(plan.huge_src)
    kmap = jnp.asarray(plan.hub_kmap)
    kcol = jnp.take(kmap, jnp.clip(jnp.take(mgt.col_ind, src), 0, plan.n - 1))
    a_d = jnp.zeros((plan.huge_rows.size, plan.hub_kh), QVALUE_DTYPE)
    return a_d.at[
        rows_rep, jnp.clip(kcol, 0, plan.hub_kh - 1)
    ].add(jnp.take(mgt.values, src))


@partial(jax.jit, static_argnames=("plan", "max_iters"))
def rmcl_ell_scan(plan, a: CSR, a_dense_huge, mt_cols, mt_vals, max_iters: int):
    """Device-resident loop: lax.scan over the fused static step."""

    def step(carry, _):
        cols, vals = carry
        nc, nv, stats = rmcl_ell_step(plan, a, a_dense_huge, cols, vals)
        return (nc, nv), stats

    (cols, vals), hist = jax.lax.scan(
        step, (mt_cols, mt_vals), None, length=max_iters
    )
    return cols, vals, hist


def rmcl_ell(
    graph,
    max_iters: int = 5,
    S: int = 128,
    max_tile: int = 8192,
    hub_precision: str = "f32",
):
    """End-to-end static fused R-MCL (the fast path of models.rmcl.rmcl).

    ``graph``: COO (raw) or CSR (initialised via rmcl_init).  Returns
    (final CSR, stats history dict of arrays).
    """
    from .rmcl import rmcl_init
    from ..formats.coo import COO

    mt0 = rmcl_init(graph) if isinstance(graph, COO) else graph
    # the ELL iterate invariant (sorted, unique columns per row, see
    # mt_to_ell) starts from an ordered CSR; rmcl_init guarantees it, a
    # caller-supplied CSR may not — normalise once
    mt0 = mt0.make_ordered()
    plan = plan_rmcl_ell(
        mt0, S=S, max_tile=max_tile, hub_precision=hub_precision
    )
    cols, vals = mt_to_ell(mt0, S)
    a_d = _dense_huge(mt0, plan)
    cols, vals, hist = rmcl_ell_scan(plan, mt0, a_d, cols, vals, max_iters)
    out = ell_to_csr(cols, vals, mt0.ncols)
    return out, {k: np.asarray(v) for k, v in hist.items()}

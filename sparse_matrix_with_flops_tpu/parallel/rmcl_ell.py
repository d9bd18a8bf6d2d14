"""Distributed static fused R-MCL: the flagship multi-chip loop.

The sharded counterpart of models/rmcl_ell.py.  The iterate is a
dense-shaped ELL pair ``[n, S]`` and the per-iteration exchange comes in
two flavours:

* ``exchange="ring"`` (default, memory-scalable): the iterate blocks
  ``[lr, S]`` ROTATE around the mesh via `jax.lax.ppermute` (the SpGEMM
  analogue of ring attention's rotating KV, SURVEY.md §2.6 last row).
  The planner pre-groups each shard's Mgt entries by the rotation step
  that delivers their iterate row, so each step gathers exactly that
  step's segments from the resident block and the hub-dense partial
  product consumes the matching column slice — per-chip peak iterate
  footprint is ~2 blocks (2·n·S/D values) instead of the whole ``[n, S]``.
  XLA's async collective-permute overlaps the next block transfer with
  the current block's gather/matmul work.
* ``exchange="all_gather"``: one dense all_gather per iteration (round-1
  behaviour; full ``[n, S]`` replica per chip — fastest at small n).

Common structure:

* Mgt is row-sharded once (flops follow the fixed structure, so the
  flops-balanced permutation of `sharded.py` applies verbatim);
* per-shard degree-bin plans are UNIFIED to common shapes (max row count
  per class across shards, padded with -1) so one SPMD program serves all
  shards — the shard-varying content (row ids, entry ids, hub-row dense
  blocks) travels as sharded *data*, not as program constants;
* stats (nnz, truncation, convergence norm) are psum'd.

The scan keeps the sharded iterate device-resident across iterations —
gpuRmclIter (gpu_csr_kernel.cu:281-311) generalised to a mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..config import INDEX_DTYPE, MATMUL_PRECISION, QVALUE_DTYPE
from ..formats.csr import CSR
from ..models.rmcl_ell import (
    _ell_drift_sq,
    _hub_dense_products,
    _pow2ceil,
    _prune_select_lanes,
)
from ..ops.segments import sort_dedup_rows
from .mesh import ROW_AXIS
from .sharded import ShardedCSR, shard_csr


# the iterate exchanges; both are XLA collectives under shard_map
EXCHANGES = ("ring", "all_gather")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedRmclPlan:
    n: int  # global (padded) rows = D * lr
    lr: int  # local rows per shard
    S: int
    bin_shapes: tuple  # ((D_class, R_pad), ...) common across shards
    hmax: int  # unified hub-row count per shard
    num_shards: int = 0
    step_widths: tuple = ()  # ring mode: per-rotation-step entry-group pad
    # gather-mode hub union (global across shards; plan constants)
    hub_krows: np.ndarray | None = None  # int32[hub_kh], -1 padded
    hub_kh: int = 0

    __hash__ = object.__hash__


def plan_sharded_rmcl_ell(
    mgt: CSR, num_shards: int, S: int = 128, max_tile: int = 8192
):
    """Shard Mgt + build unified per-shard degree-bin arrays.

    Returns (plan, arrays) where arrays is a dict of stacked [D, ...]
    device arrays (sharded over 'x' by the caller).
    """
    smgt = shard_csr(mgt, num_shards)
    lr = smgt.local_rows
    # largest pow2 degree class in budget (see models/rmcl_ell.plan_rmcl_ell)
    dmax = 1
    while dmax * 2 <= max(max_tile // S, 1):
        dmax *= 2

    per_shard = []
    classes = []
    d = 1
    while d <= dmax:
        classes.append(d)
        d *= 2
    hmaxs = []
    for sh in range(num_shards):
        rp = np.asarray(smgt.row_ptr[sh], dtype=np.int64)
        deg = np.diff(rp)
        shard_bins = {}
        for dc in classes:
            lo = dc // 2 + 1 if dc > 1 else 1
            sel = np.nonzero((deg >= lo) & (deg <= dc))[0]
            shard_bins[dc] = sel
        huge = np.nonzero(deg > dmax)[0]
        per_shard.append((rp, deg, shard_bins, huge))
        hmaxs.append(huge.size)
    hmax = max(max(hmaxs), 0)

    bin_shapes = []
    arrays = {"row_ids": [], "ent_src": []}
    for dc in classes:
        rmax = max(ps[2][dc].size for ps in per_shard)
        if rmax == 0:
            continue
        rpad = max(8, _pow2ceil(rmax))
        bin_shapes.append((dc, rpad))
        rid_stack = np.full((num_shards, rpad), -1, np.int32)
        src_stack = np.full((num_shards, rpad * dc), -1, np.int32)
        for sh, (rp, deg, shard_bins, _) in enumerate(per_shard):
            sel = shard_bins[dc]
            rid_stack[sh, : sel.size] = sel
            es = np.full((sel.size, dc), -1, np.int64)
            for k in range(dc):
                has = deg[sel] > k
                es[has, k] = rp[sel[has]] + k
            src_stack[sh, : sel.size * dc] = es.reshape(-1)
        arrays["row_ids"].append(jnp.asarray(rid_stack))
        arrays["ent_src"].append(jnp.asarray(src_stack))

    # unified hub rows — built SPARSELY throughout: the round-3 planner
    # materialized dense [D, hmax, n] blocks twice (host a_dense + the
    # ring colblk), ~9 GB each at s16-scale hub counts (VERDICT r3
    # Weak #5).  Everything below is bulk scatters on hub entries only.
    n_pad = smgt.padded_rows
    hrow_stack = np.full((num_shards, max(hmax, 1)), -1, np.int32)
    # flat hub entry lists per shard: (hub slot, col, val)
    hub_ent = []  # [(sh, slot_arr, col_arr, val_arr)]
    for sh, (rp, deg, _, huge) in enumerate(per_shard):
        hrow_stack[sh, : huge.size] = huge
        col = np.asarray(smgt.col_ind[sh])
        val = np.asarray(smgt.values[sh])
        if huge.size:
            from ..utils.nphost import concat_ranges, fast_repeat

            src = concat_ranges(rp[huge], rp[huge + 1])
            slot = fast_repeat(
                np.arange(huge.size, dtype=np.int64), rp[huge + 1] - rp[huge]
            ).astype(np.int64)
            hub_ent.append(
                (sh, slot, np.clip(col[src], 0, n_pad - 1), val[src])
            )
    arrays["huge_rows"] = jnp.asarray(hrow_stack)
    # gather-mode hub: restrict the dense contraction to the union of
    # iterate rows ANY shard's hub rows reference (global union so the
    # SPMD shapes stay uniform) — the ell_esc hub-union law
    if hub_ent:
        krows = np.unique(np.concatenate([c for _, _, c, _ in hub_ent]))
        kh = int(krows.size)
        khp = max(128, -(-kh // 128) * 128)
        kr_pad = np.full(khp, -1, np.int32)
        kr_pad[:kh] = krows
        pos = np.zeros(n_pad, np.int64)  # global col -> union slot
        pos[krows] = np.arange(kh)
        a_dense_u = np.zeros((num_shards, max(hmax, 1), khp), np.float32)
        for sh, slot, c, v in hub_ent:
            np.add.at(a_dense_u[sh], (slot, pos[c]), v)
    else:
        khp = 128
        kr_pad = np.full(khp, -1, np.int32)
        a_dense_u = np.zeros((num_shards, max(hmax, 1), khp), np.float32)
    arrays["a_dense_u"] = jnp.asarray(a_dense_u)
    # ring-mode hub layout, union-restricted AND sparse on host/device:
    # at rotation step k chip me needs shard v's hub rows x the union of
    # their nonzero columns INSIDE me's block ([hmax, khb] with
    # kidx[me, v] mapping union slots to local iterate rows).  Round 3
    # stored that block DENSE per (me, v) pair, planned from a dense
    # [D, hmax, n] host array (~GBs at s16 hub counts — VERDICT r3
    # Weak #5); for power-law hubs khb saturates to lr, so a dense
    # colblk_u is no better.  Instead the planner ships hub entries as
    # (slot, union-pos, val) TRIPLETS per pair — O(hub nnz) host/device
    # bytes — and the device densifies the [hmax, khb] operand per step
    # with one scatter-add (transient, ~hmax*khb*4 bytes).
    # Triplet pads carry slot = -1 -> remapped to hmax, dropped by the
    # scatter's OOB mode; kidx pads are -1 with zero contributions.
    pair_loc = [[None] * num_shards for _ in range(num_shards)]
    khb, emax = 1, 1
    for sh, slot, c, v in hub_ent:
        owner_blk = c // lr
        for me in range(num_shards):
            inb = owner_blk == me
            loc = np.unique(c[inb] - me * lr)
            pair_loc[me][sh] = loc
            khb = max(khb, int(loc.size))
            emax = max(emax, int(inb.sum()))
    khb = max(8, _pow2ceil(khb))
    emax = max(8, _pow2ceil(emax))
    kidx = np.full((num_shards, num_shards, khb), -1, np.int32)
    h_slot = np.full((num_shards, num_shards, emax), -1, np.int32)
    h_pos = np.zeros((num_shards, num_shards, emax), np.int32)
    h_val = np.zeros((num_shards, num_shards, emax), np.float32)
    for sh, slot, c, v in hub_ent:
        owner_blk = c // lr
        for me in range(num_shards):
            loc = pair_loc[me][sh]
            if loc is None or not loc.size:
                continue
            kidx[me, sh, : loc.size] = loc
            lpos = np.zeros(lr, np.int64)
            lpos[loc] = np.arange(loc.size)
            inb = owner_blk == me
            ne = int(inb.sum())
            h_slot[me, sh, :ne] = slot[inb]
            h_pos[me, sh, :ne] = lpos[c[inb] - me * lr]
            h_val[me, sh, :ne] = v[inb]
    arrays["hub_ent_slot"] = jnp.asarray(h_slot)
    arrays["hub_ent_pos"] = jnp.asarray(h_pos)
    arrays["hub_ent_val"] = jnp.asarray(h_val)
    arrays["hub_kidx"] = jnp.asarray(kidx)

    # ring-exchange entry groups: entry e of shard sh is served at the
    # rotation step k where the resident block's owner (sh - k) mod D
    # equals owner(col_e) = col_e // lr.  Group sizes differ per shard, so
    # each step's group is padded to the max across shards (static SPMD
    # shapes); -1 pads are dropped by the kernel's scatter.
    step_groups = [[] for _ in range(num_shards)]
    for sh in range(num_shards):
        nnz_sh = int(np.asarray(smgt.row_ptr[sh])[-1])
        col = np.asarray(smgt.col_ind[sh])[:nnz_sh]
        owner = np.clip(col, 0, n_pad - 1) // lr
        k_of_e = (sh - owner) % num_shards
        for k in range(num_shards):
            step_groups[sh].append(
                np.nonzero(k_of_e == k)[0].astype(np.int32)
            )
    step_widths = []
    arrays["step_ents"] = []
    for k in range(num_shards):
        emax = max(max(g[k].size for g in step_groups), 1)
        emax = max(8, _pow2ceil(emax))
        step_widths.append(emax)
        stack = np.full((num_shards, emax), -1, np.int32)
        for sh in range(num_shards):
            g = step_groups[sh][k]
            stack[sh, : g.size] = g
        arrays["step_ents"].append(jnp.asarray(stack))

    plan = ShardedRmclPlan(
        n=n_pad,
        lr=lr,
        S=int(S),
        bin_shapes=tuple(bin_shapes),
        hmax=int(hmax),
        num_shards=num_shards,
        step_widths=tuple(step_widths),
        hub_krows=kr_pad,
        hub_kh=int(khp),
    )
    return plan, arrays, smgt


def _segments_gathered(plan, a_rp, a_ci, a_v, g_cols, g_vals):
    """Per-entry segments from a fully gathered [n, S] iterate."""
    n, S = plan.n, plan.S
    cap = a_ci.shape[0]
    safe_col = jnp.clip(a_ci, 0, n - 1)
    valid = jnp.arange(cap) < a_rp[-1]
    seg_c = jnp.where(valid[:, None], jnp.take(g_cols, safe_col, axis=0), n)
    seg_v = jnp.where(
        valid[:, None], jnp.take(g_vals, safe_col, axis=0) * a_v[:, None], 0.0
    )
    seg_c = jnp.concatenate([seg_c, jnp.full((1, S), n, INDEX_DTYPE)], axis=0)
    seg_v = jnp.concatenate([seg_v, jnp.zeros((1, S), QVALUE_DTYPE)], axis=0)
    return seg_c, seg_v


def _segments_ring(
    plan, a_ci, a_v, step_ents, hub_tri, kidx, block_c, block_v, axis,
    hub: bool = True,
):
    """Per-entry segments + hub partial products via ring rotation.

    The iterate blocks ``[lr, S]`` rotate rightwards around the mesh; at
    step k shard ``me`` holds the block of owner ``(me - k) mod D`` and
    fills exactly the entry group the planner assigned to step k.  Peak
    resident iterate: TWO blocks (the held one + the ppermute landing
    buffer) — n·S/D scaling, vs the full [n, S] of all_gather mode.

    Hub rows rotate the ACCUMULATOR instead of re-densifying every
    visiting block (VERDICT r2 #3: that cost O(lr·n) memory writes × D steps
    = O(n²) per chip per iteration): each chip densifies its OWN iterate
    block once, and the (hmax, n) hub partials ring-rotate — at step k
    chip me holds the accumulator of shard v = (me-k) mod D and adds
    ``a_colblk[v] @ md_me`` (v's hub rows, me's columns).  After D
    rotations every accumulator has visited every block and is home.
    Per-device memory traffic for the hub drops to O(lr·n) per
    iteration; the added interconnect traffic is 4·hmax·n bytes/step, a
    win whenever hub rows are rare (hmax·D < 2n — always, since hub rows
    ≤ n).
    """
    n, S, lr, d = plan.n, plan.S, plan.lr, plan.num_shards
    cap = a_ci.shape[0]
    me = jax.lax.axis_index(axis)
    seg_c = jnp.full((cap + 1, S), n, INDEX_DTYPE)
    seg_v = jnp.zeros((cap + 1, S), QVALUE_DTYPE)
    hmax = plan.hmax if hub else 0
    perm = [(i, (i + 1) % d) for i in range(d)]
    if hmax:
        rix = jax.lax.broadcasted_iota(INDEX_DTYPE, (lr, S), 0)
        md_me = jnp.zeros((lr, n), QVALUE_DTYPE)
        md_me = md_me.at[rix, block_c].add(block_v, mode="drop")
        c_h = jnp.zeros((hmax, n), QVALUE_DTYPE)
    else:
        c_h = None
    for k in range(d):
        owner = (me - k) % d
        bstart = owner * lr
        ids = step_ents[k]  # [Ek] local entry indices, -1 padded
        safe_ids = jnp.clip(ids, 0, cap - 1)
        col = jnp.take(a_ci, safe_ids)
        loc = jnp.clip(col - bstart, 0, lr - 1)
        sc = jnp.take(block_c, loc, axis=0)
        sv = jnp.take(block_v, loc, axis=0) * jnp.take(a_v, safe_ids)[:, None]
        tgt = jnp.where(ids >= 0, ids, cap + 1)  # pads drop out of bounds
        seg_c = seg_c.at[tgt].set(sc, mode="drop")
        seg_v = seg_v.at[tgt].set(sv, mode="drop")
        if hmax:
            # held accumulator belongs to v = owner; add v's hub rows x
            # me's columns against the once-densified local block.
            # The [hmax, khb] operand is densified HERE from the owner's
            # hub-entry triplets (one scatter-add over <= emax entries;
            # pad slots are hmax -> dropped OOB), so only O(hub nnz)
            # bytes stay resident instead of a dense per-pair block
            h_slot, h_pos, h_val = hub_tri
            slot = jnp.take(h_slot, owner, axis=0)  # [emax]
            pos = jnp.take(h_pos, owner, axis=0)
            hv = jnp.take(h_val, owner, axis=0)
            idx = jnp.take(kidx, owner, axis=0)  # [khb]
            khb = idx.shape[0]
            ab = (
                jnp.zeros((hmax, khb), QVALUE_DTYPE)
                .at[jnp.where(slot >= 0, slot, hmax), pos]
                .add(hv, mode="drop")
            )
            md_sel = jnp.take(
                md_me, jnp.clip(idx, 0, lr - 1), axis=0
            )  # [khb, n]
            c_h = c_h + jnp.dot(
                ab,
                md_sel,
                preferred_element_type=jnp.float32,
                precision=MATMUL_PRECISION,
            )
            c_h = jax.lax.ppermute(c_h, axis, perm)
        if k + 1 < d:
            block_c = jax.lax.ppermute(block_c, axis, perm)
            block_v = jax.lax.ppermute(block_v, axis, perm)
    return seg_c, seg_v, c_h


def _local_step(plan, a_rp, a_ci, a_v, row_ids, ent_src, huge_rows, a_dense,
                seg_c, seg_v, c_h=None):
    """Fused step on one shard's rows given per-entry segments (and, in
    ring mode, precomputed hub products)."""
    n, S, lr = plan.n, plan.S, plan.lr
    sent = seg_c.shape[0] - 1

    new_cols = jnp.full((lr, S), n, INDEX_DTYPE)
    new_vals = jnp.zeros((lr, S), QVALUE_DTYPE)
    nnz_out = jnp.zeros((), INDEX_DTYPE)
    trunc = jnp.zeros((), INDEX_DTYPE)
    for (dc, rpad), rid, src in zip(plan.bin_shapes, row_ids, ent_src):
        s = jnp.where(src >= 0, src, sent)
        W = dc * S
        tc = jnp.take(seg_c, s, axis=0).reshape(rpad, W)
        tv = jnp.take(seg_v, s, axis=0).reshape(rpad, W)
        key2, uval = sort_dedup_rows(tc, tv, n)
        sc, sw, truncated = _prune_select_lanes(key2, uval, n, S)
        tgt = jnp.where(rid >= 0, rid, lr)
        new_cols = new_cols.at[tgt].set(sc, mode="drop")
        new_vals = new_vals.at[tgt].set(sw, mode="drop")
        ok = rid >= 0
        nnz_out = nnz_out + jnp.sum(jnp.where(ok[:, None], sc < n, False))
        trunc = trunc + jnp.sum(jnp.where(ok, truncated, False))

    if plan.hmax:
        lanes = jax.lax.broadcasted_iota(INDEX_DTYPE, c_h.shape, 1)
        key = jnp.where(c_h != 0, lanes, n)
        sc, sw, truncated = _prune_select_lanes(key, c_h, n, S)
        tgt = jnp.where(huge_rows >= 0, huge_rows, lr)
        new_cols = new_cols.at[tgt].set(sc, mode="drop")
        new_vals = new_vals.at[tgt].set(sw, mode="drop")
        ok = huge_rows >= 0
        nnz_out = nnz_out + jnp.sum(jnp.where(ok[:, None], sc < n, False))
        trunc = trunc + jnp.sum(jnp.where(ok, truncated, False))
    return new_cols, new_vals, nnz_out, trunc


@partial(
    jax.jit, static_argnames=("mesh", "plan", "axis", "max_iters", "exchange")
)
def sharded_rmcl_ell_scan(
    mesh,
    plan: ShardedRmclPlan,
    smgt: ShardedCSR,
    arrays,
    mt_cols,
    mt_vals,
    max_iters: int,
    axis: str = ROW_AXIS,
    exchange: str = "ring",
):
    """Device-resident multi-chip loop; ``mt_cols/vals`` are stacked
    [D, lr, S] (sharded over 'x').  ``exchange``: "ring" (ppermute block
    rotation, memory-scalable) or "all_gather" (full replica per chip)."""
    if exchange not in EXCHANGES:
        raise ValueError(
            f"exchange must be one of {EXCHANGES}, got {exchange!r}"
        )
    n, S, lr = plan.n, plan.S, plan.lr

    def kernel(
        a_rp, a_ci, a_v, row_ids, ent_src, step_ents, huge_rows, a_dense_u,
        h_slot, h_pos, h_val, hub_kidx, c0, v0,
    ):
        def step(carry, _):
            lc, lv = carry  # [1, lr, S] local shards
            if exchange == "ring":
                seg_c, seg_v, c_h = _segments_ring(
                    plan,
                    a_ci[0],
                    a_v[0],
                    [s[0] for s in step_ents],
                    (h_slot[0], h_pos[0], h_val[0]),
                    hub_kidx[0],
                    lc[0],
                    lv[0],
                    axis,
                )
            else:
                g_c = jax.lax.all_gather(lc[0], axis).reshape(n, S)
                g_v = jax.lax.all_gather(lv[0], axis).reshape(n, S)
                seg_c, seg_v = _segments_gathered(
                    plan, a_rp[0], a_ci[0], a_v[0], g_c, g_v
                )
                c_h = (
                    _hub_dense_products(
                        a_dense_u[0], g_c, g_v, n,
                        krows=jnp.asarray(plan.hub_krows),
                        khp=plan.hub_kh,
                    )
                    if plan.hmax
                    else None
                )
            nc, nv, nnz, trunc = _local_step(
                plan,
                a_rp[0],
                a_ci[0],
                a_v[0],
                [r[0] for r in row_ids],
                [s[0] for s in ent_src],
                huge_rows[0],
                a_dense_u[0],
                seg_c,
                seg_v,
                c_h,
            )
            # convergence: local diff via merged rows, psum'd
            ld2, ln2 = _ell_drift_sq(lc[0], lv[0], nc, nv, n)
            d2 = jax.lax.psum(ld2, axis)
            n2 = jax.lax.psum(ln2, axis)
            stats = {
                "nnz": jax.lax.psum(nnz, axis),
                "truncated_rows": jax.lax.psum(trunc, axis),
                "differs": jnp.sqrt(d2) / jnp.maximum(jnp.sqrt(n2), 1e-30),
            }
            return (nc[None], nv[None]), stats

        (fc, fv), hist = jax.lax.scan(step, (c0, v0), None, length=max_iters)
        return fc, fv, hist

    spec = P(axis)
    rep = P()
    stats_spec = {"nnz": rep, "truncated_rows": rep, "differs": rep}
    fc, fv, hist = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(
            (spec,) * 3
            + ([spec] * len(arrays["row_ids"]),)
            + ([spec] * len(arrays["ent_src"]),)
            + ([spec] * len(arrays["step_ents"]),)
            + (spec, spec, spec, spec, spec, spec, spec, spec)
        ),
        out_specs=(spec, spec, stats_spec),
        check_vma=False,
    )(
        smgt.row_ptr,
        smgt.col_ind,
        smgt.values,
        arrays["row_ids"],
        arrays["ent_src"],
        arrays["step_ents"],
        arrays["huge_rows"],
        arrays["a_dense_u"],
        arrays["hub_ent_slot"],
        arrays["hub_ent_pos"],
        arrays["hub_ent_val"],
        arrays["hub_kidx"],
        mt_cols,
        mt_vals,
    )
    return fc, fv, hist


def sharded_rmcl_ell(
    graph,
    mesh,
    max_iters: int = 5,
    S: int = 128,
    max_tile: int = 8192,
    axis: str = ROW_AXIS,
    balance: bool = False,
    exchange: str = "ring",
):
    """End-to-end distributed static R-MCL.  Returns (CSR, stats).

    ``balance=True`` relabels the graph with the flops-balanced snake
    permutation (arrayEqualPartition's static-shape descendant,
    sharded.py) so every shard carries near-equal first-iteration flops;
    the result is relabelled back before returning.
    """
    from ..formats.coo import COO
    from ..models.rmcl import rmcl_init
    from ..models.rmcl_ell import ell_to_csr, mt_to_ell

    mt0 = rmcl_init(graph) if isinstance(graph, COO) else graph
    # ordered CSR in, as models.rmcl_ell.rmcl_ell requires
    mt0 = mt0.make_ordered()
    num_shards = mesh.devices.size
    inv_perm = None
    if balance:
        from ..ops.flops import footprint_row_costs
        from .sharded import flops_balanced_permutation

        # footprint costs, not raw flops: the dealt shards must balance
        # padded descriptors + output writes (footPrintsCrowiCount,
        # static_omp_csr_kernel.cc:28-62), which diverge from flops by
        # ~17x between banded and power-law rows (VERDICT r3 #2)
        rf = footprint_row_costs(mt0, mt0, chunk=S)
        perm = flops_balanced_permutation(rf, num_shards)
        inv_perm = np.zeros_like(perm)
        inv_perm[perm] = np.arange(perm.size, dtype=perm.dtype)
        # conjugate relabel (P M Pt): rows AND cols, so the iteration is
        # isomorphic and shards get near-equal flops
        mt0 = mt0.conjugate_permute(jnp.asarray(perm))
    plan, arrays, smgt = plan_sharded_rmcl_ell(
        mt0, num_shards, S=S, max_tile=max_tile
    )
    cols, vals = mt_to_ell(mt0, S)
    # remap the ELL sentinel (ncols) to the padded global sentinel (n)
    cols = jnp.where(cols >= mt0.ncols, plan.n, cols)
    # pad the iterate to the sharded row count and stack per shard
    pad = plan.n - mt0.rows
    if pad:
        cols = jnp.concatenate(
            [cols, jnp.full((pad, S), plan.n, INDEX_DTYPE)], axis=0
        )
        vals = jnp.concatenate([vals, jnp.zeros((pad, S))], axis=0)
    mt_cols = cols.reshape(num_shards, plan.lr, S)
    mt_vals = vals.reshape(num_shards, plan.lr, S)
    fc, fv, hist = sharded_rmcl_ell_scan(
        mesh, plan, smgt, arrays, mt_cols, mt_vals, max_iters, axis,
        exchange,
    )
    out = ell_to_csr(
        np.asarray(fc).reshape(plan.n, S)[: mt0.rows],
        np.asarray(fv).reshape(plan.n, S)[: mt0.rows],
        mt0.ncols,
    )
    if inv_perm is not None:
        out = out.conjugate_permute(jnp.asarray(inv_perm))
    return out, {k: np.asarray(v) for k, v in hist.items()}

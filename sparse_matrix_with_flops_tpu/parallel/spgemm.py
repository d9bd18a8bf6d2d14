"""Distributed SpGEMM: row-partitioned A/C, all-gathered B over the mesh.

The layer the reference does not have (SURVEY.md §2.6: no distributed
backend; its closest gestures are PCSR column stripes, PCSR.cc:3-56, and
per-thread private outputs, mvcsr.cc:124-226).  Design:

* A and C are row-sharded (`PartitionSpec('x')` on the shard-stack axis) —
  each chip owns a contiguous block of rows, permuted for equal flops.
* B is all-gathered across the mesh inside the kernel (jax.lax.all_gather
  by the collective) and consumed through a :class:`BView` without restitching —
  the SpGEMM analogue of a ragged all-gather of remote KV blocks.
* Each chip runs the same single-chip ESC pipeline on its rows; there is
  no cross-chip reduction because Gustavson rows are independent.

The result never leaves the chips: it stays a ShardedCSR for the next op
(the R-MCL loop keeps the iterate device-resident, mirroring gpuRmclIter,
gpu_csr_kernel.cu:281-311).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..config import INDEX_DTYPE, QVALUE_DTYPE
from ..formats.csr import CSR
from ..ops.spgemm import bview_from_blocks, esc_expand_view, esc_sort
from ..ops.segments import exclusive_cumsum, repeat_segments
from .mesh import ROW_AXIS
from .sharded import ShardedCSR


def _local_spgemm(
    a_rp, a_ci, a_v, bv, ncols: int, product_cap: int, out_cap: int
):
    """Single-shard ESC SpGEMM of the local A block against a B view."""
    a = CSR(a_rp, a_ci, a_v, bv.rows)  # a.ncols only checked, use B rows
    m = a.rows
    prow, pcol, pval, flops = esc_expand_view(a, bv, product_cap)
    prow, pcol, pval, pvalid, flags, seg, nnzc = esc_sort(prow, pcol, pval, m)
    seg = jnp.where(pvalid, seg, out_cap)
    cval = jnp.zeros((out_cap,), QVALUE_DTYPE).at[seg].add(pval, mode="drop")
    crow = jnp.full((out_cap,), m, INDEX_DTYPE).at[seg].min(prow, mode="drop")
    ccol = jnp.full((out_cap,), ncols, INDEX_DTYPE).at[seg].min(pcol, mode="drop")
    row_ptr = jnp.searchsorted(
        crow, jnp.arange(m + 1, dtype=INDEX_DTYPE)
    ).astype(INDEX_DTYPE)
    return row_ptr, ccol, cval, flops, nnzc


@partial(
    jax.jit,
    static_argnames=("mesh", "product_cap", "out_cap", "axis"),
)
def sharded_spgemm(
    mesh,
    a: ShardedCSR,
    b: ShardedCSR,
    product_cap: int,
    out_cap: int,
    axis: str = ROW_AXIS,
) -> tuple[ShardedCSR, dict]:
    """C = A·B with A, B, C all row-sharded over ``mesh``.

    ``product_cap`` / ``out_cap`` are *per-shard* capacities (flops-balanced
    sharding keeps them near total/D).  Returns (C sharded, info dict with
    per-shard flops / nnz arrays).
    """
    ncols = b.ncols

    def kernel(a_rp, a_ci, a_v, b_rp, b_ci, b_v):
        # blocks arrive with leading shard axis of size 1
        g_rp = jax.lax.all_gather(b_rp[0], axis)  # [D, lr+1]
        g_ci = jax.lax.all_gather(b_ci[0], axis)  # [D, lcap]
        g_v = jax.lax.all_gather(b_v[0], axis)
        bv = bview_from_blocks(g_rp, g_ci, g_v, ncols)
        c_rp, c_ci, c_v, flops, nnzc = _local_spgemm(
            a_rp[0], a_ci[0], a_v[0], bv, ncols, product_cap, out_cap
        )
        return (
            c_rp[None],
            c_ci[None],
            c_v[None],
            flops[None],
            nnzc[None],
        )

    spec = P(axis)
    c_rp, c_ci, c_v, flops, nnzc = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(spec,) * 6,
        out_specs=(spec,) * 5,
        check_vma=False,
    )(a.row_ptr, a.col_ind, a.values, b.row_ptr, b.col_ind, b.values)
    c = ShardedCSR(c_rp, c_ci, c_v, ncols, a.global_rows)
    return c, {"flops": flops, "nnz": nnzc}


@dataclasses.dataclass(frozen=True, eq=False)
class RingPlan:
    """Static shapes of the per-step entry groups and product streams
    (identity-hashed jit static arg; the group CONTENT travels as sharded
    data)."""

    step_widths: tuple  # Ek: padded entry-group size per rotation step
    step_prod_caps: tuple  # PK: padded product count per rotation step

    __hash__ = object.__hash__


def plan_spgemm_ring(a: ShardedCSR, b: ShardedCSR):
    """Host planner for the ring exchange: group each shard's A entries by
    the rotation step that delivers their B row, and size each step's
    product stream exactly (B's structure is static, so per-(shard, step)
    product counts are host constants — the reference's P2 cost-model law,
    util.cc:123-149, applied to ring steps).

    Returns (RingPlan, step_ents) with step_ents[k] an int32[D, Ek]
    stacked array of local entry indices (-1 padded)."""
    d = a.num_shards
    lr = b.local_rows
    brp = np.asarray(b.row_ptr)
    blen = (brp[:, 1:] - brp[:, :-1]).reshape(-1).astype(np.int64)  # [D*lr]
    arp = np.asarray(a.row_ptr)
    aci = np.asarray(a.col_ind)
    groups = [[] for _ in range(d)]
    for sh in range(d):
        nnz_sh = int(arp[sh, -1])
        col = aci[sh, :nnz_sh]
        owner = np.clip(col, 0, d * lr - 1) // lr
        k_of_e = (sh - owner) % d
        for k in range(d):
            groups[k].append(np.nonzero(k_of_e == k)[0].astype(np.int32))
    widths, pcaps, step_ents = [], [], []
    for k in range(d):
        emax = max(max(g.size for g in groups[k]), 1)
        emax = -(-emax // 8) * 8
        widths.append(emax)
        stack = np.full((d, emax), -1, np.int32)
        pk = 1
        for sh in range(d):
            g = groups[k][sh]
            stack[sh, : g.size] = g
            if g.size:
                cols_g = np.clip(aci[sh][g], 0, d * lr - 1)
                pk = max(pk, int(blen[cols_g].sum()))
        pcaps.append(int(pk))
        step_ents.append(jnp.asarray(stack))
    return RingPlan(tuple(widths), tuple(pcaps)), step_ents


@partial(
    jax.jit,
    static_argnames=("mesh", "plan", "out_cap", "axis"),
)
def _ring_impl(mesh, plan, a, b, step_ents, out_cap: int, axis: str):
    ncols = b.ncols
    d = mesh.devices.size
    lr = b.local_rows
    lcap = b.local_capacity
    perm = [(i, (i + 1) % d) for i in range(d)]

    def kernel(a_rp, a_ci, a_v, b_rp, b_ci, b_v, ents):
        me = jax.lax.axis_index(axis)
        a_rp0, a_ci0, a_v0 = a_rp[0], a_ci[0], a_v[0]
        m = a_rp0.shape[0] - 1
        cap = a_ci0.shape[0]
        erow = jnp.repeat(
            jnp.arange(m, dtype=INDEX_DTYPE),
            a_rp0[1:] - a_rp0[:-1],
            total_repeat_length=cap,
        )
        blk_rp, blk_ci, blk_v = b_rp[0], b_ci[0], b_v[0]
        rows_parts, cols_parts, vals_parts = [], [], []
        total = jnp.zeros((), INDEX_DTYPE)
        for k in range(d):
            owner = (me - k) % d
            ids = ents[k][0]  # [Ek] local entry indices, -1 padded
            ek = ids.shape[0]
            pk = plan.step_prod_caps[k]
            okid = ids >= 0
            safe_ids = jnp.clip(ids, 0, cap - 1)
            acol = jnp.take(a_ci0, safe_ids)
            loc = jnp.clip(acol - owner * lr, 0, lr - 1)
            bs = jnp.take(blk_rp, loc)
            cnt = jnp.where(
                okid, (jnp.take(blk_rp, loc + 1) - bs), 0
            ).astype(INDEX_DTYPE)
            starts = exclusive_cumsum(cnt)
            tot_k = starts[-1]
            total = total + tot_k
            p = repeat_segments(starts[:-1], okid & (cnt > 0), pk)
            q = jnp.arange(pk, dtype=INDEX_DTYPE)
            pv = q < tot_k
            sp = jnp.clip(p, 0, ek - 1)
            e = jnp.take(safe_ids, sp)
            t = q - jnp.take(starts, sp)
            b_idx = jnp.clip(jnp.take(bs, sp) + t, 0, lcap - 1)
            rows_parts.append(
                jnp.where(pv, jnp.take(erow, e), m).astype(INDEX_DTYPE)
            )
            cols_parts.append(
                jnp.where(pv, jnp.take(blk_ci, b_idx), ncols).astype(
                    INDEX_DTYPE
                )
            )
            vals_parts.append(
                jnp.where(
                    pv, jnp.take(a_v0, e) * jnp.take(blk_v, b_idx), 0.0
                ).astype(QVALUE_DTYPE)
            )
            if k + 1 < d:
                blk_rp = jax.lax.ppermute(blk_rp, axis, perm)
                blk_ci = jax.lax.ppermute(blk_ci, axis, perm)
                blk_v = jax.lax.ppermute(blk_v, axis, perm)

        prow = jnp.concatenate(rows_parts)
        pcol = jnp.concatenate(cols_parts)
        pval = jnp.concatenate(vals_parts)
        prow, pcol, pval, pvalid2, flags, seg, nnzc = esc_sort(
            prow, pcol, pval, m
        )
        seg = jnp.where(pvalid2, seg, out_cap)
        cval = jnp.zeros((out_cap,), QVALUE_DTYPE).at[seg].add(
            pval, mode="drop"
        )
        crow = jnp.full((out_cap,), m, INDEX_DTYPE).at[seg].min(
            prow, mode="drop"
        )
        ccol = jnp.full((out_cap,), ncols, INDEX_DTYPE).at[seg].min(
            pcol, mode="drop"
        )
        row_ptr = jnp.searchsorted(
            crow, jnp.arange(m + 1, dtype=INDEX_DTYPE)
        ).astype(INDEX_DTYPE)
        return (
            row_ptr[None],
            ccol[None],
            cval[None],
            total[None],
            nnzc[None],
        )

    spec = P(axis)
    c_rp, c_ci, c_v, flops, nnzc = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(spec,) * 6 + ([spec] * d,),
        out_specs=(spec,) * 5,
        check_vma=False,
    )(
        a.row_ptr, a.col_ind, a.values,
        b.row_ptr, b.col_ind, b.values,
        step_ents,
    )
    c = ShardedCSR(c_rp, c_ci, c_v, ncols, a.global_rows)
    return c, {"flops": flops, "nnz": nnzc}


def sharded_spgemm_ring(
    mesh,
    a: ShardedCSR,
    b: ShardedCSR,
    product_cap: int | None = None,
    out_cap: int = 1,
    axis: str = ROW_AXIS,
    plan: RingPlan | None = None,
    step_ents=None,
) -> tuple[ShardedCSR, dict]:
    """C = A·B with B ROTATED around the mesh instead of all-gathered.

    The memory-scalable exchange (SURVEY.md §2.6 last row): B's blocks
    ring-rotate via `jax.lax.ppermute`; the host planner
    (:func:`plan_spgemm_ring`) pre-groups each shard's A entries by the
    rotation step that delivers their B row and sizes each step's product
    stream exactly, so per-chip work per step is O(products of that step)
    — the per-chip total scales ~1/D with flops-balanced sharding,
    matching the 1/D memory scaling (VERDICT r2 #3; the round-2 version
    paid D masked passes over the FULL per-shard stream).  Peak B
    footprint stays 2 blocks (2·nnz(B)/D).  Prefer :func:`sharded_spgemm`
    when B fits per-device memory.

    ``product_cap`` is accepted for API compatibility; stream sizes come
    from the planner.  Pass a prebuilt (plan, step_ents) to call from
    traced code.
    """
    if plan is None:
        plan, step_ents = plan_spgemm_ring(a, b)
    return _ring_impl(mesh, plan, a, b, step_ents, int(out_cap), axis)

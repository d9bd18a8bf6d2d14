"""Corpus runner — the tools/runs.sh / mindex2-cuda/run2.sh role.

The reference iterates its binaries over a fixed SuiteSparse/SNAP matrix
list; that corpus is not shipped, so this runner accepts a directory of
matrix files and/or generates the synthetic workload-equivalent corpus
(R-MAT power-law + banded FEM-like) and reports per-matrix SpGEMM GFLOPS
and R-MCL per-iteration wall clock as JSON lines.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import jax


def _scipy_nnzc(a) -> tuple:
    """(value nnz, structural nnz) of A·A per scipy.

    scipy's csr matmul silently DROPS entries whose f32 accumulation
    cancels to exactly 0.0 (observed: one entry in 37M at the
    pwtk-class row), so the honest oracle is a RANGE: the structural
    count (0/1 pattern product — what the block engine and the sort
    pipeline produce) down to the value-pruned count (what the dense
    hub produces, raw-equal semantics)."""
    import numpy as np
    import scipy.sparse as sp

    rp = np.asarray(a.row_ptr)
    nnz = int(rp[-1])
    sa = sp.csr_matrix(
        (np.asarray(a.values)[:nnz], np.asarray(a.col_ind)[:nnz], rp),
        shape=a.shape,
    )
    vn = int((sa @ sa).nnz)
    pat = sa.copy()
    pat.data = np.ones_like(pat.data)
    sn = int((pat @ pat).nnz)
    return vn, sn


def run_partitioned(
    name, a, parts: int, check: bool = False,
    chunk: int | None = None, max_w: int | None = None,
):
    """Reference-scale row: A row-split into flops-balanced groups, each
    group's fused kernel slope-timed separately (every group is its own
    dispatch — ops/partitioned.py's memory-bounding contract), total ms =
    sum of group slopes.  The host stitch is excluded, matching the
    reference's kernel-only GFLOPS accounting (only-somp.cc:36-37);
    host planning is reported as ``plan_ms`` and charged in
    ``gflops_cold`` because the reference times its symbolic/partition
    phases inside the multiply (static_omp_csr_kernel.cc:98-163)."""
    import time as _time

    import numpy as np

    from ..formats.csr import CSR
    from ..ops.ell_esc import _tiles_impl, plan_ell, spgemm_ell
    from ..ops.partitioned import csr_row_slice, flops_prefix_partition
    from ..ops.spgemm import spgemm_upper_bounds
    from ..utils.timing import slope_bench

    kw = {}
    if chunk is not None:
        kw["chunk"] = chunk
    if max_w is not None:
        kw["max_w"] = max_w
    product_cap, _ = spgemm_upper_bounds(a, a)
    t_plan0 = _time.monotonic()
    cuts = flops_prefix_partition(a, a, parts)
    plan_ms = (_time.monotonic() - t_plan0) * 1e3
    db = jax.device_put(a)
    total_ms, nnzc = 0.0, 0
    group_ms = []
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        a_g = csr_row_slice(a, r0, r1)
        t0 = _time.monotonic()
        plan = plan_ell(a_g, a, **kw)
        plan_ms += (_time.monotonic() - t0) * 1e3
        dg = jax.device_put(a_g)
        spgemm_ell(dg, db, plan)  # two-phase: sizes the nnz(C) bucket
        out = spgemm_ell(dg, db, plan)  # fused warm (validates bucket)
        nnzc += int(np.asarray(out.row_ptr)[-1])
        cap = getattr(plan, "_nnzc_cache")

        def step(x, dg=dg, plan=plan, cap=cap):
            a2 = CSR(dg.row_ptr, dg.col_ind, dg.values + x, dg.ncols)
            csr, n = _tiles_impl(
                a2, db, plan, plan.chunk, fused_out_cap=cap
            )
            return (csr.row_ptr, csr.col_ind, csr.values, n)

        g_ms = slope_bench(step)
        group_ms.append(round(g_ms, 3))
        total_ms += g_ms
    rec = {
        "matrix": name,
        "kernel": "ell",
        "parts": parts,
        "rows": a.rows,
        "annz": int(a.nnz),
        "oflops": product_cap,
        "ms": round(total_ms, 3),
        "gflops": round(2.0 * product_cap / total_ms / 1e6, 4),
        "plan_ms": round(plan_ms, 1),
        "gflops_cold": round(
            2.0 * product_cap / (plan_ms + total_ms) / 1e6, 4
        ),
        "platform": jax.default_backend(),
        "group_ms": group_ms,
        "timing": "slope-sum-of-groups",
    }
    if chunk is not None:
        rec["chunk"] = chunk
    if max_w is not None:
        rec["max_w"] = max_w
    if check:
        vn, sn = _scipy_nnzc(a)
        rec["nnzc"] = nnzc
        rec["nnzc_scipy"] = vn
        rec["nnzc_structural"] = sn
        rec["nnzc_ok"] = bool(vn <= nnzc <= sn)
    return rec


def prep_block_step(a, da=None):
    """Shared dense-block benchmark setup (used by run_one AND bench.py —
    one copy of the plan + exact-nnz bucket sizing + fused step logic,
    ADVICE r4 #4).  Returns ``(fn, plan_ms, cap)`` where ``fn(csr)``
    assembles the exact flat CSR into the pre-sized bucket."""
    import time as _time

    import numpy as np

    from ..ops.block_spgemm import block_spgemm_tiled, plan_block

    if da is None:
        da = jax.device_put(a)
    t0 = _time.monotonic()
    plan = plan_block(a, a)
    plan_ms = (_time.monotonic() - t0) * 1e3
    # size the exact-nnz output bucket once (the two-phase symbolic
    # role); the timed step then assembles into that fixed bucket,
    # matching the ELL path's accounting
    cap = int(
        np.asarray(jax.jit(lambda x: block_spgemm_tiled(x, x, plan).nnz)(da))
    )

    def fn(x):
        return block_spgemm_tiled(x, x, plan).to_csr(out_cap=cap)

    return fn, plan_ms, cap


def run_one(name, a, kernel: str, check: bool = False,
            chunk: int | None = None, max_w: int | None = None):
    import time as _time

    from ..formats.csr import CSR
    from ..ops.binned import plan_bins, spgemm_binned
    from ..ops.ell_esc import plan_ell, spgemm_ell
    from ..ops.spgemm import spgemm, spgemm_upper_bounds
    from ..utils.timing import slope_bench

    product_cap, out_cap = spgemm_upper_bounds(a, a)
    da = jax.device_put(a)
    plan_ms = None
    t_plan0 = _time.monotonic()
    routed = None
    if kernel == "auto":
        from ..ops.dispatch import route

        kernel, fill = route(a, a)
        routed = {"fill": round(fill, 4), "kernel": kernel}
    kw = {}
    if chunk is not None:
        kw["chunk"] = chunk
    if max_w is not None:
        kw["max_w"] = max_w
    if kernel == "esc":
        fn = lambda x: spgemm(x, x, product_cap, out_cap)
    elif kernel == "binned":
        plan = plan_bins(a, a)
        fn = lambda x: spgemm_binned(x, x, plan)
    elif kernel == "ell-tiled":
        from ..ops.ell_esc import spgemm_ell_tiled

        plan = plan_ell(a, a, split_hub=False, **kw)
        fn = lambda x: spgemm_ell_tiled(x, x, plan)
    elif kernel == "block":
        # host planning = route fill estimate (when we came through
        # 'auto'; t_plan0 predates it) + plan_block; the bucket-sizing
        # device call inside prep_block_step is excluded, as on the ELL
        # path
        pre_ms = (_time.monotonic() - t_plan0) * 1e3
        fn, p_ms, _cap = prep_block_step(a, da)
        plan_ms = pre_ms + p_ms
    else:
        from ..ops.ell_esc import _tiles_impl

        plan = plan_ell(a, a, **kw)
        plan_ms = (_time.monotonic() - t_plan0) * 1e3
        # warm twice: the second exact call caches + validates the
        # nnz(C) bucket; the timed op is then the trace-safe fused
        # single-dispatch kernel with that bucket
        spgemm_ell(da, da, plan)
        spgemm_ell(da, da, plan)
        cap = getattr(plan, "_nnzc_cache")

        def fn(x):
            csr, _ = _tiles_impl(
                x, x, plan, plan.chunk, fused_out_cap=cap
            )
            return csr

    if plan_ms is None:
        plan_ms = (_time.monotonic() - t_plan0) * 1e3

    def step(x):
        a2 = CSR(da.row_ptr, da.col_ind, da.values + x, da.ncols)
        # tree leaves keep this generic over CSR and TiledCSR results
        # (ell-tiled returns TiledCSR, which has no .col_ind attribute)
        return tuple(jax.tree.leaves(fn(a2)))

    ms = slope_bench(step)
    rec = {
        "matrix": name,
        "kernel": kernel,
        "rows": a.rows,
        "annz": int(a.nnz),
        "oflops": product_cap,
        "ms": round(ms, 3),
        "gflops": round(2.0 * product_cap / ms / 1e6, 4),
        "plan_ms": round(plan_ms, 1),
        "gflops_cold": round(2.0 * product_cap / (plan_ms + ms) / 1e6, 4),
        "platform": jax.default_backend(),
        "timing": "slope",
    }
    if chunk is not None:
        rec["chunk"] = chunk
    if max_w is not None:
        rec["max_w"] = max_w
    if routed is not None:
        rec["routed"] = routed
    if check:
        # exact nnz(C) cross-check vs scipy's Gustavson (host oracle)
        import numpy as np

        vn, sn = _scipy_nnzc(a)
        out = jax.jit(fn)(da)
        if hasattr(out, "counts"):  # TiledCSR (ell-tiled)
            got_nnz = int(np.asarray(jax.jit(lambda o: o.nnz)(out)))
        else:
            got_nnz = int(np.asarray(out.row_ptr)[-1])
        rec["nnzc"] = got_nnz
        rec["nnzc_scipy"] = vn
        rec["nnzc_structural"] = sn
        rec["nnzc_ok"] = bool(vn <= got_nnz <= sn)
    return rec


def _ell_tile_gb(a) -> float:
    """Rough single-dispatch ELL tile footprint (GB): pow2-padded row
    widths x 2 planes x 4 B x ~3 live copies through the sort.  Band
    matrices pad brutally (cant: 6240-wide rows -> 8192-wide bins x 62k
    rows ~ 12+ GB) — the duel must know before dispatching."""
    import numpy as np

    from ..utils.nphost import (
        csr_host,
        pow2ceil_arr,
        segment_sums,
        snap_chunks_arr,
    )

    rp, ci = csr_host(a)
    nnz = int(rp[-1])
    bc = np.diff(rp)
    safe = np.clip(ci[:nnz], 0, a.rows - 1)
    elen = bc[safe]
    chunk = 32
    epw = snap_chunks_arr(np.maximum(-(-elen // chunk), 1)) * chunk
    epw[elen == 0] = 0
    prow = segment_sums(epw, rp)
    wr = pow2ceil_arr(np.maximum(prow, chunk))
    binned = wr[(prow > 0) & (wr <= 8192)]
    return float(binned.sum()) * 2 * 4 * 3 / 1e9


def _device_limit_gb() -> float:
    """Memory the allocator may hand out on device 0, in GB."""
    return jax.devices()[0].memory_stats()["bytes_limit"] / 1e9


def run_duel(name, a, check: bool = False):
    """Run BOTH engines plus the production route decision, recording
    how much the auto choice loses to the better engine (VERDICT r4 #5:
    the dispatch boundary must be validated, not extrapolated from one
    calibration point per side)."""
    from ..ops.dispatch import route

    kernel, fill = route(a, a)
    limit_gb = _device_limit_gb()
    recs, errs = {}, {}
    for k in ("block", "ell"):
        if k == "block" and fill < 0.02:
            # power-law block plans explode (pairs ~ nnz^2/blocks); the
            # boundary question only matters near the threshold
            continue
        if k == "ell":
            gb = _ell_tile_gb(a)
            # the estimate is rough (~3 live copies), so keep a wide
            # margin: skip past 3/8 of what the allocator may hand out
            if gb > 0.375 * limit_gb:
                # a single-dispatch ELL tile footprint past device memory
                # doesn't just fail, it poisons the process for later
                # matrices (a live OOM leaves the allocator unable to
                # serve the NEXT duel's block plan) — pre-estimate and
                # skip; the partitioned driver is the answer there
                errs[k] = f"skipped: ~{gb:.1f} GB single-dispatch tiles"
                continue
        try:
            recs[k] = run_one(name, a, k, check=check)
        except Exception as e:
            errs[k] = f"{type(e).__name__}: {str(e)[:120]}"
    if kernel not in recs:
        kernel = next(iter(recs))
    rec = dict(recs[kernel])
    rec["routed"] = {"fill": round(fill, 4), "kernel": kernel}
    rec["duel_ms"] = {k: r["ms"] for k, r in recs.items()}
    if errs:
        rec["duel_errors"] = errs
    best = min(r["ms"] for r in recs.values())
    rec["auto_loss"] = round(rec["ms"] / best - 1.0, 4)
    return rec


def family_jobs():
    """Synthetic workload-equivalents of the reference corpus anchors
    (tools/olarge_flops.txt; run2.sh:8 corpus discipline): FEM bands
    spanning in-band densities 0.05-1.0 (block fills ~0.02-0.17) and
    power-law graphs down to the hypersparse web class."""
    from ..utils.generate import banded_csr, rmat_csr

    return [
        ("banded_cant_62k_b32", lambda: banded_csr(62451, bandwidth=32)),
        (
            "fem_shipsec_60k_b60_d045",
            lambda: banded_csr(60000, bandwidth=60, seed=1, density=0.45),
        ),
        (
            "fem_consph_83k_b250_d014",
            lambda: banded_csr(83334, bandwidth=250, seed=2, density=0.14),
        ),
        (
            "fem_pwtk_100k_b100_d025",
            lambda: banded_csr(100000, bandwidth=100, seed=3, density=0.25),
        ),
        (
            "fem_mid_60k_b400_d005",
            lambda: banded_csr(60000, bandwidth=400, seed=4, density=0.05),
        ),
        ("rmat_s14", lambda: rmat_csr(14, edge_factor=8, seed=7)),
        (
            "web_hyper_s16_ef11",
            lambda: rmat_csr(
                16, edge_factor=11, a=0.65, b=0.15, c=0.15, seed=9
            ),
        ),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="corpus benchmark runner")
    p.add_argument("--dir", default=None, help="directory of .mtx/.snap files")
    p.add_argument(
        "--synthetic",
        action="store_true",
        help="add the synthetic corpus (rmat scales + banded)",
    )
    p.add_argument("--scales", default="10,12,14")
    p.add_argument("--banded", action="store_true", help="include the banded FEM-like case")
    p.add_argument(
        "--cant",
        action="store_true",
        help="include the reference-scale cant.mtx-class workload "
        "(62451 rows, ~4.06M nnz, ~266M Oflops — the anchors of "
        "tools/res.txt)",
    )
    p.add_argument(
        "--kernel",
        default="ell",
        choices=["esc", "binned", "ell", "ell-tiled", "block", "auto"],
        help="block = dense-block path (band/FEM-class matrices); "
        "auto = route per matrix by measured block fill "
        "(ops.dispatch.spgemm_auto's rule) and record the decision",
    )
    p.add_argument(
        "--check",
        action="store_true",
        help="cross-check exact nnz(C) against scipy per matrix",
    )
    p.add_argument(
        "--mt",
        action="store_true",
        help="also run the 4-thread C++ Gustavson baseline "
        "(native/src/spgemm_baseline.cc — the reference's flagship "
        "kernel class, symbolic phase included in its timing) and "
        "record vs_baseline_mt per matrix",
    )
    p.add_argument(
        "--parts",
        type=int,
        default=1,
        help=">1: row-partitioned driver (ops/partitioned.py law) — "
        "sum of per-group slope times; needed past single-dispatch "
        "device memory",
    )
    p.add_argument(
        "--families",
        action="store_true",
        help="add the reference-anchor synthetic corpus "
        "(FEM bands at fills 0.05-0.45 + power-law/web classes)",
    )
    p.add_argument(
        "--duel",
        action="store_true",
        help="run BOTH engines per matrix and record auto_loss "
        "(how much the production route loses to the better engine)",
    )
    p.add_argument("--chunk", type=int, default=None, help="plan chunk override")
    p.add_argument("--max-w", type=int, default=None, help="plan max_w override")
    p.add_argument("--out", default=None, help="append JSON lines here")
    args = p.parse_args(argv)

    jobs = []
    if args.dir:
        from ..io import load_coo

        for f in sorted(
            glob.glob(os.path.join(args.dir, "*.mtx"))
            + glob.glob(os.path.join(args.dir, "*.snap"))
        ):
            coo = load_coo(f, is_trans=False)
            jobs.append((os.path.basename(f), coo.sum_duplicates().to_csr()))
    if args.families:
        for name, build in family_jobs():
            jobs.append((name, build()))
    if args.synthetic or not jobs:
        from ..utils.generate import banded_csr, rmat_csr

        for s in [int(x) for x in args.scales.split(",") if x.strip()]:
            jobs.append((f"rmat_s{s}", rmat_csr(s, edge_factor=8, seed=7)))
        if args.banded:
            jobs.append(("banded_8k_b32", banded_csr(8192, bandwidth=32)))
        if args.cant:
            # cant.mtx workload equivalent: 62451 rows x (2*32+1) band
            # -> Annz ~4.06M, Oflops ~266M (reference anchors: Annz
            # 4,007,383 / Oflops 269,475,365, tools/res.txt)
            jobs.append(("banded_cant_62k_b32", banded_csr(62451, bandwidth=32)))

    from ..utils.timing import enable_compile_cache

    enable_compile_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    sink = open(args.out, "a") if args.out else None
    for name, a in jobs:
        if args.parts > 1:
            if args.kernel != "ell":
                p.error("--parts > 1 supports only --kernel ell")
            rec = run_partitioned(
                name, a, args.parts, check=args.check,
                chunk=args.chunk, max_w=args.max_w,
            )
        elif args.duel:
            rec = run_duel(name, a, check=args.check)
        else:
            rec = run_one(
                name, a, args.kernel, check=args.check,
                chunk=args.chunk, max_w=args.max_w,
            )
        if args.mt:
            import numpy as np

            from ..io.native import spgemm_mt_baseline
            from ..utils.nphost import csr_host

            rp, ci = csr_host(a)
            mt = spgemm_mt_baseline(rp, ci, np.asarray(a.values), a.ncols)
            if mt is not None:
                # ratio > 1 means the device kernel beats the 4-thread
                # CPU; _cold charges the device path's host planning too
                # (the CPU baseline always includes its symbolic phase)
                rec["mt_baseline_ms"] = round(mt[0], 3)
                rec["vs_baseline_mt"] = round(mt[0] / rec["ms"], 3)
                rec["vs_baseline_mt_cold"] = round(
                    mt[0] / (rec["ms"] + rec.get("plan_ms", 0.0)), 3
                )
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

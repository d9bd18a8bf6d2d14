"""Performance driver — perfTests/only-*.cc + perfTests/rmcl.cc parity.

Warm-up then timed repeats; prints per-op milliseconds and
``GFLOPS = flops / ms / 1e6`` with the reference's double-count accounting
(perfTests/only-somp.cc:36-37).  ``--kernel`` picks esc (global-sort
pipeline), binned (flops-binned tiles), or rmcl (full fused iteration).
"""

from __future__ import annotations

import os
import sys

import jax

from ..io import load_coo
from ..models.rmcl import plan_capacities, rmcl, rmcl_init
from ..ops.binned import plan_bins, spgemm_binned
from ..ops.spgemm import spgemm, spgemm_upper_bounds
from ..utils.timing import bench_fn, enable_compile_cache, time_in_mill_now
from .args import build_parser


def main(argv=None) -> int:
    p = build_parser("timed SpGEMM / R-MCL (perfTests parity)")
    p.add_argument(
        "--kernel",
        default="ell",
        choices=[
            "esc",
            "binned",
            "ell",
            "ell-tiled",
            "ell-partitioned",
            "rmcl",
            "rmcl-static",
        ],
    )
    p.add_argument("--iters", type=int, default=5)
    p.add_argument(
        "--parts",
        type=int,
        default=4,
        help="row groups for --kernel ell-partitioned (memory-bounded "
        "flat export; ops/partitioned.py)",
    )
    args = p.parse_args(argv)
    enable_compile_cache()

    coo = load_coo(args.input, is_trans=False)
    a = coo.sum_duplicates().to_csr()
    product_cap, out_cap = spgemm_upper_bounds(a, a)
    flops2 = 2.0 * product_cap

    if args.kernel in ("rmcl", "rmcl-static"):
        coo2 = load_coo(args.input, is_trans=True, extra_capacity=a.rows + 1)
        mt0 = rmcl_init(coo2)
        t0 = time_in_mill_now()
        if args.kernel == "rmcl-static":
            from ..models.rmcl_ell import rmcl_ell

            out, hist = rmcl_ell(mt0, max_iters=args.maxIters)
            nnz_final = int(hist["nnz"][-1])
        else:
            res = rmcl(mt0, max_iters=args.maxIters, mode="scan")
            nnz_final = int(res.nnz_history[-1])
        t1 = time_in_mill_now()
        per_iter = (t1 - t0) / max(args.maxIters, 1)
        print(
            f"{args.kernel}: {args.maxIters} iters, {t1 - t0:.3f} ms total, "
            f"{per_iter:.3f} ms/iter, final nnz {nnz_final}"
        )
        return 0

    da = jax.device_put(a)
    if args.kernel == "binned":
        plan = plan_bins(a, a)
        fn = lambda x: spgemm_binned(x, x, plan)
    elif args.kernel == "ell-partitioned":
        from ..ops.partitioned import spgemm_ell_partitioned

        fn = lambda x: spgemm_ell_partitioned(x, x, parts=args.parts)
    elif args.kernel in ("ell", "ell-tiled"):
        from ..ops.ell_esc import plan_ell, spgemm_ell, spgemm_ell_tiled

        eplan = plan_ell(a, a)
        if args.kernel == "ell":
            fn = lambda x: spgemm_ell(x, x, eplan)
        else:
            fn = lambda x: spgemm_ell_tiled(x, x, eplan)
    else:
        fn = lambda x: spgemm(x, x, product_cap, out_cap)
    prof_dir = os.environ.get("SMF_PROFILE_DIR")
    if prof_dir:
        # xprof trace of the timed region (the jax.profiler counterpart of
        # the reference's nvprof harness, tools/trun.sh)
        with jax.profiler.trace(prof_dir):
            ms = bench_fn(fn, da, warmup=1, iters=args.iters)
        print(f"profile trace written to {prof_dir}")
    else:
        ms = bench_fn(fn, da, warmup=1, iters=args.iters)
    print(
        f"{args.kernel} spgemm: {ms:.3f} ms, "
        f"GFLOPS = {flops2 / ms / 1e6:.3f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

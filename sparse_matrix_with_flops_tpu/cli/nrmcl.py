"""Main R-MCL CLI — the nrmcl.cc role.

Runs R-MCL twice (reference oracle path and the requested backend),
compares iterates, prints the "Same/Diffs" verdict (nrmcl.cc:16-33), and
per-iteration convergence stats when ``--stats`` (mtRmclIter's
differsStats appended to percent.stats, qrmcl.cc:17-24,65-70).

Usage: python -m sparse_matrix_with_flops_tpu.cli.nrmcl -i graph.snap -m 5
"""

from __future__ import annotations

import sys

import numpy as np

from ..io import load_coo
from ..models.rmcl import rmcl, rmcl_init
from ..utils.timing import enable_compile_cache, time_in_mill_now
from .args import build_parser, print_args


def main(argv=None) -> int:
    args = build_parser("R-MCL (nrmcl.x parity)").parse_args(argv)
    print_args(args)
    enable_compile_cache()

    from ..models.rmcl import BACKENDS

    if args.rmclOptions.upper() == "STATIC":
        # the production path: static fused loop with MCL selection cap
        from ..models.rmcl_ell import rmcl_ell

        coo = load_coo(args.input, is_trans=True, extra_capacity=2**20)
        mt0 = rmcl_init(coo)
        t0 = time_in_mill_now()
        ref = rmcl(mt0, max_iters=args.maxIters, mode="loop", backend="SEQ")
        t1 = time_in_mill_now()
        got, hist = rmcl_ell(mt0, max_iters=args.maxIters)
        t2 = time_in_mill_now()
        print(
            f"seq-loop time = {t1 - t0:.1f} ms, static time = {t2 - t1:.1f} ms"
        )
        a = ref.mt.make_ordered()._drop_explicit_zeros()
        b = got.make_ordered()._drop_explicit_zeros()
        same = bool(a.is_raw_equal(b, tol=1e-5))
        print("Same" if same else "Diffs")
        print(
            f"final nnz = {int(hist['nnz'][-1])}, iters = {args.maxIters}, "
            f"truncated rows = {int(hist['truncated_rows'].sum())}"
        )
        return 0 if same else 1

    if args.rmclOptions.upper() not in BACKENDS:
        # validate before any compile work (the reference exits on an
        # unconfigured backend too, qrmcl.cc:49-62)
        print(
            f"unknown backend {args.rmclOptions!r}; "
            f"choose from {sorted(BACKENDS)}"
        )
        return 2

    coo = load_coo(args.input, is_trans=True, extra_capacity=2**20)
    mt0 = rmcl_init(coo)

    t0 = time_in_mill_now()
    ref = rmcl(mt0, max_iters=args.maxIters, mode="loop", backend="SEQ")
    t1 = time_in_mill_now()
    got = rmcl(
        mt0,
        max_iters=args.maxIters,
        mode="scan",
        backend=args.rmclOptions,
        track_row_growth=args.stats,
    )
    t2 = time_in_mill_now()
    print(f"seq-loop time = {t1 - t0:.1f} ms, scan time = {t2 - t1:.1f} ms")

    a = ref.mt.make_ordered()._drop_explicit_zeros()
    b = got.mt.make_ordered()._drop_explicit_zeros()
    same = bool(a.is_raw_equal(b, tol=1e-5))
    print("Same" if same else "Diffs")  # nrmcl.cc:29-32 verdict

    if args.stats:
        with open("percent.stats", "a") as f:
            for it in range(got.iters):
                f.write(
                    f"iter {it} nnz {got.nnz_history[it]} "
                    f"flops {got.flops_history[it]} "
                    f"differs {got.differs_history[it]:.6f}\n"
                )
        print("per-iteration stats appended to percent.stats")
    print(
        f"final nnz = {int(np.asarray(got.nnz_history)[-1])}, "
        f"iters = {got.iters}, overflow = {got.overflow}"
    )
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

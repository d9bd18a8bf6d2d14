"""Headline benchmark: flops-aware SpGEMM C = A·A on a power-law R-MAT graph.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

The reference publishes no numbers (BASELINE.md); it computes GFLOPS at
runtime as flops/ms/1e6 with flops = 2 × Σ_i Σ_{j∈A[i,:]} nnz(B[j,:])
(perfTests/only-somp.cc:36-37).  Same accounting here, on the same
workload family (power-law graph).  ``vs_baseline`` divides by the best of
five scipy CSR SpGEMM runs on this host's CPU — the same Gustavson
algorithm family as the reference CPU kernels, on 2026 hardware.

The kernel is the ELL-ESC pipeline (ops/ell_esc.py): flops-classified row
tiles, row-gather expansion, per-row sort-compress, dense path for hub
rows, exact-size assembly.  It needs a GPU: without one it fails rather
than time another backend.

Timing discipline: the headline is the MEDIAN of five independent
``slope_bench`` measurements and the record carries their ``spread``
((max-min)/median) so a noisy capture is visible instead of silently
swinging the number.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _median_slope(step, n: int = 5):
    """Median of ``n`` independent slope_bench measurements + spread.

    The median of five rides through one bad sample; the spread field
    keeps any residual noise visible."""
    from sparse_matrix_with_flops_tpu.utils.timing import slope_bench

    ms = sorted(slope_bench(step) for _ in range(n))
    med = ms[len(ms) // 2]
    spread = (ms[-1] - ms[0]) / med if med > 0 else 0.0
    return med, spread


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU, JAX found {dev.platform}")

    from sparse_matrix_with_flops_tpu.formats.csr import CSR
    from sparse_matrix_with_flops_tpu.ops.ell_esc import (
        _tiles_impl,
        plan_ell,
        spgemm_ell,
    )
    from sparse_matrix_with_flops_tpu.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu.utils.generate import rmat_csr
    from sparse_matrix_with_flops_tpu.utils.timing import (
        enable_compile_cache,
    )

    enable_compile_cache()

    # the FEM-band anchor (cant.mtx class) runs FIRST, before the s14
    # section's device traffic can steal host CPU from its cold plan.
    # Second headline: the reference's own FEM-band anchor (cant.mtx
    # class, tools/res.txt) on the dense-block path.  The setup (plan +
    # exact-nnz bucket + fused step) is cli.corpus.prep_block_step — the
    # SAME code path the corpus runner times.  BENCH_CANT=0 skips it.
    from sparse_matrix_with_flops_tpu.io.native import spgemm_mt_baseline

    cant_fields = {}
    if os.environ.get("BENCH_CANT", "1") == "1":
        from sparse_matrix_with_flops_tpu.cli.corpus import prep_block_step
        from sparse_matrix_with_flops_tpu.ops.dispatch import route
        from sparse_matrix_with_flops_tpu.utils.generate import banded_csr
        from sparse_matrix_with_flops_tpu.utils.nphost import prefault

        ca = banded_csr(62451, bandwidth=32)
        c_oflops, _ = spgemm_upper_bounds(ca, ca)
        dca = jax.device_put(ca)
        # warm the heap before the timed plan: first-touch page faults
        # would otherwise land in the cold capture (the CPU baseline
        # process enjoys a warm heap by its timed multiply too)
        prefault(1 << 28)
        # the PRODUCTION cold path: route (fill estimate) then plan — the
        # estimate warms the block-coordinate cache the planner shares
        t0 = time.monotonic()
        routed_kernel, c_fill = route(ca, ca)
        c_route_ms = (time.monotonic() - t0) * 1e3
        cfn, c_plan_ms, _cap = prep_block_step(ca, dca)
        c_plan_ms += c_route_ms

        def cstep(x):
            a2 = CSR(dca.row_ptr, dca.col_ind, dca.values + x, dca.ncols)
            out = cfn(a2)
            return (out.row_ptr, out.col_ind, out.values)

        c_ms, c_spread = _median_slope(cstep)
        cant_fields = {
            "cant_block_ms": round(c_ms, 3),
            "cant_block_gflops": round(2.0 * c_oflops / c_ms / 1e6, 3),
            "cant_plan_ms": round(c_plan_ms, 1),
            "cant_routed": routed_kernel,
            "cant_fill": round(c_fill, 4),
            "cant_spread": round(c_spread, 3),
        }
        crp = np.asarray(ca.row_ptr)
        cnnz = int(crp[-1])
        cmt = spgemm_mt_baseline(
            crp,
            np.asarray(ca.col_ind)[:cnnz],
            np.asarray(ca.values)[:cnnz],
            ca.ncols,
        )
        if cmt:
            cant_fields["cant_vs_baseline_mt"] = round(cmt[0] / c_ms, 3)
            cant_fields["cant_vs_baseline_mt_cold"] = round(
                cmt[0] / (c_ms + c_plan_ms), 3
            )

    scale = int(os.environ.get("BENCH_SCALE", "14"))
    edge_factor = int(os.environ.get("BENCH_EDGE_FACTOR", "8"))
    a = rmat_csr(scale, edge_factor=edge_factor, seed=7, weights="random")

    oflops, _ = spgemm_upper_bounds(a, a)
    flops2 = 2.0 * oflops  # multiply+add accounting (only-somp.cc:36)

    # host planning is timed and reported: the reference's timed multiply
    # INCLUDES its symbolic/footprint/partition phases
    # (only-somp.cc:30-37, static_omp_csr_kernel.cc:98-163), so a
    # plan-excluded GFLOPS number alone would overstate the comparison.
    # ``value`` stays the amortized (plan-reused,
    # R-MCL-style) kernel rate; ``gflops_cold`` charges the plan too.
    t0 = time.monotonic()
    plan = plan_ell(a, a)
    plan_ms = (time.monotonic() - t0) * 1e3
    dev_a = jax.device_put(a)
    # warm the exact path twice (caches + validates the nnz(C) bucket),
    # then slope-time the fused single-dispatch kernel: k reps inside one
    # jitted scan with a runtime-zero perturbation + checksum carry —
    # dispatch latency and host RTT cancel in dT/dk (utils.timing).
    spgemm_ell(dev_a, dev_a, plan)
    spgemm_ell(dev_a, dev_a, plan)
    cap = getattr(plan, "_nnzc_cache")

    def step(x):
        a2 = CSR(dev_a.row_ptr, dev_a.col_ind, dev_a.values + x, dev_a.ncols)
        csr, nnzc = _tiles_impl(
            a2, dev_a, plan, plan.chunk, fused_out_cap=cap
        )
        return (csr.row_ptr, csr.col_ind, csr.values, nnzc)

    ms, spread = _median_slope(step)
    gflops = flops2 / ms / 1e6

    # host-CPU Gustavson baselines (best of 5 to dodge host contention):
    # vs_baseline — single-thread scipy;
    # vs_baseline_mt — the 4-thread OpenMP C++ Gustavson in
    # native/src/spgemm_baseline.cc, the reference's flagship kernel
    # class (static_omp_csr_kernel.cc:98-206) on this host
    import scipy.sparse as sp

    rp = np.asarray(a.row_ptr)
    nnz = int(rp[-1])
    sa = sp.csr_matrix(
        (np.asarray(a.values)[:nnz], np.asarray(a.col_ind)[:nnz], rp),
        shape=a.shape,
    )
    best = float("inf")
    for _ in range(5):
        t0 = time.monotonic()
        _ = sa @ sa
        best = min(best, (time.monotonic() - t0) * 1e3)
    vs_baseline = gflops / (flops2 / best / 1e6)
    mt = spgemm_mt_baseline(
        rp, np.asarray(a.col_ind), np.asarray(a.values), a.ncols
    )
    vs_mt = gflops / (flops2 / mt[0] / 1e6) if mt else None

    rec = {
        "metric": "spgemm_rmat_s%d_gflops" % scale,
        "value": round(gflops, 3),
        "unit": "GFLOPS",
        "vs_baseline": round(vs_baseline, 3),
        "plan_ms": round(plan_ms, 1),
        "gflops_cold": round(flops2 / (plan_ms + ms) / 1e6, 3),
        "spread": round(spread, 3),
        "platform": jax.default_backend(),
        "device": dev.device_kind,
    }
    if vs_mt is not None:
        rec["vs_baseline_mt"] = round(vs_mt, 3)
    rec.update(cant_fields)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()

"""Phase-level SpGEMM profiling on the attached device.

Times each pipeline stage separately (expand / sort / scatter-assembly /
binned variant) to find the device bottleneck.  Usage:
    python tools/profile_spgemm.py [scale] [edge_factor]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from sparse_matrix_with_flops_tpu.ops.binned import plan_bins, spgemm_binned
from sparse_matrix_with_flops_tpu.ops.spgemm import (
    esc_expand,
    esc_sort,
    spgemm,
    spgemm_upper_bounds,
)
from sparse_matrix_with_flops_tpu.utils.generate import rmat_csr
from sparse_matrix_with_flops_tpu.utils.timing import bench_fn


def main():
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    ef = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    a = rmat_csr(scale, edge_factor=ef, seed=7, weights="random")
    product_cap, out_cap = spgemm_upper_bounds(a, a)
    print(
        f"scale={scale} ef={ef} rows={a.rows} nnz={int(a.nnz)} "
        f"flops={product_cap} backend={jax.default_backend()}",
        flush=True,
    )
    da = jax.device_put(a)

    @jax.jit
    def expand_only(x):
        return esc_expand(x, x, product_cap)

    @jax.jit
    def expand_sort(x):
        prow, pcol, pval, _ = esc_expand(x, x, product_cap)
        return esc_sort(prow, pcol, pval, x.rows)

    t0 = time.monotonic()
    ms = bench_fn(expand_only, da, warmup=1, iters=3)
    print(f"expand:        {ms:9.2f} ms  (compile {time.monotonic()-t0:.0f}s)", flush=True)

    t0 = time.monotonic()
    ms2 = bench_fn(expand_sort, da, warmup=1, iters=3)
    print(f"expand+sort:   {ms2:9.2f} ms  (compile {time.monotonic()-t0:.0f}s)", flush=True)

    t0 = time.monotonic()
    ms3 = bench_fn(lambda x: spgemm(x, x, product_cap, out_cap), da, warmup=1, iters=3)
    print(f"full esc:      {ms3:9.2f} ms  (compile {time.monotonic()-t0:.0f}s)", flush=True)

    plan = plan_bins(a, a)
    widths = [(ids.shape[0], w) for ids, w in plan.bins]
    print(f"bins (R, W): {widths} huge={plan.huge_rows.size}", flush=True)
    t0 = time.monotonic()
    ms4 = bench_fn(lambda x: spgemm_binned(x, x, plan), da, warmup=1, iters=3)
    print(f"binned:        {ms4:9.2f} ms  (compile {time.monotonic()-t0:.0f}s)", flush=True)

    flops2 = 2.0 * product_cap
    for name, m in [("esc", ms3), ("binned", ms4)]:
        print(f"{name}: {flops2 / m / 1e6:.3f} GFLOPS", flush=True)


if __name__ == "__main__":
    main()

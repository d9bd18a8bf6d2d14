"""Per-stage slope profile of the fused ELL-ESC SpGEMM pipeline.

Uses the `_stage` truncation hooks in ops/ell_esc.py to slope-time
(utils.timing.slope_bench) cumulative prefixes of the pipeline:

  tiles  stage 0: B-ELL build (B perturbed so it can't hoist)
         stage 1: + per-bin tile chunk gathers + scale
         stage 2: + per-bin sort/dedup/compact
         full   : + hub dense path + counts + concat
  asm    stage 0: per-WINDOW source idx (m-scale max-scatter + cummax)
         stage 1: + windowed gathers
         full   : + row-head repair (mask plane rides the scatter)

Usage: python tools/profile_fused.py [scale] [edge_factor] [chunk] [max_w]
         [stage-substring-filter, e.g. "fused" or "tiles s2,asm"]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from sparse_matrix_with_flops_tpu.formats.csr import CSR
    from sparse_matrix_with_flops_tpu.ops.ell_esc import (
        _assemble_body,
        _tiles_impl,
        plan_ell,
        spgemm_ell,
    )
    from sparse_matrix_with_flops_tpu.ops.spgemm import spgemm_upper_bounds
    from sparse_matrix_with_flops_tpu.utils.generate import rmat_csr
    from sparse_matrix_with_flops_tpu.utils.timing import slope_bench

    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    ef = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else None
    max_w = int(sys.argv[4]) if len(sys.argv) > 4 else None
    stage_filter = sys.argv[5].split(",") if len(sys.argv) > 5 else None
    a = rmat_csr(scale, edge_factor=ef, seed=7, weights="random")
    oflops, _ = spgemm_upper_bounds(a, a)
    kw = {}
    if chunk:
        kw["chunk"] = chunk
    if max_w:
        kw["max_w"] = max_w
    plan = plan_ell(a, a, **kw)
    dev_a = jax.device_put(a)
    print(
        f"backend={jax.default_backend()} s={scale} ef={ef} chunk={plan.chunk}"
        f" flops={int(oflops)} bins={[(w, len(r)) for w, r, _, _ in plan.bins]}"
        f" huge={plan.huge_rows.size} total_chunks={plan.total_chunks}",
        flush=True,
    )
    spgemm_ell(dev_a, dev_a, plan)
    spgemm_ell(dev_a, dev_a, plan)
    cap = getattr(plan, "_nnzc_cache")
    print(f"nnzc_cap={cap}", flush=True)

    def tiles_stage(stage):
        def step(x):
            # perturb BOTH operands: B-ELL build must not hoist
            a2 = CSR(dev_a.row_ptr, dev_a.col_ind, dev_a.values + x, dev_a.ncols)
            return _tiles_impl(a2, a2, plan, plan.chunk, _stage=stage)

        return step

    # frozen tile outputs for assembly-side profiling
    fc, fv, counts, fb = jax.block_until_ready(
        _tiles_impl(dev_a, dev_a, plan, plan.chunk)
    )

    def asm_stage(stage):
        def step(x):
            # perturb counts too (runtime-zero): stage 0's idx path
            # depends only on counts/flat_base — values-only perturbation
            # lets XLA hoist the whole stage out of the scan (slope 0)
            return _assemble_body(
                fc,
                fv + x,
                counts + x.astype(counts.dtype),
                fb,
                plan.ncols,
                cap,
                _stage=stage,
            )

        return step

    def fused_step(x):
        a2 = CSR(dev_a.row_ptr, dev_a.col_ind, dev_a.values + x, dev_a.ncols)
        csr, nnzc = _tiles_impl(
            a2, dev_a, plan, plan.chunk, fused_out_cap=cap
        )
        return csr.row_ptr, csr.col_ind, csr.values, nnzc

    rows = []
    for name, step in [
        ("tiles s0 b-ell", tiles_stage(0)),
        ("tiles s1 +gather", tiles_stage(1)),
        ("tiles s2 +sort", tiles_stage(2)),
        ("tiles s3 +bdense", tiles_stage(3)),
        ("tiles s4 +matmul", tiles_stage(4)),
        ("tiles s5 +compact", tiles_stage(5)),
        ("tiles full", tiles_stage(99)),
        ("asm s0 idx", asm_stage(0)),
        ("asm s10 winsrc", asm_stage(10)),
        ("asm s1 +windows", asm_stage(1)),
        ("asm full", asm_stage(99)),
        ("fused total", fused_step),
    ]:
        if stage_filter and not any(s in name for s in stage_filter):
            continue
        try:
            ms = slope_bench(step)
            rows.append((name, ms))
            print(f"{name:18s} {ms:9.2f} ms", flush=True)
        except Exception as e:
            print(f"{name:18s} FAIL {str(e).splitlines()[0][:140]}", flush=True)


if __name__ == "__main__":
    main()

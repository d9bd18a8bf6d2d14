"""Per-stage slope profile of the fused static R-MCL step.

Stages (cumulative cutoffs; a cutoff only bills work whose outputs it
returns):
  0 = iterate segment gather
  1 = + per-bin tile dedup (sort + segmented run sums)
  2 = + prune / top-S selection / renormalise (+ scatter to the iterate)
  3 = hub path alone (union-restricted densify + matmul + select)
  99 = full step (+ drift norm)

Usage: python tools/profile_rmcl.py [scale] [ef] [S]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from sparse_matrix_with_flops_tpu.formats.coo import COO
    from sparse_matrix_with_flops_tpu.formats.csr import CSR
    from sparse_matrix_with_flops_tpu.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu.models.rmcl_ell import (
        _dense_huge,
        mt_to_ell,
        plan_rmcl_ell,
        rmcl_ell_step,
    )
    from sparse_matrix_with_flops_tpu.utils.generate import rmat_csr
    from sparse_matrix_with_flops_tpu.utils.timing import slope_bench

    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    ef = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    S = int(sys.argv[3]) if len(sys.argv) > 3 else 128

    g = rmat_csr(scale, edge_factor=ef, seed=7)
    rp = np.asarray(g.row_ptr, np.int64)
    erow = np.repeat(np.arange(g.rows), np.diff(rp))
    coo = COO.from_numpy(
        erow,
        np.asarray(g.col_ind)[: int(rp[-1])],
        np.asarray(g.values)[: int(rp[-1])],
        g.rows,
        g.rows,
        capacity=int(rp[-1]) + g.rows,
    )
    mt0 = rmcl_init(coo)
    plan = plan_rmcl_ell(mt0, S=S)
    cols, vals = mt_to_ell(mt0, S)
    a_d = _dense_huge(mt0, plan)
    dev_a = jax.device_put(mt0)
    print(
        f"backend={jax.default_backend()} s={scale} S={S} "
        f"bins={[(d, len(r)) for d, r, _ in plan.bins]} "
        f"hub={plan.huge_rows.size} hub_kh={plan.hub_kh}",
        flush=True,
    )

    for name, stage in [
        ("segments gather", 0),
        ("+ tile dedup", 1),
        ("+ prune/select", 2),
        ("hub path alone", 3),
        ("full step", 99),
    ]:
        def step(x, stage=stage):
            a2 = CSR(
                dev_a.row_ptr, dev_a.col_ind, dev_a.values + x, dev_a.ncols
            )
            out = rmcl_ell_step(plan, a2, a_d, cols, vals + x, _stage=stage)
            return jax.tree.leaves(out)

        ms = slope_bench(step)
        print(f"{name:20s} {ms:8.2f} ms", flush=True)


if __name__ == "__main__":
    main()

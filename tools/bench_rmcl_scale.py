"""Reference-scale R-MCL headline: the static-ELL
clustering loop at s16 scale with slope-timed ms/iter, exact convergence
history, purity on a planted partition, and a CPU-loop comparison.

The CPU baseline is the unfused scipy R-MCL loop of
utils.reference.rmcl_scipy (the seqRmclIter shape, qrmcl.cc:86-124).

Timing is SLOPE-based (ms/iter = (T(k2) - T(k1)) / (k2 - k1) with the
whole loop inside one jitted scan per k), which cancels dispatch and
fetch latency.

Usage: python tools/bench_rmcl_scale.py [n_clusters] [cluster_size]
         [S] [--out results.jsonl]
Defaults 1024 x 64 = 65536 nodes (s16 scale).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def cpu_rmcl_iters(sm, iters):
    """Unfused scipy R-MCL loop; returns (total_seconds, final nnz)."""
    from sparse_matrix_with_flops_tpu.utils.reference import rmcl_scipy

    t0 = time.monotonic()
    m = rmcl_scipy(sm, iters)
    return time.monotonic() - t0, int(m.nnz)


def main():
    import jax

    from sparse_matrix_with_flops_tpu.models.clusters import extract_clusters
    from sparse_matrix_with_flops_tpu.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu.models.rmcl_ell import (
        _dense_huge,
        mt_to_ell,
        plan_rmcl_ell,
        rmcl_ell_scan,
    )
    from sparse_matrix_with_flops_tpu.utils.generate import (
        cluster_purity,
        planted_partition_coo,
    )
    from sparse_matrix_with_flops_tpu.utils.timing import (
        enable_compile_cache,
    )

    enable_compile_cache()
    argv = sys.argv[1:]
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
    kc = int(argv[0]) if len(argv) > 0 else 1024
    cs = int(argv[1]) if len(argv) > 1 else 64
    S = int(argv[2]) if len(argv) > 2 else 128
    n = kc * cs
    print(f"backend={jax.default_backend()} n={n} ({kc}x{cs}) S={S}",
          flush=True)

    # p_out scales as ~8/n: the generator's 0.002 default adds ~131
    # inter-cluster edges per node at n=65536 (mean degree 151 -> 63k
    # dense-path rows -> 16 GB operand); ~24 total degree matches the
    # power-law corpus scale
    coo, planted = planted_partition_coo(
        kc, cs, p_in=0.3, p_out=8.0 / (kc * cs), seed=11
    )
    mt0 = rmcl_init(coo)
    # materialize the init BEFORE timing the plan: rmcl_init is lazy and
    # its first host fetch (compile + run) otherwise lands inside plan_ms
    np.asarray(mt0.row_ptr), np.asarray(mt0.col_ind), np.asarray(mt0.values)
    t0 = time.monotonic()
    plan = plan_rmcl_ell(mt0, S=S)
    plan_s = time.monotonic() - t0
    print(f"plan {plan_s:.1f}s huge={plan.huge_rows.size}", flush=True)
    cols, vals = mt_to_ell(mt0, S)
    a_d = _dense_huge(mt0, plan)

    def run(iters):
        c1, v1, hist = rmcl_ell_scan(plan, mt0, a_d, cols, vals, iters)
        # fetching the stats forces the whole scan
        d = np.asarray(hist["differs"])
        return c1, v1, hist, float(d[-1])

    ks = (2, 6)
    walls = {}
    for k in ks:
        run(k)  # compile + warm
        ts = []
        for _ in range(3):
            t0 = time.monotonic()
            run(k)
            ts.append(time.monotonic() - t0)
        ts.sort()
        walls[k] = ts[len(ts) // 2]
    ms_iter = (walls[ks[1]] - walls[ks[0]]) / (ks[1] - ks[0]) * 1e3

    # convergence + clustering quality from a longer run (12 iters left
    # ~65k near-singleton clusters at n=65536 — attractors need the
    # iterate to actually converge before extraction means anything)
    c1, v1, hist, _ = run(30)
    nnz_hist = [int(x) for x in np.asarray(hist["nnz"])]
    differs = [round(float(x), 5) for x in np.asarray(hist["differs"])]
    from sparse_matrix_with_flops_tpu.models.rmcl_ell import ell_to_csr

    mt_fin = ell_to_csr(np.asarray(c1), np.asarray(v1), mt0.ncols)
    # the converged fixed point spreads each row's mass over ~12
    # same-cluster attractor columns (~0.08 each) — a 0.2 floor sees
    # only singletons; 0.05 links within-cluster attractors
    labels = extract_clusters(mt_fin, weight_floor=0.05)
    purity = cluster_purity(np.asarray(labels), planted)

    # CPU loop baseline on the same init
    import scipy.sparse as sp

    rp = np.asarray(mt0.row_ptr)
    nnz0 = int(rp[-1])
    sm = sp.csr_matrix(
        (
            np.asarray(mt0.values)[:nnz0],
            np.asarray(mt0.col_ind)[:nnz0],
            rp,
        ),
        shape=mt0.shape,
    )
    cpu_s2, _ = cpu_rmcl_iters(sm, 2)
    cpu_s6, cpu_nnz = cpu_rmcl_iters(sm, 6)
    cpu_ms_iter = (cpu_s6 - cpu_s2) / 4 * 1e3

    rec = {
        "metric": "rmcl_planted_%dx%d" % (kc, cs),
        "kernel": "rmcl-static-ell",
        "rows": n,
        "annz": nnz0,
        "S": S,
        "ms_per_iter": round(ms_iter, 2),
        "plan_ms": round(plan_s * 1e3, 1),
        "nnz_hist": nnz_hist,
        "differs": differs,
        "clusters_found": int(np.unique(np.asarray(labels)).size),
        "purity": round(float(purity), 4),
        "cpu_ms_per_iter": round(cpu_ms_iter, 2),
        "vs_cpu_loop": round(cpu_ms_iter / ms_iter, 3),
        "cpu_nnz_final": cpu_nnz,
        "platform": jax.default_backend(),
        "timing": "slope-over-iters",
    }
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()

"""Clustering-QUALITY artifact: R-MCL on a planted-partition graph.

The reference's nrmcl.cc verdict (nrmcl.cc:16-33) only checks two
backends produce the SAME matrix; nothing measures whether the clusters
are GOOD.  This tool runs the stream (ESC) loop and the static-ELL scan
on a stochastic-block-model graph with known communities, extracts
clusters (models/clusters.py), and records count/purity vs the planted
truth plus cross-path label agreement as one JSON line each
(VERDICT r2 #9).

Usage: python tools/cluster_quality.py [n_clusters] [cluster_size] [iters]
       [--out results.jsonl]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from sparse_matrix_with_flops_tpu.models.clusters import (
        cluster_sizes,
        extract_clusters,
    )
    from sparse_matrix_with_flops_tpu.models.rmcl import rmcl, rmcl_init
    from sparse_matrix_with_flops_tpu.models.rmcl_ell import rmcl_ell
    from sparse_matrix_with_flops_tpu.utils.generate import (
        cluster_purity,
        planted_partition_coo,
    )

    argv = sys.argv[1:]
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
    args = argv
    kc = int(args[0]) if len(args) > 0 else 64
    cs = int(args[1]) if len(args) > 1 else 64
    iters = int(args[2]) if len(args) > 2 else 8

    floor = 0.2  # link only >=20%-mass attractor edges (near-delta rows)
    coo, planted = planted_partition_coo(kc, cs, p_in=0.3, p_out=0.0005, seed=1)
    mt0 = rmcl_init(coo)
    n = mt0.rows
    print(
        f"backend={jax.default_backend()} n={n} planted={kc} x {cs} "
        f"nnz={int(mt0.nnz)}",
        flush=True,
    )

    rows = []
    t0 = time.monotonic()
    res = rmcl(mt0, max_iters=iters, mode="loop")
    lab_stream = extract_clusters(res.mt, weight_floor=floor)
    rows.append(
        {
            "bench": "cluster_quality",
            "path": "stream-esc",
            "n": n,
            "planted_clusters": kc,
            "iters": iters,
            "found_clusters": len(cluster_sizes(lab_stream)),
            "purity": round(cluster_purity(lab_stream, planted), 4),
            "seconds": round(time.monotonic() - t0, 1),
        }
    )

    t0 = time.monotonic()
    out_ell, _ = rmcl_ell(mt0, max_iters=iters)
    lab_ell = extract_clusters(out_ell, weight_floor=floor)
    agree = float(np.mean(lab_stream == lab_ell))
    rows.append(
        {
            "bench": "cluster_quality",
            "path": "static-ell",
            "n": n,
            "planted_clusters": kc,
            "iters": iters,
            "found_clusters": len(cluster_sizes(lab_ell)),
            "purity": round(cluster_purity(lab_ell, planted), 4),
            "label_agreement_vs_stream": round(agree, 4),
            "seconds": round(time.monotonic() - t0, 1),
        }
    )

    sink = open(out, "a") if out else None
    for rec in rows:
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
    if sink:
        sink.close()


if __name__ == "__main__":
    main()

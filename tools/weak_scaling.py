"""Weak-scaling harness: sharded SpGEMM / R-MCL across mesh sizes.

BASELINE.md asks for SpGEMM nnz/s weak-scaling from 1 device to N.  With
``JAX_PLATFORMS=cpu`` this harness runs on N virtual CPU devices (the
collective paths are identical; absolute times are CPU-bound); on a
multi-GPU host it runs on the GPUs unchanged.  Problem size grows with N
(weak scaling): per-shard work is held constant.

Usage: JAX_PLATFORMS=cpu python tools/weak_scaling.py [devices...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

max_dev = 8
os.environ.setdefault(
    "XLA_FLAGS", f"--xla_force_host_platform_device_count={max_dev}"
)

import jax

import numpy as np

from sparse_matrix_with_flops_tpu.models.rmcl import rmcl_init
from sparse_matrix_with_flops_tpu.parallel import make_mesh
from sparse_matrix_with_flops_tpu.parallel.rmcl_ell import sharded_rmcl_ell
from sparse_matrix_with_flops_tpu.utils.generate import rmat_csr
from sparse_matrix_with_flops_tpu.formats.coo import COO


def prep(scale):
    g = rmat_csr(scale, edge_factor=8, seed=7)
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
    return rmcl_init(coo)


def main():
    import json

    devs = [int(x) for x in sys.argv[1:]] or [1, 2, 4, 8]
    base_scale = int(os.environ.get("WS_BASE_SCALE", "10"))
    exchange = os.environ.get("WS_EXCHANGE", "ring")
    out_path = os.environ.get("WS_OUT", "benchmarks/results_r2.jsonl")
    platform = jax.default_backend()
    results = []
    rows_out = []
    for nd in devs:
        scale = base_scale + int(np.log2(nd))  # weak scaling: work ~ N
        mt0 = prep(scale)
        mesh = make_mesh(nd)
        t0 = time.monotonic()
        out, hist = sharded_rmcl_ell(
            mt0, mesh, max_iters=2, S=64, exchange=exchange
        )
        compile_s = time.monotonic() - t0
        t0 = time.monotonic()
        out, hist = sharded_rmcl_ell(
            mt0, mesh, max_iters=2, S=64, exchange=exchange
        )
        run_ms = (time.monotonic() - t0) * 1e3 / 2
        nnz = int(hist["nnz"][-1])
        results.append((nd, scale, run_ms))
        rows_out.append(
            {
                "bench": "weak_scaling_rmcl_ell",
                "exchange": exchange,
                "platform": platform,
                "devices": nd,
                "scale": scale,
                "rows": mt0.rows,
                "ms_per_iter": round(run_ms, 2),
                "nnz_per_s": round(nnz / (run_ms / 1e3), 1),
                "nnz": nnz,
                "caveat": (
                    "virtual CPU mesh: validates the collective program "
                    "and scaling SHAPE, not absolute device time"
                    + (
                        f"; {nd} virtual devices OVERSUBSCRIBE the host's "
                        f"{os.cpu_count()} cores — efficiency above that "
                        "point measures host contention, not the program"
                        if nd > (os.cpu_count() or 1)
                        else ""
                    )
                )
                if platform == "cpu"
                else "",
            }
        )
        print(
            f"devices={nd} scale={scale} rows={mt0.rows} "
            f"{run_ms:.1f} ms/iter (compile {compile_s:.0f}s) nnz={nnz}",
            flush=True,
        )
    base = results[0][2]
    for (nd, scale, ms), row in zip(results, rows_out):
        # weak scaling: constant per-device work -> efficiency = t1/tN
        eff = base / ms * 100.0
        row["weak_scaling_efficiency_pct"] = round(eff, 1)
        print(f"weak-scaling efficiency @ {nd} devices: {eff:.0f}%", flush=True)
    with open(out_path, "a") as f:
        for row in rows_out:
            f.write(json.dumps(row) + "\n")
    print(f"wrote {len(rows_out)} rows to {out_path}", flush=True)


if __name__ == "__main__":
    main()

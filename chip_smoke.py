"""On-device smoke test: the main paths at full size, checked against plain
host references.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --multi   # four GPUs: the distributed layer only

One GPU runs four phases in one process:

1. power-law SpGEMM: ``spgemm_auto`` on R-MAT scale 16, edge factor 8,
   which routes to the ELL pipeline with dense hub groups;
2. FEM-band SpGEMM: ``spgemm_auto`` on the cant-class band (62451 rows,
   bandwidth 32), which routes to the block engine;
3. R-MCL: ``rmcl_ell`` on a 1024 x 64 planted partition (65536 nodes);
4. kernel checks: each hand-written kernel against its plain reference
   at the shapes phase 1 used.

``--multi`` runs the sharded R-MCL ring exchange and the ring SpGEMM on a
4-device mesh, each against the single-device result.

Every phase prints its seconds, the memory analysis of its main compiled
step and its check; the last line is one JSON object.  The script exits
non-zero and prints no result line when JAX finds no GPU or any phase
fails.  Data comes from fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial

import numpy as np


def require_gpu(count: int = 1):
    """The devices, or SystemExit when JAX finds fewer than ``count``
    GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPU(s); JAX found "
            f"{len(devs)} {devs[0].platform} device(s)"
        )
    return devs


def card_line() -> str:
    """Name and power limit of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    return (
        f"args={m.argument_size_in_bytes} out={m.output_size_in_bytes} "
        f"temp={m.temp_size_in_bytes} code={m.generated_code_size_in_bytes}"
    )


def _timed(fn, reps: int = 3) -> float:
    """Median seconds of ``fn()`` through block_until_ready."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.monotonic()
        jax.block_until_ready(fn())
        ts.append(time.monotonic() - t0)
    return sorted(ts)[len(ts) // 2]


def release() -> str:
    """Drop compiled programs and dead arrays between phases; returns the
    memory picture of device 0 (allocator and nvidia-smi) after it."""
    import gc

    import jax

    gc.collect()
    jax.clear_caches()
    gc.collect()
    st = jax.devices()[0].memory_stats() or {}
    used = subprocess.run(
        [
            "nvidia-smi",
            "--id=0",
            "--query-gpu=memory.used,memory.total",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    return (
        f"in_use={st.get('bytes_in_use')} peak={st.get('peak_bytes_in_use')}"
        f" limit={st.get('bytes_limit')} nvidia-smi used/total={used}"
    )


def _report(name: str, rec: dict) -> dict:
    print(
        f"phase {name}: "
        + " ".join(f"{k}={v}" for k, v in rec.items()),
        flush=True,
    )
    return rec


def _check_product(a, c) -> dict:
    """C = A·A against scipy in float64.  nnz(C) must fall in [value nnz,
    structural nnz] (cli/corpus.py's range).  Values must agree within
    REL_TOL of sum|a_ik a_kj| plus ABS_TOL: float32 sums of signed terms
    are accurate only relative to the terms' magnitudes, and scatter-adds
    on the GPU are atomics whose summation order changes run to run."""
    from sparse_matrix_with_flops_tpu.config import ABS_TOL, REL_TOL
    from sparse_matrix_with_flops_tpu.utils.reference import (
        compare_csr,
        spgemm_nnz_range,
        to_scipy,
    )

    sa = to_scipy(a)
    want = (sa @ sa).tocsr()
    scale = (abs(sa) @ abs(sa)).tocsr()
    vn, sn = spgemm_nnz_range(sa, sa)
    got = to_scipy(c)
    cmp = compare_csr(got, want, REL_TOL, ABS_TOL, scale=scale)
    nnzc = int(np.asarray(c.row_ptr)[-1])
    cmp["bad_rows"] = cmp["bad_rows"].size
    cmp["nnz_range"] = [vn, sn]
    cmp["ok"] = cmp["ok"] and vn <= nnzc <= sn
    return cmp


def phase_spgemm(name: str, a, expect_route: str) -> dict:
    """``spgemm_auto(A, A)`` checked against scipy; the main step (ELL
    tiles or block product) is compiled once more for its memory
    analysis and timed."""
    import jax

    from sparse_matrix_with_flops_tpu.ops.block_spgemm import (
        block_spgemm_tiled,
        plan_block,
    )
    from sparse_matrix_with_flops_tpu.ops.dispatch import route, spgemm_auto
    from sparse_matrix_with_flops_tpu.ops.ell_esc import _tiles_impl, plan_ell

    kernel, fill = route(a, a)
    da = jax.device_put(a)
    t0 = time.monotonic()
    c = jax.block_until_ready(spgemm_auto(da, da))
    auto_s = time.monotonic() - t0
    t0 = time.monotonic()
    extra = {}
    if kernel == "ell":
        plan = plan_ell(a, a)
        extra["hub_groups"] = len(plan.hub_groups)
        extra["hub_rows"] = int(plan.huge_rows.size)
        extra["hub_shapes"] = hub_compaction_shapes(plan)
        lowered = _tiles_impl.lower(da, da, plan, plan.chunk)
        args = (da, da)
    else:
        plan = plan_block(a, a)
        lowered = jax.jit(lambda x: block_spgemm_tiled(x, x, plan)).lower(da)
        args = (da,)
    plan_s = time.monotonic() - t0
    t0 = time.monotonic()
    compiled = lowered.compile()
    compile_s = time.monotonic() - t0
    run_s = _timed(lambda: compiled(*args))
    cmp = _check_product(a, c)
    ok = cmp["ok"] and kernel == expect_route
    if expect_route == "ell":
        ok = ok and extra["hub_groups"] > 0
    return _report(
        name,
        {
            "route": kernel,
            "fill": round(fill, 4),
            "auto_s": round(auto_s, 3),
            "plan_trace_s": round(plan_s, 3),
            "compile_s": round(compile_s, 3),
            "run_s": round(run_s, 4),
            "memory": _mem(compiled),
            **extra,
            "check": cmp,
            "ok": ok,
        },
    )


def hub_compaction_shapes(plan) -> list:
    """(rows, width, ncols) of every hub compaction call a plan makes."""
    from sparse_matrix_with_flops_tpu.ops.ell_esc import hub_row_chunks

    return sorted(
        {
            (hc, g.slab, min(g.slab, plan.ncols - sl * g.slab))
            for g in plan.hub_groups
            for _, hc in hub_row_chunks(int(g.rows.size))
            for sl in range(g.n_slabs)
        }
    )


def _planted(n_clusters: int, cluster_size: int):
    """rmcl_init of the planted-partition graph (p_out ~ 8 / n keeps the
    mean degree near 27 at any size)."""
    from sparse_matrix_with_flops_tpu.models.rmcl import rmcl_init
    from sparse_matrix_with_flops_tpu.utils.generate import (
        planted_partition_coo,
    )

    n = n_clusters * cluster_size
    coo, _ = planted_partition_coo(
        n_clusters, cluster_size, p_in=0.3, p_out=8.0 / n, seed=11
    )
    return rmcl_init(coo)


def phase_rmcl(n_clusters: int, cluster_size: int, iters: int, S: int):
    """``rmcl_ell`` on a planted partition, checked step by step against
    the unfused float64 scipy loop.  S must leave every row untruncated,
    since the reference has no selection cap.

    Each device step (``rmcl_ell_step``) starts from the reference's own
    iterate and must match the reference's next iterate within REL_TOL
    of each value plus ABS_TOL (float32 products, sums in another
    order).  Pruning is a threshold, so float32 rounding may flip an
    entry within rounding distance of its row's threshold, and
    renormalising then moves the rest of that row: a row may differ only
    if the reference saw an entry within 1e-4 of its threshold, and such
    rows must stay under 1% of all rows.  Flips propagate through later
    products, so the end-to-end iterate of ``rmcl_ell`` must match the
    reference on all but 1% of rows, with nnz within 1e-4."""
    from sparse_matrix_with_flops_tpu.config import ABS_TOL, REL_TOL
    from sparse_matrix_with_flops_tpu.formats.csr import CSR
    from sparse_matrix_with_flops_tpu.models.rmcl_ell import (
        _dense_huge,
        ell_to_csr,
        mt_to_ell,
        plan_rmcl_ell,
        rmcl_ell,
        rmcl_ell_scan,
        rmcl_ell_step,
    )
    from sparse_matrix_with_flops_tpu.utils.reference import (
        compare_csr,
        rmcl_scipy_step,
        to_scipy,
    )

    n = n_clusters * cluster_size
    mt0 = _planted(n_clusters, cluster_size)
    t0 = time.monotonic()
    got, hist = rmcl_ell(mt0, max_iters=iters, S=S)
    call_s = time.monotonic() - t0
    mo = mt0.make_ordered()
    plan = plan_rmcl_ell(mo, S=S)
    cols, vals = mt_to_ell(mo, S)
    a_d = _dense_huge(mo, plan)
    t0 = time.monotonic()
    compiled = rmcl_ell_scan.lower(plan, mo, a_d, cols, vals, iters).compile()
    compile_s = time.monotonic() - t0
    run_s = _timed(lambda: compiled(mo, a_d, cols, vals))
    truncated = int(np.asarray(hist["truncated_rows"]).sum())

    mg = to_scipy(mo)
    ref, steps, ok = mg, [], truncated == 0
    for _ in range(iters):
        nxt, near = rmcl_scipy_step(mg, ref)
        c_in, v_in = mt_to_ell(
            CSR.from_arrays(
                ref.indptr.astype(np.int32),
                ref.indices.astype(np.int32),
                ref.data.astype(np.float32),
                n,
            ),
            S,
        )
        dc, dv, _ = rmcl_ell_step(plan, mo, a_d, c_in, v_in)
        cmp = compare_csr(to_scipy(ell_to_csr(dc, dv, n)), nxt, REL_TOL,
                          ABS_TOL)
        bad = cmp.pop("bad_rows")
        cmp["bad_rows"] = bad.size
        cmp["near_threshold_rows"] = int(near.sum())
        cmp["ok"] = bool(near[bad].all() and near.sum() <= n // 100)
        ok = ok and cmp["ok"]
        steps.append(cmp)
        ref = nxt
    end = compare_csr(to_scipy(got), ref, REL_TOL, ABS_TOL)
    end["bad_rows"] = end["bad_rows"].size
    end["ok"] = bool(
        end["bad_rows"] <= n // 100
        and abs(end["nnz_got"] - end["nnz_want"]) <= 1e-4 * end["nnz_want"]
    )
    return _report(
        "rmcl",
        {
            "nodes": n,
            "S": S,
            "iters": iters,
            "hub_rows": int(plan.huge_rows.size),
            "call_s": round(call_s, 3),
            "compile_s": round(compile_s, 3),
            "run_s": round(run_s, 4),
            "memory": _mem(compiled),
            "truncated_rows": truncated,
            "nnz_hist": [int(x) for x in np.asarray(hist["nnz"])],
            "steps": steps,
            "end_to_end": end,
            "ok": ok and end["ok"],
        },
    )


def phase_kernels(shapes, seed: int = 0, interpret: bool = False) -> dict:
    """The hub compaction kernel against its XLA reference at every
    (rows, width, ncols) phase 1 used; exact equality (no arithmetic).
    ``interpret`` is for CPU tests only."""
    import jax.numpy as jnp

    from sparse_matrix_with_flops_tpu.ops.compact import (
        compact_nonzero_rows,
        compact_nonzero_rows_xla,
    )

    rng = np.random.default_rng(seed)
    results, ok = [], True
    for rows, width, ncols in shapes:
        v = np.where(
            rng.random((rows, width)) < 0.3,
            rng.standard_normal((rows, width)),
            0.0,
        ).astype(np.float32)
        v[0] = 0.0  # an all-zero row
        if rows > 1:
            v[1] = 1.0  # a full row
        dv = jnp.asarray(v)
        kernel = partial(compact_nonzero_rows, interpret=interpret)
        kc, kv = kernel(dv, ncols)
        rc, rv = compact_nonzero_rows_xla(dv, ncols)
        same = bool(
            np.array_equal(np.asarray(kc), np.asarray(rc))
            and np.array_equal(np.asarray(kv), np.asarray(rv))
        )
        ok &= same
        results.append(
            {
                "shape": [rows, width, ncols],
                "equal": same,
                "kernel_s": _timed(lambda: kernel(dv, ncols), 5),
                "xla_s": _timed(lambda: compact_nonzero_rows_xla(dv, ncols), 5),
            }
        )
    return _report("kernels", {"compact_nonzero_rows": results, "ok": ok})


def phase_multi(n_devices: int, scale: int, n_clusters: int,
                cluster_size: int, iters: int, S: int) -> dict:
    """Sharded R-MCL (ring exchange) and ring SpGEMM on an
    ``n_devices`` mesh, each against the single-device result; both
    results must come from ``n_devices`` distinct devices."""
    import jax

    from sparse_matrix_with_flops_tpu.config import ABS_TOL, REL_TOL
    from sparse_matrix_with_flops_tpu.models.rmcl_ell import rmcl_ell
    from sparse_matrix_with_flops_tpu.ops.dispatch import spgemm_auto
    from sparse_matrix_with_flops_tpu.parallel import (
        make_mesh,
        shard_csr,
        sharded_spgemm_ring,
        unshard_csr,
    )
    from sparse_matrix_with_flops_tpu.parallel.rmcl_ell import (
        sharded_rmcl_ell,
    )
    from sparse_matrix_with_flops_tpu.utils.generate import rmat_csr
    from sparse_matrix_with_flops_tpu.utils.reference import (
        compare_csr,
        to_scipy,
    )

    mesh = make_mesh(n_devices)
    mt0 = _planted(n_clusters, cluster_size)
    one, _ = rmcl_ell(mt0, max_iters=iters, S=S)
    t0 = time.monotonic()
    many, hist = sharded_rmcl_ell(
        mt0, mesh, max_iters=iters, S=S, exchange="ring"
    )
    rmcl_s = time.monotonic() - t0
    rmcl_cmp = compare_csr(to_scipy(many), to_scipy(one), REL_TOL, ABS_TOL)
    rmcl_cmp["bad_rows"] = rmcl_cmp["bad_rows"].size

    a = rmat_csr(scale, edge_factor=8, seed=7, weights="random")
    da = jax.device_put(a)
    single = spgemm_auto(da, da)
    sa = shard_csr(a, n_devices)
    rp = np.asarray(sa.row_ptr).astype(np.int64)
    ci = np.asarray(sa.col_ind)
    blen = np.diff(np.asarray(a.row_ptr).astype(np.int64))
    flops_sh = max(
        int(blen[np.clip(ci[s, : rp[s, -1]], 0, a.rows - 1)].sum())
        for s in range(n_devices)
    )
    t0 = time.monotonic()
    c, stats = sharded_spgemm_ring(mesh, sa, sa, out_cap=max(flops_sh, 1))
    jax.block_until_ready(c.values)
    ring_s = time.monotonic() - t0
    devices = {sh.device for sh in c.values.addressable_shards}
    s_a = to_scipy(a)
    ring_cmp = compare_csr(
        to_scipy(unshard_csr(c)),
        to_scipy(single),
        REL_TOL,
        ABS_TOL,
        scale=(abs(s_a) @ abs(s_a)).tocsr(),
    )
    ring_cmp["bad_rows"] = ring_cmp["bad_rows"].size
    ok = (
        rmcl_cmp["ok"]
        and ring_cmp["ok"]
        and len(devices) == n_devices
        and len(set(mesh.devices.flat)) == n_devices
    )
    return _report(
        "multi",
        {
            "devices": n_devices,
            "distinct_result_devices": len(devices),
            "rmcl_ring_s": round(rmcl_s, 3),
            "rmcl_truncated_rows": int(
                np.asarray(hist["truncated_rows"]).sum()
            ),
            "rmcl_vs_single": rmcl_cmp,
            "spgemm_ring_s": round(ring_s, 3),
            "spgemm_ring_vs_single": ring_cmp,
            "ok": ok,
        },
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--multi",
        action="store_true",
        help="run only the 4-GPU distributed phase",
    )
    args = p.parse_args(argv)
    count = 4 if args.multi else 1
    devs = require_gpu(count)
    print(f"card: {card_line()}", flush=True)

    from sparse_matrix_with_flops_tpu.utils.generate import (
        banded_csr,
        rmat_csr,
    )
    from sparse_matrix_with_flops_tpu.utils.timing import enable_compile_cache

    enable_compile_cache()
    print(f"memory at start: {release()}", flush=True)
    if args.multi:
        recs = [phase_multi(4, 16, 1024, 64, 3, 128)]
    else:
        phases = [
            lambda: phase_spgemm(
                "spgemm_powerlaw",
                rmat_csr(16, edge_factor=8, seed=7, weights="random"),
                "ell",
            ),
            lambda: phase_spgemm(
                "spgemm_band", banded_csr(62451, bandwidth=32), "block"
            ),
            lambda: phase_rmcl(1024, 64, 3, 128),
            lambda: phase_kernels(recs[0].get("hub_shapes", [])),
        ]
        recs = []
        for phase in phases:
            recs.append(phase())
            print(f"memory after release: {release()}", flush=True)
    if not all(r["ok"] for r in recs):
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    dev = devs[0]
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(devs),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

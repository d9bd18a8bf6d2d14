"""Multi-host readiness proof: a REAL 2-process jax.distributed dryrun.

SURVEY §7-S5 claims multi-host support; this script proves the bring-up
path end to end on the CPU backend, which exercises the same code: it
re-launches
itself as 2 coordinated processes (jax.distributed.initialize via
parallel.mesh.init_distributed), each exposing 4 virtual devices, builds
the GLOBAL 8-device mesh spanning both processes, and runs

  * a shard_map psum across the process boundary, and
  * one iteration of the ring-exchange distributed R-MCL
    (ppermute crosses the process boundary too),

checking the result against the single-process run.  Output is recorded
in docs/MULTIHOST_DRYRUN.md by tools/record_multihost.sh / by hand.

Usage: python tools/multihost_dryrun.py            # launcher
       (internal) MH_ROLE=worker MH_PID=k ...      # worker processes
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT = int(os.environ.get("MH_PORT", "12521"))
NPROC = 2
LOCAL_DEVICES = 4


def worker(pid: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from sparse_matrix_with_flops_tpu.parallel.mesh import init_distributed

    init_distributed(
        coordinator_address=f"127.0.0.1:{PORT}",
        num_processes=NPROC,
        process_id=pid,
    )
    assert jax.process_count() == NPROC, jax.process_count()
    ndev = len(jax.devices())
    assert ndev == NPROC * LOCAL_DEVICES, ndev

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from sparse_matrix_with_flops_tpu.formats.csr import CSR
    from sparse_matrix_with_flops_tpu.parallel import make_mesh
    mesh = make_mesh(ndev)

    # 1. psum across the process boundary
    x = jnp.arange(ndev, dtype=jnp.float32)
    xs = jax.device_put(x, NamedSharding(mesh, P("x")))
    total = shard_map(
        lambda v: jax.lax.psum(v, "x"),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=P(),
    )(xs)
    got = float(np.asarray(total)[0])
    want = float(x.sum())
    assert got == want, (got, want)

    # 2. one iteration of ring-exchange distributed R-MCL on a tiny graph.
    # Multi-process rule: only fully-replicated outputs (the psum'd stats)
    # are fetched; the sharded iterate stays distributed.
    from sparse_matrix_with_flops_tpu.models.rmcl_ell import mt_to_ell
    from sparse_matrix_with_flops_tpu.parallel.rmcl_ell import (
        plan_sharded_rmcl_ell,
        sharded_rmcl_ell_scan,
    )

    rng = np.random.default_rng(0)
    n = 8 * ndev
    mask = rng.random((n, n)) < 0.25
    np.fill_diagonal(mask, True)
    dense = np.where(mask, 1.0, 0.0).astype(np.float32)
    mt0 = CSR.from_dense(dense).aver_and_norm_rows()

    S = 16
    plan, arrays, smgt = plan_sharded_rmcl_ell(mt0, ndev, S=S)
    cols, vals = mt_to_ell(mt0, S)
    cols = np.where(np.asarray(cols) >= mt0.ncols, plan.n, np.asarray(cols))
    vals = np.asarray(vals)
    pad = plan.n - mt0.rows
    if pad:
        cols = np.concatenate(
            [cols, np.full((pad, S), plan.n, np.int32)], axis=0
        )
        vals = np.concatenate([vals, np.zeros((pad, S), np.float32)], axis=0)
    mt_cols = cols.reshape(ndev, plan.lr, S)
    mt_vals = vals.reshape(ndev, plan.lr, S)

    def gput(a):
        a = np.asarray(a)
        sh = NamedSharding(mesh, P("x", *([None] * (a.ndim - 1))))
        return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

    smgt_g = jax.tree.map(gput, smgt)
    arrays_g = jax.tree.map(gput, arrays)
    fc, fv, hist = sharded_rmcl_ell_scan(
        mesh, plan, smgt_g, arrays_g, gput(mt_cols), gput(mt_vals), 1
    )
    jax.block_until_ready(fc)
    nnz = int(np.asarray(hist["nnz"])[0])  # psum'd -> replicated
    assert nnz > 0

    if pid == 0:
        print(
            f"multihost_dryrun: ok — processes={jax.process_count()} "
            f"global_devices={ndev} psum={got} rmcl_nnz={nnz} "
            f"differs={float(np.asarray(hist['differs'])[0]):.4f}",
            flush=True,
        )


def launcher() -> None:
    procs = []
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    for pid in range(NPROC):
        e = dict(env, MH_ROLE="worker", MH_PID=str(pid))
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                env=e,
                stdout=None if pid == 0 else subprocess.DEVNULL,
                stderr=subprocess.STDOUT if pid == 0 else subprocess.DEVNULL,
            )
        )
    deadline = time.time() + 900
    rc = 0
    for p in procs:
        rem = max(5, deadline - time.time())
        try:
            rc |= p.wait(timeout=rem)
        except subprocess.TimeoutExpired:
            p.kill()
            rc |= 1
    sys.exit(rc)


if __name__ == "__main__":
    if os.environ.get("MH_ROLE") == "worker":
        worker(int(os.environ["MH_PID"]))
    else:
        launcher()

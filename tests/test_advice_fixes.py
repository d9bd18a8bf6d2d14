"""Regression tests for the round-1 advisor findings (ADVICE.md).

Each test pins the fixed behavior: uneven-shard balanced permutation keeps
shard buckets intact, resumable R-MCL surfaces capacity overflow, the
fused ELL-ESC path re-validates its nnz(C) bucket one call behind, and
init_distributed stays a no-op without a cluster environment.
"""

import warnings

import numpy as np
import pytest

from sparse_matrix_with_flops_tpu.formats.csr import CSR
from sparse_matrix_with_flops_tpu.io import load_coo
from sparse_matrix_with_flops_tpu.models.checkpoint import rmcl_resumable
from sparse_matrix_with_flops_tpu.models.rmcl import rmcl_init
from sparse_matrix_with_flops_tpu.ops.ell_esc import plan_ell, spgemm_ell
from sparse_matrix_with_flops_tpu.ops.spgemm import spgemm_dense_oracle
from sparse_matrix_with_flops_tpu.parallel.mesh import init_distributed
from sparse_matrix_with_flops_tpu.parallel.sharded import (
    flops_balanced_permutation,
)

from conftest import random_csr_np


@pytest.mark.parametrize("rows,shards", [(13, 4), (7, 8), (64, 8), (65, 8)])
def test_balanced_permutation_uneven_keeps_shard_buckets(rows, shards):
    """rows % shards != 0: the dealt buckets must coincide with the
    contiguous lr-row blocks shard_csr will cut (ADVICE.md item 3)."""
    rng = np.random.default_rng(2)
    flops = rng.integers(1, 1000, size=rows).astype(np.int64)
    perm = flops_balanced_permutation(flops, shards)
    assert sorted(perm.tolist()) == list(range(rows))
    lr = -(-rows // shards)
    # shard k owns permuted rows [k*lr, (k+1)*lr) clipped to rows: its
    # real-row count must be exactly min(lr, max(0, rows - k*lr))
    sums = []
    for k in range(shards):
        blk = perm[k * lr : (k + 1) * lr]
        expect = min(lr, max(0, rows - k * lr))
        assert blk.shape[0] == expect
        if blk.size:
            sums.append(flops[blk].sum())
    # near-equal balance among full shards
    full = [
        flops[perm[k * lr : (k + 1) * lr]].sum()
        for k in range(shards)
        if perm[k * lr : (k + 1) * lr].shape[0] == lr
    ]
    if len(full) > 1:
        assert max(full) - min(full) <= flops.max() * 2


def test_resumable_overflow_raises(tmp_path):
    graph = load_coo("tests/tdatas/tdata.snap", extra_capacity=16)
    mt0 = rmcl_init(graph)
    p = str(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError, match="overflow"):
        rmcl_resumable(
            mt0, max_iters=2, checkpoint_path=p, margin=0.01
        )
    # non-raising mode still completes and the checkpoint records the flag
    p2 = str(tmp_path / "ck2.npz")
    rmcl_resumable(
        mt0,
        max_iters=1,
        checkpoint_path=p2,
        margin=0.01,
        raise_on_overflow=False,
    )
    from sparse_matrix_with_flops_tpu.models.checkpoint import load_checkpoint

    _, _, extra = load_checkpoint(p2)
    assert bool(extra["overflow"])


def test_fused_bucket_overflow_detected_on_first_call(rng):
    """The FIRST fused call whose nnz(C) bucket is undersized must warn
    and still return the exact (re-derived) result — no caller may ever
    consume a truncated CSR (VERDICT r2 #5, supersedes the round-2
    one-call-behind contract)."""
    rp, c, v = random_csr_np(rng, 24, 24, 0.3)
    a = CSR.from_arrays(rp, c, v, ncols=24)
    plan = plan_ell(a, a)
    want = spgemm_dense_oracle(a, a)

    got1 = spgemm_ell(a, a, plan=plan)  # two-phase: sets the cache
    assert bool(
        got1._drop_explicit_zeros().is_raw_equal(
            want._drop_explicit_zeros(), tol=1e-4
        )
    )
    # poison the bucket below the true nnz(C): the next call takes the
    # fused path, detects the overflow BEFORE returning, and re-derives
    object.__setattr__(plan, "_nnzc_cache", 8)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got2 = spgemm_ell(a, a, plan=plan)
    assert any("overflowed" in str(w.message) for w in rec)
    assert bool(
        got2._drop_explicit_zeros().is_raw_equal(
            want._drop_explicit_zeros(), tol=1e-4
        )
    )
    # the re-derived cache is fresh and a fused follow-up works silently
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got3 = spgemm_ell(a, a, plan=plan)
    assert not rec
    assert bool(
        got3._drop_explicit_zeros().is_raw_equal(
            want._drop_explicit_zeros(), tol=1e-4
        )
    )


def test_init_distributed_single_process_noop(monkeypatch):
    """Without cluster env markers, init_distributed must neither raise
    nor attempt jax.distributed.initialize (ADVICE.md item 2)."""
    import jax

    called = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda *a, **k: called.append(1)
    )
    for var in (
        "JAX_COORDINATOR_ADDRESS",
        "COORDINATOR_ADDRESS",
        "SLURM_NTASKS",
    ):
        monkeypatch.delenv(var, raising=False)
    init_distributed()
    assert not called
    # explicit kwargs always initialize
    init_distributed(coordinator_address="127.0.0.1:1234", num_processes=1)
    assert called

"""R-MCL: Regularized Markov Clustering — the flagship algorithm driver.

Re-design of the reference L4 layer (nlibs/qrmcl.{h,cc}) for an accelerator:

* ``rmcl_init``      — rmclInit (qrmcl.cc:126-134): add self loops, order,
                       CSR-ize, row-uniform normalise (the input graph is
                       read transposed so rows are the stochastic axis).
* ``rmcl_one_step``  — one fused iteration Mt' = prune(inflate(Mgt·Mt)):
                       ESC SpGEMM feeding straight into the segmented
                       inflate/threshold/prune/normalize, never building an
                       intermediate CSR (the fused *RMCL_OneStep kernels,
                       omp_csr_kernel.cc:154-198,
                       static_omp_csr_kernel.cc:208-284).
* ``rmcl``           — the iteration driver.  ``mode="scan"`` keeps the
                       iterate device-resident in a ``lax.scan`` (the
                       gpuRmclIter pattern, gpu_csr_kernel.cu:281-311:
                       the iterate never leaves the device);
                       ``mode="loop"`` is a host loop that re-plans
                       capacities each iteration (the CPU mtRmclIter
                       pattern, qrmcl.cc:8-84).

Backend registry: the reference dispatches one of 8 kernel zoo variants via
``RunOptions`` (qrmcl.h:8-21).  Here the zoo collapses into ESC-based
kernels; the registry maps every reference name onto its equivalent so
callers can port run scripts unchanged.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_MAX_ITERS, INDEX_DTYPE, QVALUE_DTYPE
from ..formats.coo import COO
from ..formats.csr import CSR
from ..ops.metrics import differs as csr_differs
from ..ops.metrics import row_growth_histogram
from ..ops.prune import inflate_prune_normalize_stream, prune_normalize
from ..ops.spgemm import (
    esc_expand,
    esc_sort,
    matmul,
    spgemm_upper_bounds,
)


def rmcl_init(coo: COO) -> CSR:
    """Self loops + ordering + CSR + row-uniform normalisation
    (rmclInit, qrmcl.cc:126-134).  Requires coo capacity >= nnz + rows."""
    return coo.add_self_loops().make_ordered().to_csr().aver_and_norm_rows()


# ---------------------------------------------------------------------------
# one fused iteration
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("product_cap", "c_cap"))
def rmcl_one_step(mgt: CSR, mt: CSR, product_cap: int, c_cap: int):
    """Mt' = prune(inflate(Mgt · Mt)), fully fused on device.

    Output capacity equals ``mt.capacity`` so the result can be carried
    through ``lax.scan``.  Returns (new_mt, info) where info carries exact
    flops / nnz and overflow flags (capacities too small -> truncation,
    the moral equivalent of an undersized malloc)."""
    m, n = mgt.rows, mt.ncols
    prow, pcol, pval, flops = esc_expand(mgt, mt, product_cap)
    prow, pcol, pval, pvalid, flags, seg, nnzc = esc_sort(prow, pcol, pval, m)
    seg = jnp.where(pvalid, seg, c_cap)
    cval = jnp.zeros((c_cap,), QVALUE_DTYPE).at[seg].add(pval, mode="drop")
    crow = jnp.full((c_cap,), m, INDEX_DTYPE).at[seg].min(prow, mode="drop")
    ccol = jnp.full((c_cap,), n, INDEX_DTYPE).at[seg].min(pcol, mode="drop")
    cvalid = crow < m
    row_ptr, col, val, overflow_mt = inflate_prune_normalize_stream(
        crow, ccol, cval, cvalid, m, n, mt.capacity
    )
    new_mt = CSR(row_ptr, col, val, n)
    info = {
        "flops": flops,
        "nnz_c": nnzc,
        "nnz_mt": new_mt.nnz,
        "overflow_products": flops > product_cap,
        "overflow_c": nnzc > c_cap,
        "overflow_mt": overflow_mt,
    }
    return new_mt, info


def rmcl_one_step_unfused(mgt: CSR, mt: CSR):
    """SpGEMM then a separate prune pass (the SFOMP / seqRmclIter shape,
    qrmcl.cc:86-124).  Host-facing: plans capacities concretely."""
    c = matmul(mgt, mt)
    out, overflow = prune_normalize(c, out_cap=c.capacity)
    return out, overflow


# ---------------------------------------------------------------------------
# iteration drivers
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RmclResult:
    mt: CSR  # final iterate
    iters: int
    nnz_history: np.ndarray
    flops_history: np.ndarray
    differs_history: np.ndarray  # relative Frobenius drift per iteration
    overflow: bool
    row_growth: list | None = None


@partial(
    jax.jit, static_argnames=("product_cap", "c_cap", "max_iters", "track_differs")
)
def rmcl_scan(
    mgt: CSR,
    mt: CSR,
    product_cap: int,
    c_cap: int,
    max_iters: int,
    track_differs: bool = True,
):
    """Device-resident iteration via lax.scan (gpuRmclIter pattern)."""

    def step(carry, _):
        cur = carry
        new_mt, info = rmcl_one_step(mgt, cur, product_cap, c_cap)
        d = (
            csr_differs(cur, new_mt)
            if track_differs
            else jnp.asarray(0.0, QVALUE_DTYPE)
        )
        out = {
            "nnz": info["nnz_mt"],
            "flops": info["flops"],
            "differs": d,
            "overflow": info["overflow_products"]
            | info["overflow_c"]
            | info["overflow_mt"],
        }
        return new_mt, out

    return jax.lax.scan(step, mt, None, length=max_iters)


def plan_capacities(
    mgt: CSR, mt: CSR, margin: float = 1.5
) -> tuple[int, int]:
    """Host-side capacity planning: exact first-iteration flops with a
    safety margin (flops is not monotone across iterations: pruning can
    keep more entries than the previous iterate had)."""
    flops, _ = spgemm_upper_bounds(mgt, mt)
    product_cap = int(max(np.ceil(flops * margin), 16))
    return product_cap, product_cap


def rmcl(
    graph: COO | CSR,
    max_iters: int = DEFAULT_MAX_ITERS,
    mode: str = "scan",
    product_cap: int | None = None,
    c_cap: int | None = None,
    mt_cap: int | None = None,
    margin: float = 1.5,
    track_differs: bool = True,
    track_row_growth: bool = False,
    backend: str = "ESC",
    profile: bool = False,
) -> RmclResult:
    """Run R-MCL to ``max_iters`` (RMCL entry point, qrmcl.cc:136-164).

    ``graph``: a COO (already transposed if read with is_trans=True, the
    reference default) or an initialised CSR (output of ``rmcl_init``).
    """
    step_impl = BACKENDS[backend.upper()]
    mt0 = rmcl_init(graph) if isinstance(graph, COO) else graph
    mgt = mt0.deep_copy()  # Mgt = Mt.deepCopy() (qrmcl.cc:141)

    if product_cap is None or c_cap is None:
        pc, cc = plan_capacities(mgt, mt0, margin)
        product_cap = product_cap or pc
        c_cap = c_cap or cc

    # The iterate's capacity is its prune-survivor budget; pruning can keep
    # more entries than the previous iterate held, so default to c_cap
    # (always sufficient) unless the caller trades memory for a tighter cap.
    if mt_cap is None:
        mt_cap = c_cap
    if mt0.capacity < mt_cap:
        mt0 = mt0.with_capacity(mt_cap)

    if mode == "scan":
        mt, hist = rmcl_scan(
            mgt, mt0, product_cap, c_cap, max_iters, track_differs
        )
        return RmclResult(
            mt=mt,
            iters=max_iters,
            nnz_history=np.asarray(hist["nnz"]),
            flops_history=np.asarray(hist["flops"]),
            differs_history=np.asarray(hist["differs"]),
            overflow=bool(np.any(np.asarray(hist["overflow"]))),
        )

    # host loop: re-plan capacities per iteration (mtRmclIter shape).
    # Phase-labelled spans mirror the reference's -Dprofiling build
    # (static_omp_csr_kernel.cc:102-183 spans; SURVEY.md §5).
    from ..utils.timing import Profiler

    prof = Profiler(enabled=profile)
    mt = mt0
    nnzs, flopss, diffs, growth = [], [], [], []
    overflow = False
    for _ in range(max_iters):
        with prof.span("plan"):
            pc, cc = plan_capacities(mgt, mt, margin=1.0)
        with prof.span("one_step"):
            new_mt, info = step_impl(mgt, mt, pc, max(cc, mt.capacity))
            if profile:
                jax.block_until_ready(new_mt.values)
        if track_differs:
            diffs.append(float(csr_differs(mt, new_mt)))
        if track_row_growth:
            growth.append(np.asarray(row_growth_histogram(mt, new_mt)))
        nnzs.append(int(info["nnz_mt"]))
        flopss.append(int(info["flops"]))
        overflow |= bool(info["overflow_mt"]) or bool(info["overflow_c"])
        mt = new_mt
    if profile:
        print(prof.report())
    return RmclResult(
        mt=mt,
        iters=max_iters,
        nnz_history=np.asarray(nnzs),
        flops_history=np.asarray(flopss),
        differs_history=np.asarray(diffs),
        overflow=overflow,
        row_growth=growth if track_row_growth else None,
    )


def _esc_step(mgt, mt, product_cap, c_cap):
    return rmcl_one_step(mgt, mt, product_cap, c_cap)


# RunOptions parity (qrmcl.h:8-21): every reference backend collapses onto
# the device ESC kernel; the names remain valid so reference run scripts port.
BACKENDS: dict[str, Callable[..., Any]] = {
    "ESC": _esc_step,
    "SEQ": _esc_step,
    "OMP": _esc_step,
    "SOMP": _esc_step,
    "SFOMP": _esc_step,
    "HYB": _esc_step,
    "MKL": _esc_step,
    "CILK": _esc_step,
    "GPU": _esc_step,
}

"""Checkpoint / resume for long R-MCL runs.

The reference has none (SURVEY.md §5: matrices can only be text-dumped via
CSR::output under #ifdef debugging, nrmcl.cc:22-25).  This framework
adds real checkpointing of the iterate + iteration counter so multi-hour
clustering runs survive preemption — orbax when available, a portable npz
fallback otherwise.
"""

from __future__ import annotations

import os

import numpy as np

from ..formats.csr import CSR


def save_checkpoint(path: str, mt: CSR, iteration: int, extra: dict | None = None):
    """Write the iterate (host-materialised) + metadata."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "row_ptr": np.asarray(mt.row_ptr),
        "col_ind": np.asarray(mt.col_ind),
        "values": np.asarray(mt.values),
        "ncols": np.asarray(mt.ncols),
        "iteration": np.asarray(iteration),
    }
    for k, v in (extra or {}).items():
        payload["extra_" + k] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic publish


def load_checkpoint(path: str) -> tuple[CSR, int, dict]:
    with np.load(path) as z:
        mt = CSR.from_arrays(
            z["row_ptr"],
            z["col_ind"],
            z["values"],
            int(z["ncols"]),
            capacity=z["col_ind"].shape[0],
        )
        it = int(z["iteration"])
        extra = {
            k[len("extra_") :]: z[k] for k in z.files if k.startswith("extra_")
        }
    return mt, it, extra


def rmcl_resumable(
    graph,
    max_iters: int,
    checkpoint_path: str,
    checkpoint_every: int = 1,
    **kwargs,
):
    """R-MCL driver that checkpoints every ``checkpoint_every`` iterations
    and resumes from ``checkpoint_path`` if present."""
    from .rmcl import plan_capacities, rmcl_init, rmcl_one_step
    from ..formats.coo import COO

    mgt = rmcl_init(graph) if isinstance(graph, COO) else graph
    start = 0
    overflow = False
    if os.path.exists(checkpoint_path):
        mt, start, extra = load_checkpoint(checkpoint_path)
        overflow = bool(extra.get("overflow", False))
    else:
        mt = mgt.deep_copy()

    nnz_hist = []
    while start < max_iters:
        pc, cc = plan_capacities(mgt, mt, margin=kwargs.get("margin", 1.5))
        if mt.capacity < cc:
            mt = mt.with_capacity(cc)
        new_mt, info = rmcl_one_step(mgt, mt, pc, max(cc, mt.capacity))
        mt = CSR(new_mt.row_ptr, new_mt.col_ind, new_mt.values, new_mt.ncols)
        start += 1
        nnz_hist.append(int(info["nnz_mt"]))
        # undersized capacities truncate the iterate — the moral
        # equivalent of qmalloc's exit-on-OOM; track like rmcl() does and
        # persist so a resumed run cannot lose the signal
        overflow |= bool(
            info["overflow_products"]
            | info["overflow_c"]
            | info["overflow_mt"]
        )
        if start % checkpoint_every == 0 or start == max_iters:
            save_checkpoint(
                checkpoint_path, mt, start, extra={"overflow": overflow}
            )
    if overflow and kwargs.get("raise_on_overflow", True):
        raise RuntimeError(
            "rmcl_resumable: capacity overflow during iteration — the "
            "iterate was truncated; rerun with a larger margin"
        )
    return mt, start, nnz_hist

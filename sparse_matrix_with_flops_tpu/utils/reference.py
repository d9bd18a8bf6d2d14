"""Plain host references for checking device results at full size.

Everything here is scipy/numpy in float64 and shares no code with the
device engines: the SpGEMM reference is scipy's Gustavson product, and
the R-MCL reference is the unfused seqRmclIter loop (qrmcl.cc:86-124)
written directly against the reference's row math (util.cc:4-69).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..config import MLMCL_PRUNE_A, MLMCL_PRUNE_B, PRUNE_FLOOR
from ..formats.csr import CSR


def to_scipy(a: CSR) -> sp.csr_matrix:
    """Float64 host copy of a device CSR (valid entries only)."""
    rp = np.asarray(a.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    return sp.csr_matrix(
        (
            np.asarray(a.values)[:nnz].astype(np.float64),
            np.asarray(a.col_ind)[:nnz].astype(np.int64),
            rp,
        ),
        shape=a.shape,
    )


def spgemm_nnz_range(a: sp.csr_matrix, b: sp.csr_matrix) -> tuple[int, int]:
    """(value nnz, structural nnz) of A·B.

    The structural count (0/1 pattern product) is what the sort pipeline
    and the block engine produce; a product whose sum cancels to exactly
    0.0 is dropped by the dense hub, so nnz(C) may fall anywhere in
    [value nnz of the float32 product, structural nnz]."""
    a32 = a.astype(np.float32)
    b32 = b.astype(np.float32)
    vn = int((a32 @ b32).count_nonzero())
    pa, pb = a.copy(), b.copy()
    pa.data = np.ones_like(pa.data)
    pb.data = np.ones_like(pb.data)
    return vn, int((pa @ pb).nnz)


def rmcl_scipy_step(mg: sp.csr_matrix, m: sp.csr_matrix,
                    flip_margin: float = 1e-4):
    """One unfused R-MCL iteration Mt' = prune(inflate(Mgt·Mt)) in
    float64 (seqRmclIter, qrmcl.cc:86-124), with no selection cap.

    Returns ``(Mt', near)``.  Pruning is a threshold, so an entry within
    rounding distance of its row's threshold may fall on the other side
    in float32, and renormalising then moves the rest of the row;
    ``near[i]`` marks rows with an entry within ``flip_margin``
    (relative) of their threshold."""
    n = m.shape[0]
    m = (mg @ m).tocsr()
    m.sort_indices()
    w = m.data * m.data  # inflation (arrayInflationR2, util.cc:41-45)
    cnt = np.diff(m.indptr)
    row = np.repeat(np.arange(n), cnt)
    rsum = np.bincount(row, weights=w, minlength=n)
    rmax = np.zeros(n)
    np.maximum.at(rmax, row, w)
    avg = rsum / np.maximum(cnt, 1)
    # computeThreshold (util.cc:4-9)
    thr = MLMCL_PRUNE_A * avg * (1.0 - MLMCL_PRUNE_B * (rmax - avg))
    thr = np.minimum(np.maximum(thr, PRUNE_FLOOR), rmax)
    keep = w >= thr[row]
    near = np.zeros(n, bool)
    near[row[np.abs(w - thr[row]) <= flip_margin * thr[row]]] = True
    ksum = np.bincount(row[keep], weights=w[keep], minlength=n)
    data = w[keep] / np.maximum(ksum[row[keep]], 1e-30)
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(row[keep], minlength=n))]
    )
    return sp.csr_matrix((data, m.indices[keep], indptr), shape=m.shape), near


def rmcl_scipy(mt0: sp.csr_matrix, iters: int) -> sp.csr_matrix:
    """``iters`` steps of :func:`rmcl_scipy_step` with Mgt = Mt0 fixed
    (qrmcl.cc:141)."""
    mg = mt0.astype(np.float64).tocsr()
    m = mg
    for _ in range(iters):
        m, _ = rmcl_scipy_step(mg, m)
    return m


def compare_csr(
    got: sp.csr_matrix,
    want: sp.csr_matrix,
    rel: float,
    abs_: float,
    scale: sp.csr_matrix | None = None,
) -> dict:
    """Entry-wise check on the union of both patterns (a missing entry
    counts as 0): ``|got - want| <= abs_ + rel * scale`` with ``scale``
    defaulting to ``|want|``.  For a product C = A·B pass
    ``scale = |A|·|B|``: a float32 sum of signed terms is only accurate
    relative to the sum of the terms' magnitudes."""
    g = got.tocsr().astype(np.float64)
    w = want.tocsr().astype(np.float64)
    ref = abs(w if scale is None else scale).tocsr()
    d = abs(g - w).tocsr()
    excess = (d - rel * ref).tocsr()
    inv = ref.copy()
    inv.data = 1.0 / np.maximum(inv.data, abs_)
    relerr = d.multiply(inv).tocsr()
    over = excess.tocoo()
    bad = over.data > abs_
    return {
        "ok": not bool(bad.any()),
        "bad_entries": int(bad.sum()),
        "bad_rows": np.unique(over.row[bad]),
        "max_abs_err": float(d.data.max()) if d.nnz else 0.0,
        "max_rel_err": float(relerr.data.max()) if relerr.nnz else 0.0,
        "nnz_got": int(g.count_nonzero()),
        "nnz_want": int(w.count_nonzero()),
    }

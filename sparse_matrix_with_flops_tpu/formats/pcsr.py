"""PCSR: column-striped CSR — the seed of the column-sharding story.

Re-design of the reference's ``struct PCSR`` (nlibs/PCSR.h:5-101,
PCSR.cc:3-56): the matrix is split into ``c`` vertical stripes, each a CSR
over local columns; its only kernel is the striped SpGEMM in the test
driver (stripe-wise ``A.omp_spmm(pB.blocks[b])``, correctTests/pcsrTest.cc:
7-19).  The production path for this idea is the mesh sharding in
``parallel/`` (SURVEY.md P4); this container exists for single-host parity
and as the reference point for the striped differential test.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .csr import CSR


@dataclasses.dataclass(frozen=True)
class PCSR:
    """Host-side container: ``stripes[b]`` holds columns
    [b·stride, (b+1)·stride) with *local* column ids."""

    stripes: tuple  # tuple[CSR, ...]
    ncols: int

    @property
    def num_stripes(self) -> int:
        return len(self.stripes)

    @property
    def stride(self) -> int:
        # ceil(cols / c) (PCSR.h:20-22)
        return -(-self.ncols // self.num_stripes)

    @property
    def rows(self) -> int:
        return self.stripes[0].rows

    @staticmethod
    def from_csr(a: CSR, num_stripes: int) -> "PCSR":
        stride = -(-a.ncols // num_stripes)
        rp = np.asarray(a.row_ptr, dtype=np.int64)
        nnz = int(rp[-1])
        col = np.asarray(a.col_ind)[:nnz]
        val = np.asarray(a.values)[:nnz]
        erow = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(rp))
        stripes = []
        for b in range(num_stripes):
            lo, hi = b * stride, min((b + 1) * stride, a.ncols)
            sel = (col >= lo) & (col < hi)
            counts = np.bincount(erow[sel], minlength=a.rows)
            srp = np.zeros(a.rows + 1, dtype=np.int64)
            np.cumsum(counts, out=srp[1:])
            stripes.append(
                CSR.from_arrays(
                    srp.astype(np.int32), col[sel] - lo, val[sel], hi - lo
                )
            )
        return PCSR(tuple(stripes), a.ncols)

    def to_csr(self) -> CSR:
        """Stitch stripes back (host side)."""
        dense = np.zeros((self.rows, self.ncols), dtype=np.float32)
        stride = self.stride
        for b, s in enumerate(self.stripes):
            dense[:, b * stride : b * stride + s.ncols] += np.asarray(
                s.to_dense()
            )
        return CSR.from_dense(dense)

    def striped_spgemm(self, a: CSR) -> "PCSR":
        """C = a · self, stripe by stripe (pcsrTest.cc:7-19 semantics):
        each output stripe is an independent SpGEMM against one stripe."""
        from ..ops.spgemm import matmul

        return PCSR(
            tuple(matmul(a, s) for s in self.stripes), self.ncols
        )

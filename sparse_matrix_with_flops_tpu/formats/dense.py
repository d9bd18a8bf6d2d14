"""DenseMatrix: CSR↔dense bridge + the dense-GEMM differential oracle.

Parity with the reference's ``struct DenseMatrix`` (nlibs/DenseMatrix.h:
3-45): a row-major dense scatter of a CSR used to check sparse kernels
against ``cblas_dgemm`` (correctTests/dense-somp.cc:33-46).  Here the
"cblas" is ``jnp.dot`` at true f32 (config.MATMUL_PRECISION).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..config import MATMUL_PRECISION, QVALUE_DTYPE
from .csr import CSR


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("data",),
    meta_fields=(),
)
@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    data: jax.Array  # f32[rows, cols]

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    @property
    def cols(self) -> int:
        return self.data.shape[1]

    @staticmethod
    def from_csr(a: CSR) -> "DenseMatrix":
        return DenseMatrix(a.to_dense())

    def matmul(self, other: "DenseMatrix") -> "DenseMatrix":
        """The cblas_dgemm role (dense-somp.cc:23-46)."""
        return DenseMatrix(
            jnp.dot(
                self.data,
                other.data,
                preferred_element_type=jnp.float32,
                precision=MATMUL_PRECISION,
            ).astype(QVALUE_DTYPE)
        )

    def to_csr(self) -> CSR:
        import numpy as np

        return CSR.from_dense(np.asarray(self.data))

"""Sparse matrix containers (L1 format layer, static-shape pytrees)."""

from .bcsr import BCSR
from .coo import COO
from .csr import CSR
from .dense import DenseMatrix
from .ell import ELL
from .mcsr import MCSR
from .pcsr import PCSR
from .tiled import TiledCSR

__all__ = ["BCSR", "COO", "CSR", "DenseMatrix", "ELL", "MCSR", "PCSR", "TiledCSR"]

"""Data-adaptive SpGEMM kernel dispatch.

The reference classifies every multiply per run and dispatches
differently-shaped kernels (device classifier mindex2-cuda/flops.cu:
110-140; CPU queue classifier nGpuSpMM.cc:48-83).  This framework has
two structurally different engines:

* the lane pipeline (ops/ell_esc.py): flops-classified row tiles,
  gather + per-row sort-compress — right for power-law / scale-free
  structure where occupied blocks would be ~0.1% dense;
* the dense-block engine (ops/block_spgemm.py): batched bs x bs block
  matmuls — right for FEM/band structure (the reference's cant/consph/
  shipsec anchors) where blocks along the band are 15-40% dense and
  dense matmul rates make the 1/fill block waste cheap.

:func:`spgemm_auto` picks per multiply from the measured block fill —
one cheap host pass (block_fill_estimate).  BLOCK_FILL_THRESHOLD is
untuned on the H100, see ROADMAP queue 1 #7.
"""

from __future__ import annotations

from ..formats.csr import CSR
from .block_spgemm import block_fill_estimate, block_spgemm, plan_block
from .ell_esc import plan_ell, spgemm_ell

BLOCK_FILL_THRESHOLD = 0.05


def route(
    a: CSR,
    b: CSR,
    fill_threshold: float = BLOCK_FILL_THRESHOLD,
    bs: int = 128,
) -> tuple[str, float]:
    """The dispatch decision itself: ('block'|'ell', measured fill).

    Single source of truth for the routing rule — spgemm_auto and the
    corpus runner both call this, so a recorded ``routed`` field always
    reflects production routing (ADVICE r4 #2)."""
    fill = block_fill_estimate(a, b, bs=bs)
    return ("block" if fill >= fill_threshold else "ell"), fill


def spgemm_auto(
    a: CSR,
    b: CSR,
    fill_threshold: float = BLOCK_FILL_THRESHOLD,
    bs: int = 128,
) -> CSR:
    """C = A·B, routed to the dense-block engine or the lane pipeline by
    measured block fill (the flops.cu classifier role)."""
    kernel, _ = route(a, b, fill_threshold, bs)
    if kernel == "block":
        return block_spgemm(a, b, plan_block(a, b, bs=bs))
    return spgemm_ell(a, b, plan_ell(a, b))

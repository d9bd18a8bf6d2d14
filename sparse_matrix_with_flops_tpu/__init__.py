"""sparse_matrix_with_flops_tpu: a JAX sparse linear-algebra framework.

Ground-up JAX/XLA rebuild, run on an NVIDIA GPU, of the capabilities of
ankur-maximos/Sparse_Matrix_with_Flops: flops-aware SpGEMM, the R-MCL
Markov-clustering iteration, CSR/COO/BCSR/MCSR/PCSR formats, and a
multi-chip distributed layer (which the reference lacks entirely).

Layers (mirroring SURVEY.md):
  formats/   sparse containers as static-shape pytrees (L1)
  ops/       SpGEMM / SpMV / flops / prune kernels, XLA + Pallas (L2+L3)
  models/    the R-MCL algorithm driver (L4)
  parallel/  mesh + shard_map distributed execution (new layer)
  io/        SNAP + MatrixMarket ingestion (L0 tools)
  utils/     timers, histograms/stats, synthetic matrix generators (L0)
  cli/       command-line drivers and analysis tools (L5)

The platform is JAX's to choose: ``JAX_PLATFORMS=cpu`` for the CPU test
run, the GPU by default where one is present.
"""

__version__ = "0.1.0"

from .formats import COO, CSR

__all__ = ["COO", "CSR"]

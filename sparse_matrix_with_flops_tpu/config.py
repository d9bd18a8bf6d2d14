"""Global configuration and numeric constants.

Device rebuild of the reference's compile-time configuration:

* value dtype mirrors ``QValue = float`` (reference ``nlibs/tools/macro.h:5``,
  ``FSINGLE``); we keep float32 as the default value type so results are
  comparable with the reference within its own tolerances.
* R-MCL pruning constants mirror ``MLMCL_PRUNE_A/B`` and the 1e-7 floor
  (reference ``nlibs/tools/util.h:11-12``, ``util.cc:4-9``).
* runtime defaults mirror ``process_args.h:26-41`` (maxIters=5, stride=512).
* every float32 contraction runs at ``MATMUL_PRECISION``: true f32.  A GPU
  otherwise may run f32 products in TF32, whose ~5e-4 input rounding sits
  at the reference's own ``REL_TOL`` bar.

Indices are int32 throughout the device path: a single device cannot hold an
ESC expansion with more than 2^31 partial products anyway (12+ bytes per
product), and int32 keeps sorts/gathers on the fast path.  Host-side
capacity planning uses numpy int64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Value / index dtypes (macro.h:3-6: QValue = float).
QVALUE_DTYPE = jnp.float32
INDEX_DTYPE = jnp.int32

# R-MCL pruning parameters (util.h:11-12, util.cc:4-9).
MLMCL_PRUNE_A = 0.90
MLMCL_PRUNE_B = 2.0
PRUNE_FLOOR = 1.0e-7

# Precision of every float32 matmul / einsum / dot_general on device.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST

# Comparison tolerances (CSR.h:234 isEqual; nGpuSpMM.cc:111 per-bin relative).
ABS_TOL = 1.0e-7
REL_TOL = 1.0e-3

# Runtime defaults (process_args.h:28,31).
DEFAULT_MAX_ITERS = 5
DEFAULT_STRIDE = 512

# GPU-reference flops bins (mindex2-cuda/flops.cu:39-47): bin id by row flops
# {1: f==0, 2: f==1, 3: 2..4, 4: 5..16, 5: 17..64, 6: 65..512, 7: >512}.
FLOPS_BIN_BOUNDS = (0, 1, 4, 16, 64, 512)


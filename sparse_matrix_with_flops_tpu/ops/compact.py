"""Hub-row stream compaction: dense rows -> (cols, vals) nonzeros first.

The dense hub path (ops/ell_esc.py) multiplies hub rows densely per
column slab and must turn each dense ``[R, N]`` result back into sparse
rows: the nonzero lanes of every row, in column order, packed to the
front, with the tail filled by the sentinel column ``ncols`` and 0.0.
Dense rows are already column-ordered, so this is a stream compaction,
not a sort.

Both forms below place every lane with one permutation: a kept lane goes
to ``(#kept lanes up to it) - 1`` from the front, a dropped lane to
``(#dropped lanes up to it)`` from the back.  Every output slot is
written exactly once, so no fill pass and no mask are needed.

* :func:`compact_nonzero_rows_xla` — plain XLA: a row-wise prefix sum
  plus one unique-index scatter.  It is the reference for the kernel.
* :func:`compact_nonzero_rows` — a Pallas kernel on the Triton route:
  one program per row walks the row in ``block``-lane steps, carrying the
  kept count, so each element is read once and written once.

:func:`compact_hub_rows` is what the hub path calls: the kernel where the
program is lowered for a CUDA GPU, the XLA form on any other platform.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import INDEX_DTYPE, QVALUE_DTYPE

_BLOCK = 2048  # lanes per kernel step (power of two, as Triton needs)


def _slots(keep, lane, kept_before, n: int):
    """Destination slot of every lane under the keep/drop permutation."""
    k_incl = kept_before + jnp.cumsum(keep.astype(INDEX_DTYPE), axis=-1)
    return jnp.where(keep, k_incl - 1, n - (lane + 1 - k_incl))


@partial(jax.jit, static_argnames=("ncols",))
def compact_nonzero_rows_xla(vals: jax.Array, ncols: int):
    """Dense ``[R, N]`` rows -> (cols, vals), nonzeros of lanes < ncols
    first in column order; cols of the tail are ``ncols``."""
    r, n = vals.shape
    lane = jax.lax.broadcasted_iota(INDEX_DTYPE, (r, n), 1)
    keep = (vals != 0) & (lane < ncols)
    pos = _slots(keep, lane, 0, n)
    rows = jax.lax.broadcasted_iota(INDEX_DTYPE, (r, n), 0)

    def place(x):
        return jnp.zeros_like(x).at[rows, pos].set(
            x, unique_indices=True, mode="promise_in_bounds"
        )

    return (
        place(jnp.where(keep, lane, ncols)),
        place(jnp.where(keep, vals, 0.0).astype(QVALUE_DTYPE)),
    )


def _compact_kernel(v_ref, c_out, v_out, *, n: int, ncols: int, block: int):
    def step(j, kept):
        start = pl.multiple_of(j * block, block)
        v = v_ref[pl.ds(start, block)]
        lane = start + jax.lax.iota(INDEX_DTYPE, block)
        keep = (v != 0) & (lane < ncols)
        pos = _slots(keep, lane, kept, n)
        c_out[pos] = jnp.where(keep, lane, ncols)
        v_out[pos] = jnp.where(keep, v, 0.0)
        return kept + jnp.sum(keep.astype(INDEX_DTYPE))

    jax.lax.fori_loop(0, n // block, step, jnp.int32(0))


@partial(jax.jit, static_argnames=("ncols", "interpret"))
def compact_nonzero_rows(vals: jax.Array, ncols: int, interpret: bool = False):
    """Kernel form of :func:`compact_nonzero_rows_xla` (same contract).

    Widths that are not a power of two are zero-padded to one (padding
    lanes are dropped lanes) and the result is cut back to ``N``."""
    r, n = vals.shape
    npad = max(pl.next_power_of_2(n), 16)
    if npad != n:
        vals = jnp.pad(vals, ((0, 0), (0, npad - n)))
    block = min(_BLOCK, npad)
    row = pl.BlockSpec((None, npad), lambda i: (i, 0))
    cols, out = pl.pallas_call(
        partial(_compact_kernel, n=npad, ncols=ncols, block=block),
        out_shape=(
            jax.ShapeDtypeStruct((r, npad), INDEX_DTYPE),
            jax.ShapeDtypeStruct((r, npad), QVALUE_DTYPE),
        ),
        grid=(r,),
        in_specs=[row],
        out_specs=(row, row),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="compact_nonzero_rows",
    )(vals.astype(QVALUE_DTYPE))
    return cols[:, :n], out[:, :n]


def compact_hub_rows(vals: jax.Array, ncols: int):
    """Hub-path compaction, chosen per platform at lowering time."""
    return jax.lax.platform_dependent(
        vals,
        cuda=partial(compact_nonzero_rows, ncols=ncols),
        default=partial(compact_nonzero_rows_xla, ncols=ncols),
    )

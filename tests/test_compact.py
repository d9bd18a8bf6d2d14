"""Hub-row compaction (ops/compact.py): the Triton kernel in interpret
mode and the XLA form against a numpy oracle, and the per-platform
choice between them."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparse_matrix_with_flops_tpu.ops.compact import (
    compact_hub_rows,
    compact_nonzero_rows,
    compact_nonzero_rows_xla,
)

FORMS = {
    "triton_interpret": lambda v, n: compact_nonzero_rows(v, n, interpret=True),
    "xla": compact_nonzero_rows_xla,
}


def _oracle(v, ncols):
    r, n = v.shape
    cols = np.full((r, n), ncols, np.int32)
    vals = np.zeros((r, n), np.float32)
    for i in range(r):
        nz = np.nonzero(v[i, :ncols])[0]
        cols[i, : nz.size] = nz
        vals[i, : nz.size] = v[i, nz]
    return cols, vals


def _rows(rng, n):
    """Sparse random rows plus an all-zero and a full row."""
    v = np.where(
        rng.random((4, n)) < 0.05, rng.standard_normal((4, n)), 0.0
    ).astype(np.float32)
    v[1] = 0.0
    v[2] = rng.random(n).astype(np.float32) + 1.0
    return v


@pytest.mark.parametrize("ncols_case", ["full", "narrow"])
@pytest.mark.parametrize("width", [128, 1000, 4096, 16384, 65536])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_compact_nonzero_rows_matches_numpy(form, width, ncols_case):
    rng = np.random.default_rng(width)
    v = _rows(rng, width)
    ncols = width if ncols_case == "full" else width - 37
    cols, vals = FORMS[form](jnp.asarray(v), ncols)
    want_c, want_v = _oracle(v, ncols)
    np.testing.assert_array_equal(np.asarray(cols), want_c)
    np.testing.assert_array_equal(np.asarray(vals), want_v)


def test_compact_nonzero_rows_wide_widths():
    """Hub slabs up to 131072 lanes: the kernel walks each row in fixed
    steps, so any power-of-two width compiles to the same loop."""
    rng = np.random.default_rng(9)
    for n in (65536, 131072):
        v = np.where(
            rng.random((8, n)) < 0.05,
            rng.random((8, n)).astype(np.float32),
            0.0,
        ).astype(np.float32)
        k, cv = compact_nonzero_rows(jnp.asarray(v), n, interpret=True)
        kk, vv = np.asarray(k), np.asarray(cv)
        for i in range(8):
            nz = np.nonzero(v[i])[0]
            assert np.array_equal(kk[i][: nz.size], nz)
            assert np.allclose(vv[i][: nz.size], v[i][nz])
            assert np.all(kk[i][nz.size :] == n)


def _lowered(platform: str) -> str:
    f = jax.jit(lambda v: compact_hub_rows(v, 1000))
    x = jnp.zeros((16, 1024), jnp.float32)
    return f.trace(x).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize(
    "platform, has_kernel", [("cpu", False), ("cuda", True)]
)
def test_hub_compaction_choice_per_platform(platform, has_kernel):
    """The hub path lowers the Triton kernel for CUDA and the XLA form
    elsewhere (lowering for CUDA needs no GPU, only the lowering rules)."""
    text = _lowered(platform)
    assert bool(re.search(r"triton", text)) == has_kernel

"""chip_smoke.py at tiny sizes on the CPU: its phases and checks run, and
its device check refuses a machine without a GPU."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

from sparse_matrix_with_flops_tpu.ops.ell_esc import plan_ell  # noqa: E402
from sparse_matrix_with_flops_tpu.utils.generate import (  # noqa: E402
    banded_csr,
    rmat_csr,
)


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit, match="needs 1 GPU"):
        chip_smoke.require_gpu()


def test_main_fails_without_result_line(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize(
    "name, build, route",
    [
        ("powerlaw", lambda: rmat_csr(9, edge_factor=8, seed=7,
                                      weights="random"), "ell"),
        ("band", lambda: banded_csr(600, bandwidth=16), "block"),
    ],
)
def test_phase_spgemm_tiny(name, build, route):
    rec = chip_smoke.phase_spgemm(name, build(), route)
    assert rec["route"] == route
    assert rec["check"]["ok"], rec["check"]
    assert rec["check"]["bad_entries"] == 0


def test_phase_rmcl_tiny():
    rec = chip_smoke.phase_rmcl(8, 16, 2, 64)
    assert rec["ok"], rec
    assert rec["truncated_rows"] == 0


def test_hub_compaction_shapes_follow_the_plan():
    a = rmat_csr(8, edge_factor=8, seed=3, weights="random")
    plan = plan_ell(a, a, chunk=16, max_w=256, split_hub=False)
    shapes = chip_smoke.hub_compaction_shapes(plan)
    assert shapes
    for rows, width, ncols in shapes:
        assert 0 < rows <= 1024 and width in {g.slab for g in plan.hub_groups}
        assert 0 < ncols <= width


def test_phase_kernels_interpret():
    rec = chip_smoke.phase_kernels(
        [(8, 128, 100), (16, 2048, 2048)], interpret=True
    )
    assert rec["ok"]
    assert all(r["equal"] for r in rec["compact_nonzero_rows"])


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; python chip_smoke.py runs this on the card")


@pytest.mark.gpu
def test_compaction_kernel_on_card(gpu):
    rec = chip_smoke.phase_kernels([(1024, 4096, 4096), (8, 16384, 16000)])
    assert rec["ok"]

"""On the card: the control (the reference in TF32 in the program's
place) and the half-batch fault, at each cell's own size on one seed,
fail the cell's limits; a run of the cell passes them."""

import pytest

from portbench import control, harness

pytestmark = pytest.mark.cuda

CELLS = ["dn40-step-b128", "dn40-audit-b128"]


@pytest.mark.parametrize("mode", ["tf32", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(cuda, workload, mode):
    numbers = control.control(workload, 987654321, mode, cuda)
    limits = harness.load("limits", workload)
    assert any(numbers[k] > lim for k, lim in limits.items()), numbers


@pytest.mark.parametrize("workload", CELLS)
def test_run_passes_the_limits(cuda, workload):
    ctx = harness.run(workload, 987654322, 2.0, False, device=cuda)
    assert ctx["correct"], ctx["numbers"]

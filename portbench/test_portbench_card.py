"""The controls at the cells' own sizes, on the card: the program's readings
pass the cell's limits and the control's fail them. The full readings over
a dozen seeds come from control.py; these hold one seed each."""
import pytest

from portbench import control, harness

pytestmark = pytest.mark.cuda


def readings(workload, card):
    spec = harness.Spec()
    cell = spec.cell(workload)
    rows = []
    kind = spec.traffic(cell)["driver"]
    {"prefill": control.prefill_readings, "plan": control.plan_readings}[
        kind](spec, cell, [2 ** 31 + 101], [2 ** 31 + 101], card, rows.append)
    return spec.limits(cell), rows


@pytest.mark.parametrize("workload", ["olmoe-1b-7b.prefill-mixed",
                                      "deepseek-7b.plan-train"])
def test_the_program_passes_and_the_control_fails(card, workload):
    limits, rows = readings(workload, card)
    sides = {r["side"]: r for r in rows}
    assert all(sides["program"][k] <= v for k, v in limits.items())
    for side in set(sides) - {"program"}:       # the control, and faults
        assert any(sides[side][k] > v for k, v in limits.items()), side

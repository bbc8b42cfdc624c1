"""Runs of each cell on the CPU at a tiny size with the timed path broken
underneath: the comparison that decides ``correct`` has to see each fault
the cell can have, at the cell's own limits. The harness's look for a chip
is skipped; everything after it runs."""

import pytest

from benchmark.tests import tiny

FAULTS = [
    ("docs.layoutlm.infer.b32", "altered"),  # an answer altered where it is produced
    ("extract.vg36.b8", "altered"),
    ("docs.layoutlm.train.b32", "frozen"),  # a step that leaves its state unchanged
    ("docs.layoutlm.train.b32", "half_batch"),  # half of the batch left out, the mean over the rest
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    result, ctx = tiny.run(cell, variant=fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values()), ctx.notes["readings"]

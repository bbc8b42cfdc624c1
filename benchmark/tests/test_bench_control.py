"""The control on the card, at each cell's own size: the program's int8
path (extraction, document labelling) and the float8 reference in the
program's place (training) have to come out as not correct. Skips without
a CUDA device; run with ``python -m pytest -m cuda benchmark/tests``."""

import time

import pytest
import torch

from benchmark import harness

CONTROLS = [("extract.vg36.b8", "int8"), ("docs.layoutlm.infer.b32", "int8")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs the cell at its own size on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", CONTROLS)
def test_the_programs_lower_precision_path_is_not_correct(card, cell, variant):
    ctx = harness.cell_context(cell, 3147483703, 3.0, False)
    ctx.device, ctx.variant, ctx.t_start = card, variant, time.time()
    result = harness.run(ctx)
    assert result["correct"] is False, ctx.notes["readings"]


@pytest.mark.cuda
def test_the_float8_reference_in_the_programs_place_is_not_correct(card):
    ctx = harness.cell_context("docs.layoutlm.train.b32", 3147483703, 3.0, False)
    ctx.device = card
    readings = harness.load_module("entries", "layoutlm_train").reference_control(ctx, "fp8")
    checks = harness.judge(readings, ctx.limits)
    assert not harness.passed(checks), checks

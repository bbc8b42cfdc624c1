"""The harness on the CPU: its pieces found by name, every driver at a tiny
size, the yardstick's arithmetic on hand-worked examples, the last line's
shape, and the refusal without a card."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import devtrace, flops, generate, harness, weights
from benchmark.tests import tiny

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(cell):
    ctx = harness.cell_context(cell, 1, 1.0, False)
    assert os.path.isfile(os.path.join(harness.BENCH_DIR, "drivers", ctx.traffic["driver"] + ".py"))
    assert os.path.isfile(os.path.join(harness.BENCH_DIR, "entries", ctx.traffic["entry"] + ".py"))
    assert ctx.limits and all(isinstance(v, (int, float)) for v in ctx.limits.values())
    for m in ctx.cell["end_to_end"] + ctx.cell["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    names = {m["name"] for m in ctx.cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and ctx.cell["per_layer"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and SPEC["paths"] == ["benchmark"]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for m in metrics:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_of_each_cell_is_correct_and_well_formed(cell):
    result, ctx = tiny.run(cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in ctx.cell["end_to_end"]}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(result)


def test_a_traced_tiny_run_reports_per_layer_metrics_only():
    result, ctx = tiny.run("docs.layoutlm.infer.b32", trace=True)
    names = {m["name"] for m in ctx.cell["per_layer"]}
    assert set(result["metrics"]) <= names and "mfu.infer" in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"]) and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_busy_time_on_a_hand_worked_example():
    # [0, 2) and [1, 3) merge to [0, 3); [5, 6) stands apart: 4 busy of the 6 they span
    merged = devtrace.busy_union([(5, 6), (0, 2), (1, 3)])
    assert merged == [(0, 3), (5, 6)] and sum(e - s for s, e in merged) == 4
    assert devtrace.busy_union([(0, 1), (1, 2)]) == [(0, 2)] and devtrace.busy_union([]) == []


def test_the_flop_counts_on_hand_worked_examples():
    cfg = {"hidden_size": 2, "intermediate_size": 3, "num_hidden_layers": 1, "num_labels": 1}
    # 8 L H^2 + 4 L H I + 4 L^2 H + 2 L H labels at L = 5
    assert flops.layoutlm_forward(cfg, 5) == 8 * 5 * 4 + 4 * 5 * 2 * 3 + 4 * 25 * 2 + 2 * 5 * 2
    assert flops.attention_pairs([3, 4]) == 25
    assert flops.attention_forward_flops(25, 2, 8) == 4 * 25 * 16
    assert flops.attention_backward_flops(25, 2, 8) == 2.5 * flops.attention_forward_flops(25, 2, 8)
    assert flops.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(0, 989e12) == pytest.approx(1.0)
    assert flops.resized_size(480, 640, 800, 1333) == (800, 1067)
    assert flops.resized_size(360, 672, 800, 1333) == (714, 1333)
    # a 7x7/2 pad-3 conv keeps ceil(n / 2)
    assert flops._out(800, 7, 2, 3) == 400 and flops._out(801, 7, 2, 3) == 401


def test_the_roofline_reader_counts_bytes_from_the_configuration():
    ctx = harness.cell_context("extract.vg36.b8", 1, 1.0, True)

    class FakeTrace:
        def ops(self, match):
            return [0.001] if match("vltk_tpu_torch::roi_pool") else []

    read = harness.load_module("metrics", "roi_pool_roofline").read
    value = read(ctx, {"traced_work": [{"images": 8}]}, FakeTrace())
    per_image = 84 * 84 * 1024 * 2 + 300 * 4 * 4 + 300 * 14 * 14 * 1024 * 2
    assert value == pytest.approx(100 * 8 * per_image / 3.35e12 / 0.001)
    assert read(ctx, {"traced_work": []}, FakeTrace()) is None


def test_every_seed_gets_the_same_sizes_in_its_own_order():
    t = harness.cell_context("extract.vg36.b8", 1, 1.0, False).traffic
    a, b = generate.image_sizes(t, 3), generate.image_sizes(t, 2 ** 31 + 5)
    assert sorted(map(tuple, a)) == sorted(map(tuple, b)) and not np.array_equal(a, b)
    assert (a[:, 0] > a[:, 1]).any() and (a[:, 0] < a[:, 1]).any()  # portraits and landscapes
    d = generate.documents(tiny.LAYOUTLM["traffic"] | {"words_per_line": 12, "cls_id": 101, "sep_id": 102},
                           7, 30522, 4)
    e = generate.documents(tiny.LAYOUTLM["traffic"] | {"words_per_line": 12, "cls_id": 101, "sep_id": 102},
                           7, 30522, 4)
    assert all(np.array_equal(d[k], e[k]) for k in d)
    real = d["mask"].sum(-1)
    assert np.array_equal(real, d["lengths"]) and (d["labels"][d["mask"] == 0] == -100).all()


def test_the_extraction_cell_runs_the_adapters_own_geometry():
    from vltk_tpu_torch.adapters.frcnn import FRCNN

    ctx = harness.cell_context("extract.vg36.b8", 1, 1.0, False)
    d, t = ctx.config["frcnn"], ctx.traffic
    assert tuple(d["canvas"]) == tuple(FRCNN.resized_canvas) and tuple(t["raw_canvas"]) == tuple(FRCNN.raw_canvas)
    assert (d["short"], d["maximum"], t["batch"]) == (FRCNN.short, FRCNN.maximum, FRCNN.model_batch_size)
    for h, w in generate.image_sizes(t, 11):
        rh, rw = flops.resized_size(int(h), int(w), d["short"], d["maximum"])
        assert rh <= d["canvas"][0] and rw <= d["canvas"][1] and h <= t["raw_canvas"][0] and w <= t["raw_canvas"][1]


def test_a_metric_of_a_family_is_read_by_the_familys_reader():
    assert harness.load_module("metrics", "mfu.train") is harness.load_module("metrics", "mfu")
    assert harness.load_module("metrics", "idle_share.anything") is harness.load_module("metrics", "idle_share")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric.train")


def test_the_idle_share_on_a_hand_worked_example():
    class FakeTrace:
        def summary(self):
            return {"busy_s": 0.3}

    read = harness.load_module("metrics", "idle_share").read
    # 0.3 busy seconds over 6 traced items, 4 s over 50 untraced items: 0.05 of 0.08 s an item is busy
    window = {"traced_items": 6, "untraced_items": 50, "untraced_s": 4.0}
    assert read(None, window, FakeTrace()) == pytest.approx(100 * (1 - 0.05 / 0.08))
    assert read(None, dict(window, untraced_items=0), FakeTrace()) is None
    assert read(None, window, None) is None


def test_the_controls_round_trips():
    from benchmark.reference import fake_int8
    from benchmark.reference.layoutlm import _E5M2Gradient

    w = torch.randn(3, 40, generator=torch.Generator().manual_seed(0))
    q = fake_int8(w, True)
    steps = q / (w.abs().amax(1, keepdim=True) / 127)
    assert torch.allclose(steps, steps.round(), atol=1e-4) and (q - w).abs().max() <= w.abs().max() / 254 + 1e-7
    x = torch.randn(5, requires_grad=True)
    g = torch.tensor([1.0, 0.3, -2.7, 1e-3, 5.0])
    _E5M2Gradient.apply(x).backward(g)
    s = 5.0 / torch.finfo(torch.float8_e5m2).max
    assert torch.equal(x.grad, (g / s).to(torch.float8_e5m2).float() * s) and not torch.equal(x.grad, g)


def test_weights_repeat_for_a_seed():
    spec = [("a", (3, 4), ("normal", 0.5)), ("b", (2,), ("const", 1.0))]
    x, y = weights.seeded(spec, 2 ** 31 + 9, "cpu"), weights.seeded(spec, 2 ** 31 + 9, "cpu")
    assert torch.equal(x["a"], y["a"]) and torch.equal(x["b"], torch.ones(2))
    assert not torch.equal(x["a"], weights.seeded(spec, 5, "cpu")["a"])


def test_the_reference_names_match_the_program():
    from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig
    from vltk_tpu_torch.models.layoutlm import LayoutLMForTokenClassification

    from benchmark.entries.frcnn_extract import FIELDS
    from benchmark.entries.layoutlm_docs import port_config
    from benchmark.reference import frcnn as rf
    from benchmark.reference import layoutlm as rl

    cfg = harness.cell_context("docs.layoutlm.infer.b32", 1, 1, False).config
    with torch.device("meta"):
        m = LayoutLMForTokenClassification(port_config(cfg))
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {n: s for n, s, _ in rl.param_spec(cfg)}
    d = harness.cell_context("extract.vg36.b8", 1, 1, False).config["frcnn"]
    with torch.device("meta"):
        f = FRCNN(FRCNNConfig(**{k: d[k] for k in FIELDS}, dtype=d["dtype"]))
    assert {k: tuple(v.shape) for k, v in f.state_dict().items()} == {n: s for n, s, _ in rf.param_spec(d)}


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; torch.cuda.device_count = lambda: 1; "
            "from benchmark import run; sys.exit(run.main(['--workload', %r, '--seed', '1', '--seconds', '1']))"
            % CELLS[0])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0 and out.stdout.strip() == ""

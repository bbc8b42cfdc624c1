"""The port's measuring tools against the JAX package's:
``vltk_tpu_torch/tools/preset_drift.py`` (bench.py's drift harness),
``tools/probe_trained_drift.py`` and ``tools/probe_int8_fidelity.py``.

``make_scenes`` draws bitwise the scenes of the JAX probe (loaded by path);
the harness's agreement columns at the tiny smoke geometry, on the port's
seeded tamed weights converted for JAX, equal ``bench.run_preset_drift``'s
smoke run to 1e-4; both probes' ``--smoke`` runs end on the CPU.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from vltk_tpu_torch.tools import preset_drift, probe_int8_fidelity, probe_trained_drift

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ("box_agreement@iou0.5", "mean_matched_iou", "feat_cosine_mean", "obj_id_agreement", "map50_vs_parity")


def _load(name):
    """A JAX tool by path; it imports ``bench`` from the repository root."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("geometry", ["smoke", "full"])
def test_make_scenes_is_bitwise_the_jax_probe_s(geometry):
    jax_probe = _load("probe_trained_drift")
    raw_canvas, _, _, _, raw_hw = preset_drift.GEOM[geometry]
    args = ((3, 4, (10, 28)) if geometry == "smoke" else (8, 16, (40, 160)))
    n = 2 if geometry == "smoke" else 1
    want = jax_probe.make_scenes(np.random.default_rng(7), n, raw_canvas, raw_hw, *args)
    got = probe_trained_drift.make_scenes(np.random.default_rng(7), n, raw_canvas, raw_hw, *args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert jax_probe.bench.GEOM == preset_drift.GEOM


def test_drift_columns_match_the_jax_harness():
    """Same tamed weights (the port's, converted for JAX), same seeded
    images: every preset's agreement columns within 1e-4 of JAX's."""
    import bench

    from vltk_tpu.models.convert import torch_frcnn_to_jax
    from vltk_tpu_torch.models.frcnn import FRCNNConfig

    variants = preset_drift.smoke_variants(*preset_drift.GEOM["smoke"][1:4])
    params = preset_drift.tamed_weights(FRCNNConfig(dtype="bfloat16", **variants[0][1]))
    got = preset_drift.run_preset_drift(smoke=True, params=params, device="cpu", quiet=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.run_preset_drift(types.SimpleNamespace(smoke=True, batch=2, roi_chunk=None),
                               params=torch_frcnn_to_jax({k: v.numpy() for k, v in params.items()}))
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert [r["preset"] for r in got["rows"]] == [r["preset"] for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        for c in COLUMNS:
            np.testing.assert_allclose(g[c], w[c], rtol=0, atol=1e-4, err_msg=f"{g['preset']} {c}")
        assert g["production_gate"] == w["production_gate"]
    # the pick is the fastest gate-passing preset by each harness's own CPU
    # clock, so the two picks may differ; the presets they choose from may not
    passing = {r["preset"] for r in got["rows"] if r["production_gate"]}
    assert passing == {r["preset"] for r in want["rows"] if r["production_gate"]}
    for pick in (got["production_pick"], want["production_pick"]):
        assert pick in passing if passing else pick is None
    assert got["gate"] == want["gate"]
    assert any(r["box_agreement@iou0.5"] < 1.0 for r in got["rows"])  # truncation moves something


def test_full_presets_are_the_jax_harness_s():
    import bench

    canvas, short, maximum = preset_drift.GEOM["full"][1:4]
    assert preset_drift.full_variants(canvas, short, maximum) == bench._full_drift_variants(canvas, short, maximum)


def test_trained_drift_smoke_ends_on_the_cpu(capsys):
    assert probe_trained_drift.main(["--smoke", "--device", "cpu", "--steps", "3"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["metric"] for x in lines] == ["trained_drift_meta_smoke",
                                            "frcnn_preset_drift_tamed-init-on-scenes_smoke",
                                            "frcnn_preset_drift_synthetic-trained_smoke", "trained_minus_tamed_smoke",
                                            "tf32_off_vs_on_smoke"]
    assert lines[0]["train_steps"] == 3 and np.isfinite(lines[0]["last_step_loss"])
    assert set(lines[3]["diff"]) == {"parity_300", "props_100", "int8_300"}
    # no TF32 on the CPU: nothing moves, and two forwards are bitwise equal
    for m in lines[4]["parity_300"].values():
        for counts in (m, m["control"]):
            assert counts["rpn_keeps"] > 0 and counts["rpn_keeps_moved"] == 0
            assert counts["rpn_keep_slots_reordered"] == counts["box_slots_bitwise_different"] == 0


def test_int8_fidelity_smoke_ends_on_the_cpu(capsys):
    assert probe_int8_fidelity.main(["--smoke", "--device", "cpu", "--steps", "3"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [r["metric"] for r in rows] == ["int8_fidelity_lxmert_vqa_smoke", "int8_fidelity_layoutlm_seq64_smoke"]
    for r in rows:
        assert 0.0 <= r["value"] <= 1.0 and r["flip_rate"] == pytest.approx(1.0 - r["value"])
        assert np.isfinite(r["logit_drift_max"]) and r["train_steps"] == 3


def test_agreement_row_is_the_jax_probe_s():
    jax_probe = _load("probe_int8_fidelity")
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 40, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 40)
    valid = rng.random(40) > 0.2
    with contextlib.redirect_stdout(io.StringIO()):
        want = jax_probe._agreement_row("x", a, b, labels, valid=valid)
    got = probe_int8_fidelity.agreement_row("x", a, b, labels, valid=valid, quiet=True)
    for k in ("value", "bf16_acc", "int8_acc", "flip_rate", "logit_drift_max"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert got["n_eval"] == want["n_eval"] and got["metric"] == want["metric"]

"""The port's CLI (``vltk_tpu_torch/cli.py``, ``vltk-torch``) against the JAX
package's (``vltk_tpu/cli.py``): the cases of ``tests/test_cli.py`` on flag
parsing, the config merge, the listings, the clean registry errors, the
crash report, the ``data`` command end to end, the coercion of extra flags
and the nested literals; the resolved ``Config.to_dict()`` equal to JAX's
for the same flags and YAML (less the four fields the port leaves out);
``simple`` with an expert or pipeline ``mesh.axes`` raising the ROADMAP
A.14b error and with a one-rank mesh handing the experiment its mesh and
``LXMERT_RULES``; ``predict`` and ``serve`` from a bundle on the CPU."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from vltk_tpu import cli as JCLI
from vltk_tpu_torch.cli import _build_config, _parse_flags, cmd_serve, main

#: fields of the JAX config the port leaves out (``vltk_tpu_torch/config.py``)
LEFT_OUT = {("data", "lang", "pad_direction"), ("data", "lang", "add_special_tokens"), ("data", "redownload"),
            ("email",)}


def _without(d, paths):
    d = json.loads(json.dumps(d, default=list))
    for path in paths:
        cur = d
        for key in path[:-1]:
            cur = cur[key]
        cur.pop(path[-1])
    return d


def _builtin(registry):
    """The registry's names less those that test modules add."""
    return [n for n in registry.avail() if not registry.get(n).__module__.startswith("tests")]


def test_parse_flags():
    argv = ["vqa:train", "--data.train_batch_size=4", "--test_run", "--yaml=c.yml", "--export-bundle=x.zip"]
    pos, flags = _parse_flags(argv)
    assert (pos, flags) == JCLI._parse_flags(argv)
    assert pos == ["vqa:train"]
    assert flags == {"data.train_batch_size": "4", "test_run": "true", "yaml": "c.yml", "export_bundle": "x.zip"}


@pytest.mark.parametrize("flags", [
    {"train.learning_rate": "0.5", "logdir": "override"},
    {"models.main.name": "lxmert", "models.main.freeze_layers": "(embeddings,encoder)",
     "evaluate.metrics": "(accuracy,f1)", "data.lang.max_seq_length": "32", "test_run": "true"},
])
def test_build_config_dot_flags_and_yaml_equal_jax(tmp_path, flags):
    yml = tmp_path / "c.yml"
    yml.write_text("train:\n  epochs: 7\nlogdir: base\ndata:\n  train_batch_size: 4\n")
    cfg = _build_config({"yaml": str(yml), **flags})
    assert cfg.train.epochs == 7 and cfg.data.train_batch_size == 4
    if "logdir" in flags:
        assert cfg.train.learning_rate == 0.5 and cfg.logdir == "override"
    want = JCLI._build_config({"yaml": str(yml), **flags}).to_dict()
    assert json.loads(json.dumps(cfg.to_dict(), default=list)) == _without(want, LEFT_OUT)


def test_main_listings_equal_the_jax_registries(capsys):
    from vltk_tpu.adapters import Adapters as JAdapters
    from vltk_tpu.adapters import register_frcnn as jax_register_frcnn
    from vltk_tpu.experiments import Experiments as JExperiments
    from vltk_tpu_torch.adapters import Adapters, register_frcnn
    from vltk_tpu_torch.experiments import Experiments

    # both packages register "frcnn" on first use, which earlier tests in
    # the same process may or may not have made: register it in both
    register_frcnn()
    jax_register_frcnn()
    assert main(["adapters"]) == 0
    assert capsys.readouterr().out.split() == Adapters.avail()
    assert _builtin(Adapters) == _builtin(JAdapters)
    assert main(["experiments"]) == 0
    assert capsys.readouterr().out.split() == Experiments.avail()
    assert _builtin(Experiments) == _builtin(JExperiments)


def test_main_config_prints(capsys):
    assert main(["config", "--train.epochs=2"]) == 0
    assert json.loads(capsys.readouterr().out)["train"]["epochs"] == 2


def test_main_unknown_command_and_version(capsys):
    assert main(["bogus"]) == 2
    assert main(["--version"]) == 0
    assert capsys.readouterr().out.strip().endswith("0.1.0")


def test_unknown_experiment_is_clean_error_not_crash(tmp_path, capsys):
    logdir = str(tmp_path / "logs")
    assert main(["simple", "no_such_experiment", f"--logdir={logdir}"]) == 2
    err = capsys.readouterr().err
    assert "unknown experiment" in err and "available" in err
    assert not os.path.exists(os.path.join(logdir, "crash.txt"))


def test_crash_report_written(tmp_path):
    from vltk_tpu_torch.experiments import Experiments

    class _Boom:
        name = "boom_test_only"

        def __init__(self, cfg):
            raise RuntimeError("synthetic crash for the report test")

    Experiments.add(_Boom)
    try:
        logdir = str(tmp_path / "logs")
        with pytest.raises(RuntimeError, match="synthetic crash"):
            main(["simple", "boom_test_only", f"--logdir={logdir}"])
        with open(os.path.join(logdir, "crash.txt")) as f:
            assert "synthetic crash" in f.read()
    finally:
        Experiments._classes.pop("boom_test_only", None)


def test_cli_data_command_end_to_end(tmp_path, capsys):
    """``data`` over a seeded raw corpus builds the loaders and prints a
    batch's shapes."""
    from vltk_tpu_torch.adapters import Adapters
    from vltk_tpu_torch.tools.synthetic_corpus import write_corpus

    datadir = str(tmp_path / "raw")
    write_corpus(datadir, 8, 128, hw=(48, 64), seed=0)
    Adapters.get("coco2014").extract(datadir)
    Adapters.get("vqa").extract(datadir)
    rc = main(["data", "vqa:train", f"--data.datadir={datadir}", "--data.train_batch_size=4",
               "--data.num_workers=0", "--data.rand_feats=(36,64)", f"--logdir={tmp_path / 'logs'}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "input_ids" in out and "features" in out


def test_extract_coerces_extra_flags(monkeypatch):
    """``extract ... --int8=false --roi_chunk=1600`` reaches the adapter as a
    bool and an int."""
    from vltk_tpu_torch.adapters import Adapters

    captured = {}

    class _Fake:
        @classmethod
        def extract(cls, datadir, dataset_name=None, **kw):
            captured.update(kw, dataset_name=dataset_name)
            return {}

    monkeypatch.setattr(Adapters, "get", staticmethod(lambda n: _Fake))
    assert main(["extract", "frcnn", "coco2014", "--int8=false", "--roi_chunk=1600", "--dtype=bfloat16",
                 "--device=cpu"]) == 0
    assert captured == {"int8": False, "roi_chunk": 1600, "dtype": "bfloat16", "device": "cpu",
                        "dataset_name": "coco2014"}


def test_nested_parse_rejects_trailing_input():
    from vltk_tpu_torch.config import _coerce

    with pytest.raises(ValueError):
        _coerce("(a,b),(c,d)")
    assert _coerce("((a,1),(b,2))") == (("a", 1), ("b", 2))


@pytest.mark.parametrize("axes", ["((data,1),(expert,2))", "((pipe,2),)"])
def test_simple_with_a_mesh_raises_the_a14_error(tmp_path, axes):
    """``expert`` and ``pipe`` axes are ported (A.14b): what is left to
    refuse is what JAX refuses, a mesh larger than the group (one rank
    here), with JAX's text, before the experiment is built."""
    from vltk_tpu_torch.experiments import Experiments

    class FakeExp:
        name = "fake_mesh"

        def __init__(self, cfg):
            pass

        def __call__(self):
            return {}

    Experiments.add(FakeExp)
    try:
        with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
            main(["simple", "fake_mesh", f"--mesh.axes={axes}", f"--logdir={tmp_path}"])
    finally:
        Experiments._classes.pop("fake_mesh", None)


def test_simple_with_a_one_rank_mesh_passes_it_and_the_rules(tmp_path):
    """``--mesh.axes`` set: the experiment gets the mesh (a one-rank gloo
    group on ``--device=cpu``) and the JAX CLI's ``LXMERT_RULES``; left at
    its default, no mesh."""
    import torch.distributed as dist

    from vltk_tpu_torch.experiments import Experiments
    from vltk_tpu_torch.parallel import LXMERT_RULES

    seen = []

    class FakeExp:
        name = "fake_one_rank_mesh"

        def __init__(self, cfg, **kwargs):
            seen.append(kwargs)

        def __call__(self):
            return {}

    Experiments.add(FakeExp)
    try:
        assert main(["simple", "fake_one_rank_mesh", "--device=cpu", f"--logdir={tmp_path}"]) == 0
        assert seen[-1] == {"device": "cpu"}
        assert main(["simple", "fake_one_rank_mesh", "--device=cpu", "--mesh.axes=((data,1),(model,1))",
                     "--mesh.zero1_axis=data", f"--logdir={tmp_path}"]) == 0
        mesh = seen[-1]["mesh"]
        assert mesh.shape == {"data": 1, "model": 1} and mesh.device.type == "cpu"
        assert seen[-1]["rules"] is LXMERT_RULES and dist.get_backend() == "gloo"
    finally:
        Experiments._classes.pop("fake_one_rank_mesh", None)
        if dist.is_initialized():
            dist.destroy_process_group()


def test_unknown_registry_name_is_clean_error(capsys):
    assert main(["data", "doesnotexist"]) == 2
    err = capsys.readouterr().err
    assert "unknown adapter" in err and "available" in err
    assert main(["simple", "nope"]) == 2
    assert "unknown experiment" in capsys.readouterr().err


def test_module_entry_point():
    out = subprocess.run([sys.executable, "-m", "vltk_tpu_torch.cli", "--version"], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0 and out.stdout.strip() == "vltk-tpu-torch 0.1.0"


# ------------------------------------------------- predict and serve, CPU


@pytest.fixture(scope="module")
def span_bundle(tmp_path_factory):
    """A tiny DocSpanQA exported on the CPU, its documents and questions."""
    from vltk_tpu_torch.data.tokenizer import Tokenizer
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
    from vltk_tpu_torch.predict import DocSpanQA

    root = tmp_path_factory.mktemp("cli_bundle")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "is", "the", "cat"]) + "\n")
    cfg = LayoutLMConfig(vocab_size=16, hidden_size=16, num_heads=2, intermediate_size=32, l_layers=1,
                         max_position_embeddings=32)
    qa = DocSpanQA(config=cfg, batch_size=2, question_len=8, doc_len=16, device="cpu",
                   tokenizer=Tokenizer(vocab_path=str(vocab), max_seq_length=8))
    path = str(root / "span.zip")
    qa.export_bundle(path)
    rng = np.random.default_rng(0)
    docs = []
    for n in (3, 9, 5):
        xy = rng.integers(0, 500, (n, 2))
        docs.append({"words": [["what", "is", "the", "cat"][i % 4] for i in range(n)],
                     "boxes": np.concatenate([xy, xy + 20], 1).tolist()})
    questions = ["what is", "the cat", "cat"]
    return path, qa, docs, questions, root


def test_predict_span_from_a_bundle(span_bundle, capsys):
    path, qa, docs, questions, root = span_bundle
    doc_path = root / "doc.json"
    doc_path.write_text(json.dumps(docs[1]))
    assert main(["predict", "--task=span", str(doc_path), *questions[1].split(), f"--bundle={path}",
                 "--device=cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = qa(docs[1:2], questions[1:2])[0]
    assert got == {"answer": want["answer"], "start_word": want["start_word"], "end_word": want["end_word"],
                   "score": round(want["score"], 4)}
    assert main(["predict", "--task=span", str(doc_path), "what", f"--bundle={path}", "--export-bundle=x.zip"]) == 2


def test_serve_a_bundle_in_order(span_bundle):
    """JSONL in, JSONL out in input order; a bad line answers with an error
    in its place and the server keeps going."""
    path, qa, docs, questions, _ = span_bundle
    lines = [json.dumps({"doc": d, "question": q}) for d, q in zip(docs, questions)]
    lines.insert(1, "{not json")
    out = io.StringIO()
    assert cmd_serve([], {"bundle": path, "device": "cpu", "max_delay_ms": "1"},
                     stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out) == 0
    results = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    assert len(results) == 4 and "bad request" in results[1]["error"]
    want = qa(docs, questions)
    assert [r["answer"] for r in results[:1] + results[2:]] == [w["answer"] for w in want]

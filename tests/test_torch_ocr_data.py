"""Raw FUNSD, DocVQA and GQA files through the port's user entry points,
held against the JAX package on the CPU.

Each corpus is drawn with numpy from a seed (``tools.synthetic_corpus``)
and copied twice; each package extracts its own copy and builds its own
loaders with ``build(config)`` (``num_workers=0``):

* FUNSD -> ``auxtokenize, ocrboxfixed, tokenlabels`` -> batches bitwise
  equal -> ``OCRTokenExperiment`` at a tiny LayoutLM (1 layer, width 16,
  dropout 0; the port starts from the JAX experiment's initial weights);
* DocVQA -> ``auxtokenize, ocrboxfixed`` + ``span`` -> batches bitwise
  equal -> ``DocVQASpanExperiment`` at the same width;
* GQA over Visual Genome images -> ``build`` joined with the images'
  extracted rows (``TinyHostDecodeFRCNN`` of each package, registered for
  the test) -> batches bitwise equal.

The experiments' logged losses equal JAX's within 1e-4 (float32 AdamW in
torch and optax round the update at other places; tests/test_torch_train.py
holds the same), the first loss included, and fall from the first two
steps to the last two, as tests/test_ocr.py checks.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import vltk_tpu as J
from vltk_tpu import config as JC
from vltk_tpu.adapters import Adapters as JAdapters
from vltk_tpu.data import hostpipe as JH
from vltk_tpu.experiments import Experiments as JExperiments
from vltk_tpu.models import layoutlm as JL

import vltk_tpu_torch as P
from vltk_tpu_torch import config as PC
from vltk_tpu_torch.adapters import Adapters
from vltk_tpu_torch.data import hostpipe as PH
from vltk_tpu_torch.experiments import DocVQASpanExperiment, OCRTokenExperiment
from vltk_tpu_torch.models.convert import jax_layoutlm_to_torch
from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
from vltk_tpu_torch.tools import synthetic_corpus as sc

TINY = dict(vocab_size=30522, hidden_size=16, num_heads=2, intermediate_size=32, l_layers=1,
            hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("ocr_data")
    jdir, pdir = str(root / "jax"), str(root / "port")
    sc.write_funsd(jdir, n_forms=6, n_words=20, seed=11)
    sc.write_docvqa(jdir, n_docs=4, n_words=14, questions_per_doc=2, seed=12)
    sc.write_gqa(jdir, n_images=5, n_questions=40, hw=(40, 56), seed=13)
    shutil.copytree(jdir, pdir)
    for reg, d in ((JAdapters, jdir), (Adapters, pdir)):
        reg.get("funsd").extract(d)
        reg.get("docvqavisn").extract(d)
        reg.get("docvqa").extract(d)
    return jdir, pdir


def both(corpora, train_datasets, lang, epochs=1, lr=0.01, **data):
    """(jax config, port config) over the two copies."""
    out = []
    for mod, d in ((JC, corpora[0]), (PC, corpora[1])):
        cfg = mod.Config()
        cfg.logdir = os.path.join(d, "logs")
        cfg.train.update({"epochs": epochs, "learning_rate": lr})
        cfg.data.update({"datadir": d, "train_datasets": train_datasets, "num_workers": 0, "shuffle": False,
                         "drop_last": False, **data})
        cfg.data.lang.update(lang)
        out.append(cfg)
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for k, wv in w.items():
            if isinstance(wv, np.ndarray):
                assert g[k].dtype == wv.dtype and g[k].shape == wv.shape, (i, k)
                np.testing.assert_array_equal(g[k], wv, err_msg=f"batch {i} key {k}")
            elif k != "filepath":
                assert g[k] == wv, (i, k)


def logged(exp):
    with open(os.path.join(exp.logdir, "steps_log.json")) as f:
        return [json.loads(line) for line in f]


def train_both(jcls, pcls, jcfg, pcfg, jloader, ploader, max_pos):
    jmodel = JL.LayoutLMConfig(**TINY, max_position_embeddings=max_pos)

    class JTiny(jcls):
        model_config = jmodel

    jexp = JTiny(jcfg, loaders=(jloader, None))
    init = jax_layoutlm_to_torch(jax.device_get(jexp.state.params))

    class PTiny(pcls):
        model_config = LayoutLMConfig(**dataclasses.asdict(jmodel))

        def build_model(self):
            model = super().build_model()
            model.load_state_dict(init)
            return model

    pexp = PTiny(pcfg, loaders=(ploader, None), device="cpu")
    jexp(), pexp()
    jlog, plog = logged(jexp), logged(pexp)
    assert [r["step"] for r in plog] == [r["step"] for r in jlog] and len(plog) >= 4
    np.testing.assert_allclose([r["loss"] for r in plog], [r["loss"] for r in jlog], rtol=1e-4, atol=1e-4)
    losses = [r["loss"] for r in plog]
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    return plog


def test_funsd_build_and_token_experiment(corpora):
    jcfg, pcfg = both(corpora, [["funsd", "train"]], {"max_visual_seq_length": 24}, epochs=3, lr=0.01,
                      train_batch_size=3, ignore_image=True,
                      visn_processors=["auxtokenize", "ocrboxfixed", "tokenlabels"])
    jloader, ploader = J.build(jcfg)[0], P.build(pcfg)[0]
    want, got = list(jloader), list(ploader)
    assert_batches_equal(got, want)
    b = got[0]
    assert b["vtext"].shape == (3, 24) and b["tokenbox"].shape == (3, 24, 4) and b["tokenlabels"].shape == (3, 24)
    assert (b["tokenlabels"] >= 0).any() and (b["tokenlabels"] == -100).any()
    assert ploader.metadata_ids["labels"] == {"answer": 0, "other": 1, "question": 2}
    plog = train_both(JExperiments.get("ocr_tokens"), OCRTokenExperiment, jcfg, pcfg, jloader,
                      ploader, 64)
    assert "token_acc" in plog[-1]


def test_docvqa_span_build_and_experiment(corpora):
    jcfg, pcfg = both(corpora, [["docvqa", "train"]], {"max_visual_seq_length": 20, "max_seq_length": 8},
                      epochs=4, lr=0.05, train_batch_size=4, ignore_image=True, ignore_filepath=True,
                      visn_processors=["auxtokenize", "ocrboxfixed"], visnlang_processors=["span"])
    jloader, ploader = J.build(jcfg)[0], P.build(pcfg)[0]
    want, got = list(jloader), list(ploader)
    assert_batches_equal(got, want)
    b = got[0]
    assert b["span_start"].shape == (4,) and b["tokenbox"].shape == (4, 20, 4) and b["input_ids"].shape == (4, 8)
    assert ((b["span_start"] <= b["span_end"]) | (b["span_start"] == -100)).all()
    plog = train_both(JExperiments.get("docvqa_span"), DocVQASpanExperiment, jcfg, pcfg, jloader,
                      ploader, 32)
    assert "span_acc" in plog[-1]


@pytest.fixture
def stub_extractors():
    JAdapters.add(JH.TinyHostDecodeFRCNN)
    Adapters.add(PH.TinyHostDecodeFRCNN)
    yield
    JAdapters._classes.pop("tinyhostdecodefrcnn", None)
    Adapters._classes.pop("tinyhostdecodefrcnn", None)


def test_gqa_build_with_visual_genome_features(corpora, stub_extractors):
    for tiny, d in ((JH.TinyHostDecodeFRCNN, corpora[0]), (PH.TinyHostDecodeFRCNN, corpora[1])):
        assert len(tiny.extract(d, dataset_name="visualgenome")["train"]) == 5
    jcfg, pcfg = both(corpora, [["gqa", "train"]], {"max_seq_length": 12}, train_batch_size=8,
                      extractor="tinyhostdecodefrcnn", max_detections=4, visual_dim=16)
    want, got = list(J.build(jcfg)[0]), list(P.build(pcfg)[0])
    assert_batches_equal(got, want)
    b = got[0]
    assert b["features"].shape == (8, 4, 16) and b["rawsize"].shape == (8, 2) and b["label"].shape == (8,)
    assert sorted(b["imgid"][:5]) == [str(i) for i in sc.vg_ids(5)] and b["layout"][0]
    assert (b["rawsize"] == [40, 56]).all() and b["labels"].shape == (8, 16)

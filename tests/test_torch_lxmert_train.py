"""The LXMERT trainers of the PyTorch port held against the JAX package on the
CPU, at the tiny LXMERT of tests/test_torch_vqa.py (2 language, 1 visual and
1 cross layer, hidden 24, 2 heads; 5 answers, 7 objects, 5 attributes).

Weights: for the modules flax params drawn with numpy at unit scale at
flax's parameter shapes, carried across with ``jax_lxmert_to_torch``; for
the experiments the JAX experiment's own ``init`` params carried the same
way. Dropout is 0 wherever the packages are compared. Inputs are made with
numpy from a seed. Tolerances:

* heads, losses and ``LxmertForPretraining`` in float32: rtol/atol 1e-5
  (flax's LayerNorm takes the variance as E[x^2] - E[x]^2, torch's as
  E[(x - E[x])^2]; float32 sums in another order); the losses alone 1e-6;
* bf16 compute: the heads are float32 in both packages (flax ``nn.Dense``
  without a dtype), so on the same float32 input they agree to 1e-5; the
  whole model's outputs differ by the encoder's bf16 rounding flips (one
  bf16 ulp, 2^-8 relative, now and then, carried through the layers, as in
  tests/test_torch_vqa.py): atol 4e-2 of each output's largest magnitude
  (2.5e-2 measured);
* the host corruptions, ``prepare_batch`` and the converter: bitwise;
* train steps: logged losses 1e-4, parameters after three steps 1e-4
  (AdamW in torch and optax round the same update at other places; the
  attention key biases, whose gradient is zero in exact arithmetic, are
  left out: AdamW scales their rounding noise to a full step).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

import flax.traverse_util as tu

from vltk_tpu import config as JC
from vltk_tpu.models import lxmert as JX
from vltk_tpu.models.convert import jax_lxmert_to_torch as jx_lxmert_to_torch
from vltk_tpu.processing import lang as JLang
from vltk_tpu.train import metrics as JM
from vltk_tpu.utils import adapters as JA

from vltk_tpu_torch import config as PC
from vltk_tpu_torch.experiments import (
    DocVQASpanExperiment,
    Experiments,
    LxmertPretrainExperiment,
    LxmertVQAExperiment,
    OCRTokenExperiment,
)
from vltk_tpu_torch.models import lxmert as PX
from vltk_tpu_torch.models.convert import jax_lxmert_to_torch
from vltk_tpu_torch.processing import lang as PLang
from vltk_tpu_torch.train import metrics as PM
from vltk_tpu_torch.utils import adapters as PA

TINY = dict(
    vocab_size=64, hidden_size=24, num_heads=2, intermediate_size=48, l_layers=2,
    x_layers=1, r_layers=1, visual_feat_dim=128, max_position_embeddings=32,
    num_answers=5, num_objects=7, num_attrs=5, hidden_dropout=0.0, attention_dropout=0.0,
)
S, D, B = 12, 4, 4  # question tokens, regions, batch


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def close(got, want, rtol=1e-5, atol=1e-5, err_msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=err_msg)


def port_cfg(jcfg, **over):
    return dataclasses.replace(PX.LxmertConfig(**dataclasses.asdict(jcfg)), **over)


def lively(params, rng):
    """Flax params (or their shapes) drawn at unit scale: kernels
    lecun-normal, biases and LayerNorm offsets N(0, 0.1), LayerNorm scales
    U(0.5, 1.5), embeddings N(0, 1)."""
    flat = tu.flatten_dict(params, sep="/")
    for k, v in flat.items():
        leaf, shape = k.rsplit("/", 1)[-1], tuple(v.shape)
        if leaf == "kernel":
            arr = rng.normal(0, 1 / np.sqrt(shape[0]), shape)
        elif leaf == "scale":
            arr = rng.uniform(0.5, 1.5, shape)
        elif leaf == "embedding":
            arr = rng.normal(0, 1, shape)
        else:
            arr = rng.normal(0, 0.1, shape)
        flat[k] = arr.astype(np.float32)
    return tu.unflatten_dict(flat, sep="/")


def lxmert_inputs(rng, n=3):
    """ids, language mask (12, 7 and 3 real tokens), region features, [0, 1]
    boxes and a visual mask (4, 2 and 0 real regions)."""
    ids = rng.integers(0, TINY["vocab_size"], (n, S)).astype(np.int32)
    tmask = np.zeros((n, S), np.float32)
    vmask = np.zeros((n, D), np.float32)
    for i, (tl, vl) in enumerate(((S, D), (7, 2), (3, 0))[:n]):
        tmask[i, :tl] = 1.0
        vmask[i, :vl] = 1.0
    feats = rng.normal(size=(n, D, TINY["visual_feat_dim"])).astype(np.float32)
    corners = np.sort(rng.uniform(size=(n, D, 2, 2)), axis=2)
    boxes = corners.transpose(0, 1, 3, 2).reshape(n, D, 4).astype(np.float32)
    return ids, tmask, feats, boxes, vmask


@pytest.fixture(scope="module")
def pretraining():
    """(jax config, lively flax LxmertForPretraining params, port state dict)."""
    jcfg = JX.LxmertConfig(**TINY)
    rng = np.random.default_rng(1)
    ids, tmask, feats, boxes, vmask = lxmert_inputs(rng)
    shapes = jax.eval_shape(lambda: JX.LxmertForPretraining(jcfg).init(jax.random.PRNGKey(0), ids, feats, boxes))
    params = lively(shapes["params"], rng)
    return jcfg, params, jax_lxmert_to_torch(params)


def loaded(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


# ------------------------------------------------------- heads and model


class TestPretrainingModel:
    @pytest.mark.parametrize("dtype", [None, "bfloat16"])
    def test_mlm_head(self, pretraining, dtype):
        jcfg, params, sd = pretraining
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        lang = np.random.default_rng(2).normal(size=(3, S, 24)).astype(np.float32)
        want = JX.MLMHead(jcfg).apply({"params": params["mlm_head"]}, lang)
        got = loaded(PX.MLMHead(port_cfg(jcfg)), sub(sd, "cls.predictions."))(t(lang))
        assert got.dtype == torch.float32
        close(got, want)

    @pytest.mark.parametrize("dtype", [None, "bfloat16"])
    def test_visual_head(self, pretraining, dtype):
        jcfg, params, sd = pretraining
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        visn = np.random.default_rng(3).normal(size=(3, D, 24)).astype(np.float32)
        want = JX.VisualHead(jcfg).apply({"params": params["visual_head"]}, visn)
        got = loaded(PX.VisualHead(port_cfg(jcfg)), sub(sd, "obj_predict_head."))(t(visn))
        assert [g.shape[-1] for g in got] == [7, 5, 128]
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            close(g, w)

    @pytest.mark.parametrize("dtype", [None, "bfloat16"])
    def test_lxmert_for_pretraining(self, pretraining, dtype):
        """Every output of the model against flax: 1e-5 in float32; in bf16
        the encoder's rounding flips carry into the heads (atol 4e-2 of the
        output's largest magnitude; 2.5e-2 measured, on ``feat_pred``)."""
        jcfg, params, sd = pretraining
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        ids, tmask, feats, boxes, vmask = lxmert_inputs(np.random.default_rng(4))
        want = JX.LxmertForPretraining(jcfg).apply({"params": params}, ids, feats, boxes, tmask, vmask)
        got = loaded(PX.LxmertForPretraining(port_cfg(jcfg)), sd)(t(ids), t(feats), t(boxes), t(tmask), t(vmask))
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == torch.float32, k
            if dtype is None:
                close(got[k], w, err_msg=k)
            else:
                close(got[k], w, rtol=0, atol=4e-2 * float(np.abs(w).max()), err_msg=k)

    def test_losses(self):
        rng = np.random.default_rng(5)
        logits = (rng.normal(size=(3, S, 11)) * 4).astype(np.float32)
        labels = rng.integers(0, 11, (3, S)).astype(np.int32)
        labels[rng.random((3, S)) < 0.6] = -100
        close(PX.masked_lm_loss(t(logits), t(labels)), JX.masked_lm_loss(logits, labels), 1e-6, 1e-6)
        none = np.full_like(labels, -100)
        assert float(PX.masked_lm_loss(t(logits), t(none))) == float(JX.masked_lm_loss(logits, none)) == 0.0
        matched = (rng.normal(size=(5, 2)) * 3).astype(np.float32)
        is_matched = rng.integers(0, 2, 5).astype(np.int32)
        close(PX.matched_loss(t(matched), t(is_matched)), JX.matched_loss(matched, is_matched), 1e-6, 1e-6)
        pred, target = rng.normal(size=(2, 3, D, 16)).astype(np.float32)
        fmask = (rng.random((3, D)) < 0.5).astype(np.float32)
        for m in (fmask, np.zeros_like(fmask)):
            close(PX.visual_feat_loss(t(pred), t(target), t(m)), JX.visual_feat_loss(pred, target, m), 1e-6, 1e-6)
        obj = (rng.normal(size=(3, D, 7)) * 2).astype(np.float32)
        obj_labels = rng.integers(0, 7, (3, D)).astype(np.int32)
        close(PX.visual_label_loss(t(obj), t(obj_labels), t(fmask)),
              JX.visual_label_loss(obj, obj_labels, fmask), 1e-6, 1e-6)
        scores = rng.choice([0.0, 0.3, 0.6, 1.0], (5, 7)).astype(np.float32)
        qa = rng.normal(size=(5, 7)).astype(np.float32)
        close(PM.vqa_score(t(qa), t(scores)), JM.vqa_score(qa, scores), 1e-6, 1e-6)

    @pytest.mark.parametrize("num_answers", [3, 5, 9])
    def test_resize_num_qa_labels(self, pretraining, num_answers):
        """The shared rows kept exactly, new rows drawn (normal x 0.02) with
        zero bias, the other weights untouched; the JAX function's shapes
        and kept rows."""
        jcfg, params, sd = pretraining
        gen = torch.Generator().manual_seed(0)
        got = PX.resize_num_qa_labels(sd, num_answers, gen)
        want = JX.resize_num_qa_labels(params, num_answers, jax.random.PRNGKey(0))
        w, b = got["answer_head.logit_fc.3.weight"], got["answer_head.logit_fc.3.bias"]
        jw, jb = np.asarray(want["answer_head"]["logit"]["kernel"]).T, np.asarray(want["answer_head"]["logit"]["bias"])
        assert w.shape == jw.shape == (num_answers, 48) and b.shape == jb.shape == (num_answers,)
        keep = min(5, num_answers)
        np.testing.assert_array_equal(w[:keep].numpy(), jw[:keep])
        np.testing.assert_array_equal(b[:keep].numpy(), jb[:keep])
        if num_answers == 5:
            assert got is sd
        else:
            assert (b[keep:] == 0).all() and set(got) == set(sd)
            assert 0.005 < float(w[keep:].std()) < 0.05 if num_answers - keep > 1 else True
            assert all(torch.equal(got[k], v) for k, v in sd.items() if not k.startswith("answer_head.logit_fc.3"))
            PX.LxmertForVQA(port_cfg(jcfg, num_answers=num_answers)).load_state_dict(
                {k: v for k, v in got.items() if k.startswith(("lxmert.", "answer_head."))})
        with pytest.raises(KeyError, match="answer_head"):
            PX.resize_num_qa_labels({k: v for k, v in sd.items() if not k.startswith("answer")}, 3, gen)


class TestConverter:
    def test_pretraining_tree_matches_the_jax_converter(self, pretraining):
        """Keys and values (bitwise) of the JAX converter; the HF names of
        ``LxmertForPreTraining`` load strictly into the port's model."""
        jcfg, params, sd = pretraining
        ref = jx_lxmert_to_torch(params)
        assert set(sd) == set(ref)
        for prefix in ("cls.predictions.transform.", "cls.predictions.decoder.weight", "cls.predictions.bias",
                       "cls.seq_relationship.", "obj_predict_head.decoder_dict.feat.", "answer_head.logit_fc.3."):
            assert any(k.startswith(prefix) for k in sd), prefix
        for k, v in ref.items():
            np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
        PX.LxmertForPretraining(port_cfg(jcfg)).load_state_dict(sd, strict=True)

    def test_unknown_keys_raise(self, pretraining):
        _, params, _ = pretraining
        with pytest.raises(KeyError, match="visual_head/colour"):
            jax_lxmert_to_torch({**params, "visual_head": {"colour": {"bias": np.zeros(3)}}})
        with pytest.raises(KeyError, match="mystery_head"):
            jax_lxmert_to_torch({**params, "mystery_head": {"bias": np.zeros(3)}})


# ----------------------------------------------------- host corruptions


class TestCorruptions:
    @pytest.mark.parametrize("seed", [0, 9595])
    def test_masked_language_modeling_is_bitwise_jax(self, seed):
        rng = np.random.default_rng(100 + seed)
        ids = rng.integers(0, 110, (6, 20)).astype(np.int32)
        ids[:, 0] = 101
        mask = (np.arange(20)[None] < rng.integers(1, 21, (6, 1))).astype(np.int32)
        kw = dict(mask_token_id=103, vocab_size=110, special_ids=(0, 100, 101, 102, 103), mask_rate=0.4)
        jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):  # the generators stay in step
            want = JLang.masked_language_modeling(ids, mask, jrng, **kw)
            got = PLang.masked_language_modeling(ids, mask, prng, **kw)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        assert (got[1] != -100).any() and (got[0] == 103).any()

    @pytest.mark.parametrize("with_mask", [False, True])
    def test_masked_feature_modeling_is_bitwise_jax(self, with_mask):
        rng = np.random.default_rng(7)
        feats = rng.normal(size=(40, 16)).astype(np.float32)
        mask = rng.random(40) < 0.7 if with_mask else None
        jrng, prng = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(3):
            want = JLang.masked_feature_modeling(feats, mask, jrng, feature_mask_rate=0.5)
            got = PLang.masked_feature_modeling(feats, mask, prng, feature_mask_rate=0.5)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        assert got[1].any()

    def test_normalize_boxes_xyxy(self):
        rng = np.random.default_rng(8)
        boxes = rng.uniform(-10, 700, (3, D, 4)).astype(np.float32)
        raw = np.array([[480, 640], [0, 0], [300, 1000]], np.float32)
        np.testing.assert_array_equal(PA.normalize_boxes_xyxy(boxes, raw), JA.normalize_boxes_xyxy(boxes, raw))


# ----------------------------------------------------------- experiments


def vqa_batches(rng, n_batches, labels_1d=False):
    """Loader batches: question ids and mask, region features, raw-pixel
    boxes with their raw size, a box mask, sparse answer ids (padded with
    -100, one out of range) and their soft scores."""
    out = []
    for _ in range(n_batches):
        tmask = (np.arange(S)[None] < np.array([[S], [7], [3], [1]])).astype(np.int32)
        vmask = (np.arange(D)[None] < np.array([[D], [2], [1], [3]])).astype(np.float32)
        raw = np.array([[480, 640], [300, 400], [1000, 800], [64, 64]], np.float32)
        corners = np.sort(rng.uniform(0, 1, (B, D, 2, 2)), axis=2).transpose(0, 1, 3, 2).reshape(B, D, 4)
        labels = np.full((B, 3), -100, np.int32)
        labels[:, 0] = rng.integers(0, TINY["num_answers"], B)
        labels[1, 1], labels[2, 1] = rng.integers(0, TINY["num_answers"]), TINY["num_answers"] + 2
        batch = {
            "input_ids": (rng.integers(5, TINY["vocab_size"], (B, S)) * tmask).astype(np.int32),
            "text_attention_mask": tmask,
            "features": rng.normal(size=(B, D, TINY["visual_feat_dim"])).astype(np.float32),
            "boxes": (corners * np.concatenate([raw[:, ::-1], raw[:, ::-1]], 1)[:, None]).astype(np.float32),
            "rawsize": raw, "boxes_mask": vmask,
            "labels": labels[:, 0] if labels_1d else labels,
            "scores": (rng.choice([0.3, 0.6, 1.0], B) if labels_1d else rng.choice([0.3, 0.6, 1.0], (B, 3)))
            .astype(np.float32),
            "imgid": np.array(["a", "b", "c", "d"], dtype=object),
        }
        out.append(batch)
    return out


def configs(tmp, epochs=1, **train):
    out = []
    for mod, name in ((JC, "jax"), (PC, "port")):
        config = mod.Config()
        config.logdir = str(tmp / name)
        config.train.update({"epochs": epochs, "learning_rate": 5e-3, **train})
        config.data.lang.update({"max_seq_length": S})
        config.data.update({"max_detections": D})
        out.append(config)
    return out


def experiments(tmp, jcls, pcls, data, eval_data=None, jcfg=None, **train):
    """The JAX experiment and the port's, the port's built with the JAX
    experiment's initial weights."""
    jcfg = jcfg or JX.LxmertConfig(**TINY)
    jconfig, pconfig = configs(tmp, **train)

    class JTiny(jcls):
        model_config = jcfg

    jexp = JTiny(jconfig, loaders=(data, eval_data))
    init = jax_lxmert_to_torch(jax.device_get(jexp.state.params))

    class PTiny(pcls):
        model_config = port_cfg(jcfg)

        def build_model(self):
            model = super().build_model()
            model.load_state_dict(init)
            return model

    return jexp, PTiny(pconfig, loaders=(data, eval_data), device="cpu")


def logged(exp):
    with open(os.path.join(exp.logdir, "steps_log.json")) as f:
        return [json.loads(line) for line in f]


def assert_prepared_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert np.asarray(got[k]).dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def assert_steps_match(jexp, pexp, metric):
    jlog, plog = logged(jexp), logged(pexp)
    assert [r["step"] for r in plog] == [r["step"] for r in jlog] and plog
    for key in ("loss", metric) if isinstance(metric, str) else ("loss", *metric):
        np.testing.assert_allclose([r[key] for r in plog], [r[key] for r in jlog], rtol=1e-4, atol=1e-4, err_msg=key)
    final = jax_lxmert_to_torch(jax.device_get(jexp.state.params))
    state = pexp.model.state_dict()
    assert set(final) == set(state)
    for k, v in final.items():
        if not k.endswith("key.bias"):  # zero gradient in exact arithmetic
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


class TestLxmertVQAExperiment:
    @pytest.mark.parametrize("labels_1d", [False, True])
    def test_prepare_batch_is_bitwise_jax(self, tmp_path, labels_1d):
        """Box normalisation by the raw size, sparse answers densified (an
        id past the vocabulary dropped), a 1-D label vector as one label a
        row, the key order."""
        from vltk_tpu.experiments.lxmert_vqa import LxmertVQAExperiment as J

        data = vqa_batches(np.random.default_rng(1), 1, labels_1d)
        jexp, pexp = experiments(tmp_path, J, LxmertVQAExperiment, data)
        got = pexp.prepare_batch(data[0])
        assert_prepared_equal(got, jexp.prepare_batch(data[0]))
        assert got["scores"].shape == (B, TINY["num_answers"]) and "labels" not in got
        assert got["boxes"].max() <= 1.0
        dense = {k: v for k, v in data[0].items() if k not in ("labels", "rawsize")}
        dense["scores"] = got["scores"]
        assert_prepared_equal(pexp.prepare_batch(dense), jexp.prepare_batch(dense))

    def test_train_steps_match_jax(self, tmp_path):
        """An epoch of three steps and an eval pass: logged losses and
        vqa_score, the eval's vqa_score, the parameters after the steps."""
        from vltk_tpu.experiments.lxmert_vqa import LxmertVQAExperiment as J

        data = vqa_batches(np.random.default_rng(2), 3)
        jexp, pexp = experiments(tmp_path, J, LxmertVQAExperiment, data, eval_data=data[:1])
        want, got = jexp(), pexp()
        assert_steps_match(jexp, pexp, "vqa_score")
        np.testing.assert_allclose(got["eval"]["vqa_score"], want["eval"]["vqa_score"], rtol=0, atol=1e-6)

    def test_answer_head_sized_to_the_loader(self, tmp_path):
        class Loader(list):
            metadata_ids = {"answers": {str(i): i for i in range(9)}}

        data = Loader(vqa_batches(np.random.default_rng(3), 1))
        _, pconfig = configs(tmp_path)

        class Tiny(LxmertVQAExperiment):
            model_config = port_cfg(JX.LxmertConfig(**TINY))

        exp = Tiny(pconfig, loaders=(data, None), device="cpu")
        assert exp.model_config.num_answers == 9 and exp.model.answer_head.logit_fc[3].out_features == 9
        assert exp.prepare_batch(data[0])["scores"].shape == (B, 9)
        assert Tiny.model_config.num_answers == TINY["num_answers"]


class TestLxmertPretrainExperiment:
    TASKS = dict(task_mask_lm=True, task_obj_predict=True, task_matched=True, task_qa=True)

    @pytest.mark.parametrize("tasks", ["all", "mlm_matched", "none"])
    def test_prepare_batch_is_bitwise_jax(self, tmp_path, tasks):
        """Three batches in a row from generators seeded by train.seed: the
        corruptions in the JAX order, the swapped rows' MLM labels cleared,
        the QA scores densified."""
        from vltk_tpu.experiments.lxmert_pretrain import LxmertPretrainExperiment as J

        toggles = {"all": self.TASKS, "none": {k: False for k in self.TASKS},
                   "mlm_matched": dict(self.TASKS, task_obj_predict=False, task_qa=False)}[tasks]
        data = vqa_batches(np.random.default_rng(4), 3)
        for b in data:  # ids of a BERT-like range, so [MASK] 103 and the specials exist
            b["input_ids"] = np.where(b["text_attention_mask"] > 0, b["input_ids"] + 100, 0).astype(np.int32)
        jcfg = JX.LxmertConfig(**dict(TINY, vocab_size=200))
        jexp, pexp = experiments(tmp_path, J, LxmertPretrainExperiment, data, jcfg=jcfg, **toggles)
        for b in data:
            got = pexp.prepare_batch(b)
            assert_prepared_equal(got, jexp.prepare_batch(b))
        if tasks == "all":
            assert {"masked_labels", "feat_mask", "feat_target", "is_matched", "scores"} <= set(got)
            swapped = got["is_matched"] == 0
            assert (got["masked_labels"][swapped] == -100).all()

    def test_train_steps_match_jax(self, tmp_path):
        """Three steps with all four tasks on: the total and every term's
        logged loss, and the parameters after the steps."""
        from vltk_tpu.experiments.lxmert_pretrain import LxmertPretrainExperiment as J

        data = vqa_batches(np.random.default_rng(5), 3)
        for b in data:
            b["input_ids"] = np.where(b["text_attention_mask"] > 0, b["input_ids"] + 100, 0).astype(np.int32)
        jcfg = JX.LxmertConfig(**dict(TINY, vocab_size=200))
        jexp, pexp = experiments(tmp_path, J, LxmertPretrainExperiment, data, jcfg=jcfg, **self.TASKS)
        jexp(), pexp()
        assert_steps_match(jexp, pexp, ("mlm_loss", "matched_loss", "feat_loss", "qa_loss"))


class TestGuards:
    def test_registry(self):
        from vltk_tpu_torch.experiments import DataExperiment

        from vltk_tpu_torch.experiments import FRCNNDetectExperiment

        assert Experiments.avail() == ["data", "docvqa_span", "frcnn_detect", "lxmert_pretrain", "lxmert_vqa",
                                       "ocr_tokens"]
        for name, cls in (("data", DataExperiment), ("docvqa_span", DocVQASpanExperiment),
                          ("frcnn_detect", FRCNNDetectExperiment),
                          ("LXMERT_vqa", LxmertVQAExperiment), ("lxmert_pretrain", LxmertPretrainExperiment),
                          ("ocr_tokens", OCRTokenExperiment)):
            assert Experiments.get(name) is cls
        with pytest.raises(KeyError, match="unknown"):
            Experiments.get("no_such")

    def test_config_fields_match_jax(self):
        port, ref = PC.LangConfig(), JC.LangConfig()
        for name, value in port:
            assert getattr(ref, name) == value, name
        assert PC.DataConfig().max_detections == JC.DataConfig().max_detections

    def test_entry_points_need_the_card_unless_asked(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        data = vqa_batches(np.random.default_rng(6), 1)
        for cls in (LxmertVQAExperiment, LxmertPretrainExperiment):
            _, pconfig = configs(tmp_path)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(pconfig, loaders=(data, None))

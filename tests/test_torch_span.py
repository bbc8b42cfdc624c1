"""The document span-QA slice of the PyTorch port held against the JAX package
on the CPU, float32, at tiny size (LayoutLM with 2 layers, hidden 128, 2
heads of 64; an 8-token question and a 120-token document, so s = 128; a
13-token vocabulary written by the test).

Weights: for ``DocSpanQA`` flax params drawn with numpy at unit scale at
flax's parameter shapes (flax's 0.02 draws leave the start and end logits
nearly flat, where the span decode would turn on float32 rounding), carried
across with ``jax_layoutlm_to_torch``; for the experiment the JAX
experiment's own ``init`` params carried the same way. Inputs are made with
numpy from a seed. Tolerances:

* ``_best_span`` and ``_subtoken_word_index``: exact (host numpy in both);
* ``DocSpanQA``: answers and word indices exact, span scores 1e-4 (a sum of
  two float32 log-probabilities of a 2-layer model whose outputs agree to
  ~1e-6), log-probabilities 1e-4 at real positions (the two routes agree at
  real positions only: ROADMAP, "Flash pad positions");
* ``DocVQASpanExperiment``: ``prepare_batch`` bitwise; logged losses and
  parameters after the steps 1e-4 (AdamW in torch and optax round the same
  update at other places; the parameters whose gradient is zero in exact
  arithmetic are left out), ``span_acc`` exact; flash against dense route
  gradients 1e-4.
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
from vltk_tpu.data.tokenizer import Tokenizer as JTok
from vltk_tpu.models import layoutlm as JL
from vltk_tpu import predict as JP

from vltk_tpu_torch import config as PC
from vltk_tpu_torch import predict as PP
from vltk_tpu_torch.data.tokenizer import Tokenizer
from vltk_tpu_torch.experiments import DocVQASpanExperiment, Experiments
from vltk_tpu_torch.models import lxmert as PX
from vltk_tpu_torch.models.convert import jax_layoutlm_to_torch
from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
from vltk_tpu_torch.ops.flash_attention import flash_self_attention

TINY = dict(
    vocab_size=64, hidden_size=128, num_heads=2, intermediate_size=256, l_layers=2,
    max_position_embeddings=128, hidden_dropout=0.0, attention_dropout=0.0,
)
Q_LEN, DOC_LEN = 8, 120
S = Q_LEN + DOC_LEN
B = 4
WORDS = ["what", "is", "the", "color", "cat", "cats", "on", "boxs", "zebra", "Box"]
QUESTIONS = ["what is the color", "cat", "what is on the box cats", "the"]


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def port_cfg(jcfg, **over):
    return dataclasses.replace(LayoutLMConfig(**dataclasses.asdict(jcfg)), **over)


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


def documents(rng, counts=(7, 150, 40, 1), sizes=((200, 300), None, (1200, 900), None)):
    """Pages of words from a tiny vocabulary with seeded boxes; the second
    is longer than the 119-sub-token budget."""
    docs = []
    for n_words, size in zip(counts, sizes):
        xy = rng.integers(0, 800, (n_words, 2))
        doc = {"words": list(rng.choice(WORDS, n_words)),
               "boxes": np.concatenate([xy, xy + rng.integers(1, 150, (n_words, 2))], axis=1).tolist()}
        if size:
            doc["size"] = size
        docs.append(doc)
    return docs


@pytest.fixture(scope="module")
def tiny_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
              "what", "is", "the", "color", "cat", "on", "box", "##s"]
    path.write_text("\n".join(tokens) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def predictors(tiny_vocab):
    """(JAX DocSpanQA, port DocSpanQA) at batch 2 with the same lively
    weights, and the port's answers to four pairs (the last bucket full,
    the first with three question lengths and a one-word page)."""
    jcfg = JL.LayoutLMConfig(**TINY)
    shapes = jax.eval_shape(lambda: JL.LayoutLMForSpanQA(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, S), np.int32), np.zeros((1, S, 4), np.int32)))
    params = lively(shapes["params"], np.random.default_rng(3))
    ref = JP.DocSpanQA(params=params, config=jcfg, batch_size=2, question_len=Q_LEN, doc_len=DOC_LEN,
                       tokenizer=JTok(name="NativeWordPiece", vocab_path=tiny_vocab, max_seq_length=Q_LEN))
    port = PP.DocSpanQA(params=jax_layoutlm_to_torch(params), config=port_cfg(jcfg), batch_size=2,
                        question_len=Q_LEN, doc_len=DOC_LEN, device="cpu",
                        tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=Q_LEN))
    docs = documents(np.random.default_rng(5))
    return ref, port, docs, port(docs, QUESTIONS)


# ------------------------------------------------------------ span decode


class TestSpanDecode:
    @pytest.mark.parametrize("case", ["rigged", "ties", "flat", "random", "empty", "max_span"])
    def test_best_span_matches_jax(self, case):
        rng = np.random.default_rng(11)
        s, e = rng.normal(size=(2, 60)).astype(np.float32)
        lo, hi, max_span = 5, 50, 32
        if case == "rigged":
            s[:] = e[:] = -5.0
            s[12], e[17] = 3.0, 2.0
        elif case == "ties":
            s[:] = e[:] = -1.0
            s[[20, 30]] = 2.0
            e[[22, 32]] = 2.0
        elif case == "flat":
            s[:] = e[:] = 0.0
        elif case == "empty":
            lo = hi = 9
        elif case == "max_span":
            s[:] = e[:] = -5.0
            s[10], e[45] = 9.0, 9.0  # out of reach at max_span 4
            s[30], e[31] = 5.0, 5.0
            max_span = 4
        want = JP._best_span(s, e, lo, hi, max_span)
        got = PP._best_span(s, e, lo, hi, max_span)
        assert got == want
        if case == "rigged":
            assert got[:2] == (12, 17)
        if case in ("ties", "flat"):
            assert got[:2] == ((20, 22) if case == "ties" else (lo, lo))
        if case == "max_span":
            assert got[:2] == (30, 31)

    @pytest.mark.parametrize("budget", [5, 40, 119])
    def test_subtoken_word_index_matches_jax(self, budget):
        rng = np.random.default_rng(budget)
        tokenmap = np.zeros(130, np.int32)
        tokenmap[:37] = rng.integers(1, 4, 37)
        want = JP._subtoken_word_index(tokenmap, budget)
        got = PP._subtoken_word_index(tokenmap, budget)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- predictor


class TestDocSpanQA:
    def test_matches_the_jax_predictor(self, predictors):
        """Four pairs at batch 2 (questions of 1-6 words, so the question's
        pad hole varies; a page cut at the budget; a one-word page)."""
        ref, _, docs, got = predictors
        want = ref(docs, QUESTIONS)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert (g["answer"], g["start_word"], g["end_word"]) == (w["answer"], w["start_word"], w["end_word"])
            np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-4)
        assert len({g["start_word"] for g in got}) > 1  # the answers are not all the page's first word

    def test_answers_are_spans_of_the_page(self, predictors):
        _, _, docs, got = predictors
        for doc, res in zip(docs, got):
            assert 0 <= res["start_word"] <= res["end_word"] < len(doc["words"])
            assert res["answer"] == " ".join(doc["words"][res["start_word"]:res["end_word"] + 1])
            assert np.isfinite(res["score"]) and res["score"] <= 0.0

    def test_log_probs_at_real_positions(self, predictors):
        """The step's float32 log-softmax against JAX's ``_step``, at real
        positions, on the dense route and on the flash route forced on the
        CPU (the plain version), which sees the question's pad hole."""
        ref, port, docs, _ = predictors
        (ids, boxes, mask), _, _, _ = port.prepare(docs[:2], QUESTIONS[:2])
        assert (mask[:, :Q_LEN] == 0).any() and mask[:, Q_LEN].all()  # a hole before the page
        want = ref._step(JP._doc_variables(ref), ids.astype(np.int32), boxes.astype(np.int32), mask)
        real = mask > 0
        for impl in ("xla", "flash"):
            model = PP.DocSpanQA(params=port.model.state_dict(), config=dataclasses.replace(port.config,
                                 attention_impl=impl), batch_size=2, question_len=Q_LEN, doc_len=DOC_LEN,
                                 device="cpu", tokenizer=port.tokenizer)
            with pytest.MonkeyPatch.context() as mp:
                if impl == "flash":
                    mp.setattr(PX, "_flash_applicable", lambda s, det, drop, dev: s >= 128 and (det or drop == 0.0))
                    calls = []
                    mp.setattr(PX, "flash_attention_auto", lambda *a: calls.append(1) or flash_self_attention(*a))
                got = model.step(t(ids), t(boxes), t(mask))
            if impl == "flash":
                assert len(calls) == TINY["l_layers"]
            for g, w in zip(got, want):
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy()[real], np.asarray(w)[real], rtol=0, atol=1e-4)

    def test_padded_bucket_rows_equal_full_bucket_rows(self, predictors):
        """A bucket of one real pair and one pad row gives that pair what a
        bucket of two real pairs gives it."""
        _, port, docs, got = predictors
        alone = port(docs[2:3], QUESTIONS[2:3])[0]
        assert alone == got[2]

    def test_guards(self, predictors, tiny_vocab):
        _, port, docs, _ = predictors
        tok = Tokenizer(vocab_path=tiny_vocab, max_seq_length=Q_LEN)
        kw = dict(question_len=Q_LEN, doc_len=DOC_LEN, device="cpu")
        with pytest.raises(ValueError, match="position table"):
            PP.DocSpanQA(config=dataclasses.replace(port.config, max_position_embeddings=64), tokenizer=tok, **kw)
        with pytest.raises(ValueError, match="vocab"):
            PP.DocSpanQA(config=dataclasses.replace(port.config, vocab_size=8), tokenizer=tok, **kw)
        with pytest.raises(ValueError, match="question_len"):
            PP.DocSpanQA(config=port.config, tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=9), **kw)
        with pytest.raises(ValueError, match="2 documents vs 1 questions"):
            port(docs[:2], QUESTIONS[:1])
        with pytest.raises(ValueError, match="words vs"):
            port([{"words": ["a", "b"], "boxes": [[0, 0, 1, 1]]}], ["what"])
        assert port([], []) == []
        assert dataclasses.replace(port.config, int8=True).int8  # the int8 preset builds
        # bundles (the round trip: tests/test_torch_aot.py): a program runs
        # on the device it was traced on, and a missing bundle is no bundle
        with pytest.raises(ValueError, match="platforms"):
            port.export_bundle("x.zip", platforms=("cpu", "tpu"))
        with pytest.raises(FileNotFoundError):
            PP.DocSpanQA.from_bundle("no_such_bundle.zip", device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                PP.DocSpanQA(config=port.config, tokenizer=tok, question_len=Q_LEN, doc_len=DOC_LEN)


class TestFromPretrained:
    def _kwargs(self, port, tiny_vocab):
        return dict(config=port.config, device="cpu", question_len=Q_LEN, doc_len=DOC_LEN,
                    tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=Q_LEN))

    def test_round_trip(self, predictors, tiny_vocab, tmp_path):
        """An HF-named state dict (with a pooler and the position-id buffer,
        which the port drops) loads by name, span head included."""
        _, port, _, _ = predictors
        want = port.model.state_dict()
        sd = dict(want)
        sd["layoutlm.pooler.dense.weight"] = torch.zeros(128, 128)
        sd["layoutlm.embeddings.position_ids"] = torch.arange(S)[None]
        path = str(tmp_path / "span.pt")
        torch.save(sd, path)
        got = PP.DocSpanQA.from_pretrained(path, **self._kwargs(port, tiny_vocab)).model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    @pytest.mark.parametrize("dropped", ["layoutlm.encoder.layer.1.", "qa_outputs."])
    def test_from_pretrained_partial_checkpoint(self, predictors, tiny_vocab, tmp_path, dropped):
        """A checkpoint without one layer's encoder weights raises and names
        a missing key; one without only the ``qa_outputs.*`` head loads,
        the head left as seeded."""
        _, port, _, _ = predictors
        full = port.model.state_dict()
        sd = {k: v for k, v in full.items() if not k.startswith(dropped)}
        assert len(sd) < len(full)
        path = str(tmp_path / "partial.pt")
        torch.save(sd, path)
        kwargs = self._kwargs(port, tiny_vocab)
        if dropped.startswith("layoutlm."):
            with pytest.raises(KeyError, match=r"lacks 16 encoder weights: layoutlm\.encoder\.layer\.1\."):
                PP.DocSpanQA.from_pretrained(path, **kwargs)
            return
        got = PP.DocSpanQA.from_pretrained(path, **kwargs).model.state_dict()
        seeded = PP.DocSpanQA(**kwargs).model.state_dict()
        for k, v in got.items():
            assert torch.equal(v, sd[k] if k in sd else seeded[k]), k


# ------------------------------------------------------------- experiment


def span_batches(rng, n_batches, q_lengths=(8, 3, 5, 1), ocr_lengths=(DOC_LEN, 90, 33, 7)):
    """Loader batches of the span experiment: question ids and mask, OCR
    ids (``vtext``), 0-1000 boxes, OCR mask, span labels in OCR positions
    (one row unanswerable)."""
    out = []
    for _ in range(n_batches):
        q_ids = rng.integers(5, TINY["vocab_size"], (B, Q_LEN)).astype(np.int32)
        q_mask = np.zeros((B, Q_LEN), np.int32)
        ocr_mask = np.zeros((B, DOC_LEN), np.int32)
        for i, (ql, ol) in enumerate(zip(q_lengths, ocr_lengths)):
            q_mask[i, :ql] = 1
            ocr_mask[i, :ol] = 1
        q_ids[q_mask == 0] = 0
        start = np.array([rng.integers(0, ol) for ol in ocr_lengths], np.int32)
        end = np.minimum(start + rng.integers(0, 4, B), np.array(ocr_lengths) - 1).astype(np.int32)
        start[3] = end[3] = -100
        out.append({
            "input_ids": q_ids, "text_attention_mask": q_mask,
            "vtext": rng.integers(0, TINY["vocab_size"], (B, DOC_LEN)).astype(np.int32),
            "tokenbox": np.sort(rng.integers(0, 1000, (B, DOC_LEN, 2, 2)), axis=2).reshape(B, DOC_LEN, 4)
            .astype(np.float32),
            "visual_attention_mask": ocr_mask, "span_start": start, "span_end": end,
            "imgid": np.array(["a", "b", "c", "d"], dtype=object),
        })
    return out


def jax_config(tmp, epochs=2):
    config = JC.Config()
    config.logdir = str(tmp)
    config.train.update({"epochs": epochs, "learning_rate": 5e-3})
    config.data.lang.update({"max_seq_length": Q_LEN, "max_visual_seq_length": DOC_LEN})
    return config


def port_config(tmp, epochs=2):
    config = PC.Config()
    config.logdir = str(tmp)
    config.train.update({"epochs": epochs, "learning_rate": 5e-3})
    config.data.lang.update({"max_seq_length": Q_LEN, "max_visual_seq_length": DOC_LEN})
    return config


def logged(exp):
    with open(os.path.join(exp.logdir, "steps_log.json")) as f:
        return [json.loads(line) for line in f]


def experiments(tmp_path, data, epochs=2, eval_data=None):
    """The JAX experiment and the port's, the port's built with the JAX
    experiment's initial weights."""
    from vltk_tpu.experiments.docvqa_span import DocVQASpanExperiment as JExp

    jcfg = JL.LayoutLMConfig(**TINY)

    class JTiny(JExp):
        model_config = jcfg

    jexp = JTiny(jax_config(tmp_path / "jax", epochs), loaders=(data, eval_data))
    init = jax_layoutlm_to_torch(jax.device_get(jexp.state.params))

    class PTiny(DocVQASpanExperiment):
        model_config = port_cfg(jcfg)

        def build_model(self):
            model = super().build_model()
            model.load_state_dict(init)
            return model

    return jexp, PTiny(port_config(tmp_path / "port", epochs), loaders=(data, eval_data), device="cpu")


class TestDocVQASpanExperiment:
    def test_prepare_batch_matches_jax(self, tmp_path):
        """Bitwise: the concatenated ids, the full-page question boxes, the
        mask with the question's pad hole, the shifted labels."""
        data = span_batches(np.random.default_rng(1), 1)
        jexp, pexp = experiments(tmp_path, data)
        want, got = jexp.prepare_batch(data[0]), pexp.prepare_batch(data[0])
        assert list(got) == list(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert got["span_start"][3] == -100 and (got["span_start"][:3] >= Q_LEN).all()
        assert (got["visual_attention_mask"][1, 3:Q_LEN] == 0).all() and got["visual_attention_mask"][1, Q_LEN] == 1
        assert pexp._seq_length() == S

    @pytest.mark.parametrize("n_batches", [1, 3])
    def test_train_steps_match_jax(self, tmp_path, n_batches):
        """An epoch of one step and of three: logged losses 1e-4, span_acc
        equal, parameters after the last step 1e-4."""
        data = span_batches(np.random.default_rng(2), n_batches)
        jexp, pexp = experiments(tmp_path, data, epochs=1)
        jexp(), pexp()
        jlog, plog = logged(jexp), logged(pexp)
        assert [r["step"] for r in plog] == [r["step"] for r in jlog] == list(range(1, n_batches + 1))
        np.testing.assert_allclose([r["loss"] for r in plog], [r["loss"] for r in jlog], rtol=1e-4, atol=1e-4)
        assert [r["span_acc"] for r in plog] == [r["span_acc"] for r in jlog]
        final = jax_layoutlm_to_torch(jax.device_get(jexp.state.params))
        state = pexp.model.state_dict()
        # left out: the parameters whose gradient is zero in exact
        # arithmetic, so rounding noise that AdamW scales to a full step of
        # either sign (a constant added to every position's logits, or to
        # every key's score, leaves a softmax unchanged)
        zero_grad = ("qa_outputs.bias", f"layoutlm.encoder.layer.{TINY['l_layers'] - 1}.output.LayerNorm.bias")
        for k, v in final.items():
            if k not in zero_grad and not k.endswith("attention.self.key.bias"):
                np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)

    def test_experiment_matches_jax(self, tmp_path):
        """Two epochs of three batches with an eval pass, end to end: the
        logged losses step by step 1e-4, span_acc and the eval's equal."""
        data = span_batches(np.random.default_rng(6), 3)
        jexp, pexp = experiments(tmp_path, data, epochs=2, eval_data=data[:1])
        want, got = jexp(), pexp()
        jlog, plog = logged(jexp), logged(pexp)
        assert [r["step"] for r in plog] == [r["step"] for r in jlog] == list(range(1, 7))
        np.testing.assert_allclose([r["loss"] for r in plog], [r["loss"] for r in jlog], rtol=1e-4, atol=1e-4)
        assert [r["span_acc"] for r in plog] == [r["span_acc"] for r in jlog]
        assert got["eval"]["span_acc"] == want["eval"]["span_acc"] and got["epoch"] == want["epoch"] == 1

    def test_forced_flash_route_gives_the_dense_gradients(self, tmp_path, monkeypatch):
        """The flash route forced on the CPU (the plain version, which
        autograd differentiates) against the dense route on a batch whose
        mask has the question's pad in mid-stream: parameter gradients
        within 1e-4 (the loss reads real positions only, and real queries
        never see pad keys on either route)."""
        data = span_batches(np.random.default_rng(3), 1)
        _, pexp = experiments(tmp_path, data)
        batch = {k: t(v) for k, v in pexp.prepare_batch(data[0]).items()}
        mask = batch["visual_attention_mask"]
        assert ((mask[:, :-1] == 0) & (mask[:, 1:] == 1)).any()  # pad followed by real tokens
        state = pexp.model.state_dict()
        grads = {}
        for impl in ("xla", "flash"):
            calls = []
            if impl == "flash":
                monkeypatch.setattr(PX, "_flash_applicable", lambda s, det, drop, dev: s >= 128 and (det or drop == 0.0))
                monkeypatch.setattr(PX, "flash_attention_auto", lambda *a: calls.append(1) or flash_self_attention(*a))
            model = type(pexp.model)(dataclasses.replace(pexp.model_config, attention_impl=impl))
            model.load_state_dict(state)
            model.train()
            loss, _ = pexp.loss_fn(model, batch)
            loss.backward()
            grads[impl] = {n: p.grad for n, p in model.named_parameters()}
            assert len(calls) == (TINY["l_layers"] if impl == "flash" else 0)
        for n, g in grads["flash"].items():
            np.testing.assert_allclose(g.numpy(), grads["xla"][n].numpy(), rtol=1e-4, atol=1e-4, err_msg=n)

    def test_guards(self, tmp_path):
        data = span_batches(np.random.default_rng(4), 1)
        config = port_config(tmp_path)
        config.data.lang.update({"max_seq_length": 64})

        class TooLong(DocVQASpanExperiment):
            model_config = LayoutLMConfig(**TINY)

        with pytest.raises(ValueError, match="max_position_embeddings"):
            TooLong(config, loaders=(data, None), device="cpu")

    def test_stream_longer_than_the_position_table_raises_at_construction(self, tmp_path):
        """As the JAX experiments, whose ``init`` at ``_seq_length()`` fails:
        the OCR experiment too (it used to build and fail at its first
        step)."""
        from vltk_tpu.experiments.ocr_tokens import OCRTokenExperiment as JOCR

        from vltk_tpu_torch.experiments import OCRTokenExperiment

        data = span_batches(np.random.default_rng(5), 1)

        class JTooLong(JOCR):
            model_config = JL.LayoutLMConfig(**TINY)

        class TooLong(OCRTokenExperiment):
            model_config = LayoutLMConfig(**TINY)

        jconfig, config = jax_config(tmp_path / "jax"), port_config(tmp_path / "port")
        jconfig.data.lang.update({"max_visual_seq_length": 200})
        config.data.lang.update({"max_visual_seq_length": 200})
        with pytest.raises(ValueError, match="max_position_embeddings"):
            JTooLong(jconfig, loaders=(data, None))
        with pytest.raises(ValueError, match="max_position_embeddings"):
            TooLong(config, loaders=(data, None), device="cpu")
        assert Experiments.get("DocVQA_span") is DocVQASpanExperiment
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TooLong(port_config(tmp_path), loaders=(data, None))

"""Serving bundles of the port (``vltk_tpu_torch/aot.py``, the predictors'
``export_bundle`` / ``from_bundle``) on the CPU, against the JAX package's
bundles (``vltk_tpu/aot.py``) from the same weights.

On the CPU the exported programs run the kernels' registered ops through
their CPU implementations (the plain versions). A loaded bundle answers
bitwise equal to the eager predictor it was exported from; against the JAX
bundle: VQA scores 1e-5, boxes and object ids (NMS's keeps) exact in count
and id; document labels equal, scores 1e-4; span answers and word indices
equal, scores 1e-4 (the tolerances of the eager comparisons in
``tests/test_torch_layoutlm.py`` and ``tests/test_torch_span.py``).
"""

import dataclasses
import json
import zipfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from tests.test_torch_span import QUESTIONS as SPAN_QUESTIONS
from tests.test_torch_span import predictors as span_predictors  # noqa: F401 - a fixture
from tests.test_torch_vqa import QUESTIONS as VQA_QUESTIONS
from tests.test_torch_vqa import predictors, tiny_vocab  # noqa: F401 - fixtures
from vltk_tpu_torch.aot import AotBundle, bundle_manifest, export_step, load_bundle, save_bundle


class _Affine(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(6, 4, generator=gen))

    def forward(self, x):
        return torch.tanh(x @ self.w) + 1.0


class TestAotCore:
    def test_roundtrip_numerics(self, tmp_path):
        """export -> file -> load -> call == the module's call, bitwise; the
        weights travel with the program."""
        model = _Affine()
        x = torch.randn(3, 6, generator=torch.Generator().manual_seed(1))
        path = str(tmp_path / "b.zip")
        save_bundle(path, {"fwd": export_step(model, (x,))}, meta={"kind": "t"}, files={"v": b"ab"})
        bundle = load_bundle(path)
        assert isinstance(bundle, AotBundle)
        assert bundle.meta == {"kind": "t"} and bundle.files["v"] == b"ab"
        assert bundle.platforms == {"fwd": ("cpu",)}
        with torch.no_grad():
            assert torch.equal(bundle["fwd"](x), model(x))
        with zipfile.ZipFile(path) as zf:
            assert sorted(zf.namelist()) == ["files/v", "fwd.pt2", "manifest.json"]

    def test_manifest_inspection(self, tmp_path):
        path = str(tmp_path / "b.zip")
        save_bundle(path, {"double": export_step(lambda x: x * 2, (torch.zeros(2),))}, meta={"n": 1})
        assert bundle_manifest(path) == {"format": 1, "meta": {"n": 1}, "artifacts": ["double"], "files": []}

    def test_wrong_format_refused(self, tmp_path):
        path = str(tmp_path / "b.zip")
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("manifest.json", json.dumps({"format": 99}))
        with pytest.raises(ValueError, match="format"):
            load_bundle(path)

    def test_shape_mismatch_raises(self, tmp_path):
        """The program pins the exported shapes: a batch of another
        geometry fails loudly, it is not padded."""
        path = str(tmp_path / "b.zip")
        save_bundle(path, {"f": export_step(lambda x: x + 1, (torch.zeros(4, 2),))})
        bundle = load_bundle(path)
        with pytest.raises(ValueError, match="shape"):
            bundle["f"](torch.zeros(3, 2))
        with pytest.raises(ValueError, match="dtype"):
            bundle["f"](torch.zeros(4, 2, dtype=torch.float64))

    def test_platforms_and_device_refusals(self, tmp_path):
        """JAX cross-lowers for several platforms; a torch program runs on
        the device it was traced on, so anything else raises, naming the
        argument."""
        x = torch.zeros(5)
        with pytest.raises(ValueError, match="platforms"):
            export_step(lambda t: t * t, (x,), platforms=("cpu", "tpu"))
        program = export_step(lambda t: t * t, (x,), platforms=("cpu",))
        path = str(tmp_path / "b.zip")
        save_bundle(path, {"f": program})
        with pytest.raises(ValueError, match="device='cuda'"):
            load_bundle(path, device="cuda")
        assert load_bundle(path, device="cpu")["f"](torch.arange(5.0)).tolist() == [0, 1, 4, 9, 16]


class TestRegisteredOps:
    """Each kernel's op: ``register_fake`` gives the shapes and dtypes of the
    CPU implementation's output, and the CPU implementation is the plain
    version."""

    def _fake(self, op, *args):
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode() as mode:
            fake = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
            out = op(*fake)
        return out if isinstance(out, tuple) else (out,)

    def _same_meta(self, fake, real):
        real = real if isinstance(real, tuple) else (real,)
        assert [(tuple(t.shape), t.dtype) for t in fake] == [(tuple(t.shape), t.dtype) for t in real]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_roi_pool(self, dtype):
        from vltk_tpu_torch.ops.roi_pool import roi_pool_offsets

        gen = torch.Generator().manual_seed(2)
        feat = torch.randn(2, 6, 7, 5, generator=gen).to(dtype)
        boxes = torch.tensor([[[0.0, 0.0, 90.0, 80.0], [10.0, 5.0, 40.0, 60.0], [3.0, 3.0, 3.0, 3.0]]] * 2)
        real = torch.ops.vltk_tpu_torch.roi_pool(feat, boxes, 14, 1 / 16)
        assert real.shape == (2, 3, 14, 14, 5)
        assert torch.equal(real, roi_pool_offsets(feat, boxes, 14, 1 / 16))
        self._same_meta(self._fake(torch.ops.vltk_tpu_torch.roi_pool, feat, boxes, 14, 1 / 16), real)

    @pytest.mark.parametrize("per_row", [False, True])
    @pytest.mark.parametrize("single", [False, True])
    def test_nms(self, per_row, single):
        from vltk_tpu_torch.ops.nms import nms_fixed

        gen = torch.Generator().manual_seed(3)
        xy = torch.rand(3, 40, 2, generator=gen) * 50
        boxes = torch.cat([xy, xy + 5 + torch.rand(3, 40, 2, generator=gen) * 20], -1)
        scores = torch.rand(3, 40, generator=gen)
        valid = torch.rand(3, 40, generator=gen) > 0.1
        thr = torch.tensor([0.3, 0.5, 0.7]) if per_row else None
        if single:
            boxes, scores, valid, thr = boxes[0], scores[0], valid[0], (thr[:1] if per_row else None)
        args = (boxes, scores, thr, 0.5, 9, valid)
        real = torch.ops.vltk_tpu_torch.nms_fixed(*args)
        want = nms_fixed(boxes, scores, thr if per_row else 0.5, 9, valid)
        assert torch.equal(real[0], want[0]) and torch.equal(real[1], want[1])
        assert real[0].shape == ((9,) if single else (3, 9)) and (real[0] >= 0).any()
        self._same_meta(self._fake(torch.ops.vltk_tpu_torch.nms_fixed, *args), real)

    @pytest.mark.parametrize("masked", [False, True])
    def test_flash_attention(self, masked):
        from vltk_tpu_torch.ops.flash_attention import flash_self_attention, flash_self_attention_fwd_residuals

        gen = torch.Generator().manual_seed(4)
        q, k, v = (torch.randn(2, 100, 3, 64, generator=gen) for _ in range(3))
        mask = None
        if masked:
            mask = torch.ones(2, 100)
            mask[1, 60:] = 0
        real = torch.ops.vltk_tpu_torch.flash_attention(q, k, v, mask, 64)
        assert torch.equal(real, flash_self_attention(q, k, v, mask, 64))
        self._same_meta(self._fake(torch.ops.vltk_tpu_torch.flash_attention, q, k, v, mask, 64), real)
        o, m, l = torch.ops.vltk_tpu_torch.flash_attention_residuals(q, k, v, mask, 64)  # noqa: E741
        want_o, (want_m, want_l) = flash_self_attention_fwd_residuals(q, k, v, mask, 64)
        assert torch.equal(o, want_o) and torch.equal(m, want_m) and torch.equal(l, want_l)
        assert m.shape == l.shape == (2, 3, 100) and m.dtype == torch.float32
        self._same_meta(self._fake(torch.ops.vltk_tpu_torch.flash_attention_residuals, q, k, v, mask, 64),
                        (o, m, l))

    def test_autograd_paths_keep_their_functions(self):
        """With a gradient the eager paths stay on the autograd Functions
        (K1 + K10, the plain flash on the CPU); the ops serve inference."""
        from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_auto
        from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_auto

        feat = torch.randn(1, 6, 7, 4, requires_grad=True)
        pooled = roi_pool_auto(feat, torch.tensor([[[0.0, 0.0, 90.0, 80.0]]]))
        assert "RoIPool" in type(pooled.grad_fn).__name__
        q = torch.randn(1, 8, 1, 64, requires_grad=True)
        flash_attention_auto(q, q, q, None, 64).sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()


def _same_vqa(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["topk"] == w["topk"] and g["num_boxes"] == w["num_boxes"]
        for key in ("boxes", "objects", "object_probs"):
            np.testing.assert_array_equal(g[key], w[key])


@pytest.fixture(scope="module")
def vqa_bundle(predictors, tmp_path_factory):  # noqa: F811
    """The port's tiny VQA predictor, exported once."""
    path = str(tmp_path_factory.mktemp("bundles") / "vqa.zip")
    predictors[1].export_bundle(path)
    return path


class TestVQABundle:
    def test_round_trip_is_bitwise_and_matches_the_jax_bundle(self, predictors, vqa_bundle, tmp_path):  # noqa: F811
        from vltk_tpu.predict import VQAPredictor as JVQA

        from vltk_tpu_torch.predict import VQAPredictor

        ref, port, images, _, got = predictors
        path = vqa_bundle
        meta = bundle_manifest(path)["meta"]
        assert meta["kind"] == "vqa_predictor" and meta["batch_size"] == port.batch_size
        assert meta["answers"] == port.answers and meta["raw_canvas"] == list(port.raw_canvas)
        bundled = VQAPredictor.from_bundle(path, device="cpu")
        assert bundled.frcnn is None and bundled.lxmert is None
        mine = bundled(images, VQA_QUESTIONS, top_k=3)
        _same_vqa(mine, got)

        jpath = str(tmp_path / "vqa_jax.zip")
        ref.export_bundle(jpath)
        want = JVQA.from_bundle(jpath)(images, VQA_QUESTIONS, top_k=3)
        sides = [64, 64, 128]
        for i, (g, w) in enumerate(zip(mine, want)):
            assert [a for a, _ in g["topk"]] == [a for a, _ in w["topk"]], i
            np.testing.assert_allclose([s for _, s in g["topk"]], [s for _, s in w["topk"]], rtol=0, atol=1e-5)
            assert g["num_boxes"] == w["num_boxes"], i
            np.testing.assert_array_equal(g["objects"], np.asarray(w["objects"]))
            np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-4 * sides[i], err_msg=str(i))

    def test_refusals(self, predictors, vqa_bundle, tmp_path):  # noqa: F811
        from vltk_tpu_torch.predict import DocSpanQA, VQAPredictor

        _, port, _, _, _ = predictors
        path = vqa_bundle
        with pytest.raises(ValueError, match="not a doc_span_qa export"):
            DocSpanQA.from_bundle(path, device="cpu")
        with pytest.raises(ValueError, match="platforms"):
            port.export_bundle(str(tmp_path / "x.zip"), platforms=("cpu", "tpu"))
        bundled = VQAPredictor.from_bundle(path, device="cpu")
        b, (ch, cw), seq = port.batch_size, port.raw_canvas, port.tokenizer.max_seq_length
        with pytest.raises(ValueError, match="shape"):
            bundled.step(torch.zeros((b + 1, ch, cw, 3), dtype=torch.uint8), torch.zeros((b + 1, 2)),
                         torch.zeros((b + 1, seq), dtype=torch.int32), torch.zeros((b + 1, seq)))


DOC_LABELS = ["other", "question", "answer", "header"]
DOC_WORDS = ["what", "is", "the", "color", "cat", "cats", "on", "boxs", "zebra", "Box"]


def _documents(rng):
    docs = []
    for n_words, size in ((7, (200, 300)), (150, None), (40, (1200, 900))):
        words = list(rng.choice(DOC_WORDS, n_words))
        xy = rng.integers(0, 800, (n_words, 2))
        boxes = np.concatenate([xy, xy + rng.integers(1, 150, (n_words, 2))], axis=1)
        doc = {"words": [str(w) for w in words], "boxes": boxes.tolist()}
        if size:
            doc["size"] = size
        docs.append(doc)
    return docs


class TestDocumentBundles:
    def test_doc_round_trip_is_bitwise_and_matches_the_jax_bundle(self, tiny_vocab, tmp_path):  # noqa: F811
        from vltk_tpu.data.tokenizer import Tokenizer as JTok
        from vltk_tpu.models import layoutlm as JL
        from vltk_tpu.predict import DocTokenClassifier as JClf

        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.models.convert import jax_layoutlm_to_torch
        from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
        from vltk_tpu_torch.predict import DocTokenClassifier

        jcfg = JL.LayoutLMConfig(vocab_size=64, hidden_size=32, num_heads=2, intermediate_size=64, l_layers=2,
                                 max_position_embeddings=128)
        ref = JClf(DOC_LABELS, config=jcfg, batch_size=2, max_seq_length=128,
                   tokenizer=JTok(name="NativeWordPiece", vocab_path=tiny_vocab, max_seq_length=128))
        port = DocTokenClassifier(
            DOC_LABELS, params=jax_layoutlm_to_torch(ref.params), config=LayoutLMConfig(**dataclasses.asdict(jcfg)),
            batch_size=2, max_seq_length=128, device="cpu",
            tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=128),
        )
        docs = _documents(np.random.default_rng(5))
        path, jpath = str(tmp_path / "doc.zip"), str(tmp_path / "doc_jax.zip")
        port.export_bundle(path)
        ref.export_bundle(jpath)
        bundled = DocTokenClassifier.from_bundle(path, device="cpu")
        assert bundled.model is None and bundled.labels == DOC_LABELS
        mine = bundled(docs)
        assert mine == port(docs)
        want = JClf.from_bundle(jpath)(docs)
        assert [len(d) for d in mine] == [len(d) for d in want] and len(mine[1]) < 150
        for gd, wd in zip(mine, want):
            assert [(r["word"], r["label"]) for r in gd] == [(r["word"], r["label"]) for r in wd]
            np.testing.assert_allclose([r["score"] for r in gd], [r["score"] for r in wd], rtol=0, atol=1e-4)

    def test_span_round_trip_is_bitwise_and_matches_the_jax_bundle(self, span_predictors, tmp_path):  # noqa: F811
        from vltk_tpu.predict import DocSpanQA as JSpan

        from vltk_tpu_torch.predict import DocSpanQA

        ref, port, docs, got = span_predictors
        path, jpath = str(tmp_path / "span.zip"), str(tmp_path / "span_jax.zip")
        port.export_bundle(path)
        ref.export_bundle(jpath)
        meta = bundle_manifest(path)["meta"]
        assert (meta["question_len"], meta["doc_len"], meta["max_span"]) == (port.q_len, port.doc_len, port.max_span)
        mine = DocSpanQA.from_bundle(path, device="cpu")(docs, SPAN_QUESTIONS)
        assert mine == got
        want = JSpan.from_bundle(jpath)(docs, SPAN_QUESTIONS)
        for g, w in zip(mine, want):
            assert (g["answer"], g["start_word"], g["end_word"]) == (w["answer"], w["start_word"], w["end_word"])
            np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-4)

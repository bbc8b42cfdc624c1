"""The document slice of the PyTorch port held against the JAX package on
the CPU, float32, at tiny size (2 layers, hidden 128, 2 heads of 64).

Weights are the JAX package's flax ``init`` params carried across with
``jax_layoutlm_to_torch``; inputs are made with numpy from a seed and fed
to both packages. Tolerances:

* the plain flash version against ``_flash_self_attention`` run in Pallas
  interpret mode: 2e-5 at every position (float32 sums in another order);
* modules and the model: rtol/atol 1e-4. Flax's LayerNorm takes the
  variance as E[x^2] - E[x]^2 and torch's as E[(x - E[x])^2]; on these
  activations (|mean| / std < 1) that moves outputs by ~1e-6, inside it.

Each trouble spot of the slice has its test: the pad semantics of the two
attention routes, the scale and precision of the dense route, flax's mixed
precision, the LayoutLM embedding clips and table guard, and
``_flash_self_attention`` with ``mask=None``.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import flax.traverse_util as tu

from vltk_tpu.models import layoutlm as JL
from vltk_tpu.models import lxmert as JX
from vltk_tpu.models.convert import torch_layoutlm_to_jax

import vltk_tpu_torch
from vltk_tpu_torch.models import lxmert as PX
from vltk_tpu_torch.models.convert import jax_layoutlm_to_torch
from vltk_tpu_torch.models.layoutlm import (
    LayoutLM,
    LayoutLMConfig,
    LayoutLMEmbeddings,
    LayoutLMForSpanQA,
    LayoutLMForTokenClassification,
)
from vltk_tpu_torch.ops.flash_attention import flash_self_attention

RTOL = ATOL = 1e-4
TINY = dict(
    vocab_size=100, hidden_size=128, num_heads=2, intermediate_size=256,
    l_layers=2, max_position_embeddings=256,
)
S = 256
DOC_LABELS = ["other", "question", "answer", "header"]


def t(a):
    return torch.from_numpy(np.asarray(a))


def sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def port_cfg(jcfg, **over):
    return dataclasses.replace(LayoutLMConfig(**dataclasses.asdict(jcfg)), **over)


def doc_inputs(rng, n=2, s=S, lengths=(S, 200)):
    ids = rng.integers(0, TINY["vocab_size"], (n, s)).astype(np.int32)
    boxes = np.sort(rng.integers(0, 1000, (n, s, 2, 2)), axis=2).reshape(n, s, 4).astype(np.int32)
    mask = np.zeros((n, s), np.float32)
    for i, length in enumerate(lengths[:n]):
        mask[i, :length] = 1.0
    return ids, boxes, mask


@pytest.fixture(scope="module")
def jax_model():
    jcfg = JL.LayoutLMConfig(**TINY)
    model = JL.LayoutLMForTokenClassification(jcfg)
    rng = np.random.default_rng(1)
    ids, boxes, _ = doc_inputs(rng, n=1)
    params = model.init(jax.random.PRNGKey(0), ids, boxes)["params"]
    return jcfg, model, params


@pytest.fixture(scope="module")
def port_sd(jax_model):
    return jax_layoutlm_to_torch(jax_model[2])


def hidden(rng, n=2, s=S, h=128):
    return rng.normal(size=(n, s, h)).astype(np.float32)


# ----------------------------------------------------- flash: plain vs Pallas


class TestFlashPlainVersion:
    @staticmethod
    def _qkv(rng, s, pad):
        """q, k, v (2, s, 2, 64) and a mask: row 1 with a pad tail of
        ``pad`` positions; or, whole 64-row blocks of one id, "alternating"
        (64 real, 64 pad, ... in row 0, the reverse in row 1) or
        "real-pad-real" (positions 64-191 pad in both rows); or, for a list
        of (start, stop) spans, row 1 real on those spans only."""
        q, k, v = (rng.normal(size=(2, s, 2, 64)).astype(np.float32) for _ in range(3))
        mask = np.ones((2, s), np.float32)
        if pad == "alternating":
            block = (np.arange(s) // 64) % 2
            mask[0], mask[1] = 1 - block, block
        elif pad == "real-pad-real":
            mask[:, 64:192] = 0.0
        elif isinstance(pad, list):
            mask[1] = 0.0
            for start, stop in pad:
                mask[1, start:stop] = 1.0
        elif pad:
            mask[1, s - pad:] = 0.0
        return q, k, v, mask

    @pytest.mark.parametrize("s,pad,use_mask", [
        (128, 40, True), (197, 13, True), (197, 0, False),
        (256, "alternating", True), (256, "real-pad-real", True), (384, [(0, 96), (160, 384)], True),
        (256, [(0, 128)], True),
    ])
    def test_matches_pallas_interpret_at_every_position(self, rng, s, pad, use_mask):
        """s = 128 with a padded tail, s = 197 (padded to 256 inside), and
        ``mask=None`` at s = 197, where an all-ones mask is synthesised
        before padding so real queries never see the zero tail; then masks
        of 64-row blocks of one id (alternating, real-pad-real), spans off
        the 128 boundaries at s = 384, and a row real on [0, 128) only. The
        card's kernel skips a key tile that no query of its 128-row block
        shares an id with: in the last case, block 0 of row 1 reads its own
        two tiles and block 1 the other two; in the others every key tile
        meets every block."""
        import jax.experimental.pallas.tpu as pltpu

        q, k, v, mask = self._qkv(rng, s, pad)
        m = mask if use_mask else None
        with pltpu.force_tpu_interpret_mode():
            want = JX._flash_self_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                None if m is None else jnp.asarray(m), 64,
            )
        got = flash_self_attention(t(q), t(k), t(v), None if m is None else t(m), 64)
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)

    def test_pad_queries_see_only_pad_keys(self, rng):
        """Segment ids confine a pad query to the pad keys (the zero keys of
        the 128 tail included): its output is the mean of the pad values."""
        q, k, v, mask = self._qkv(rng, 100, 30)  # real 70, padded to 128
        got = flash_self_attention(t(q), t(k), t(v), t(mask), 64).numpy()
        sm = 1 / 8.0
        qi = q[1, 80, 0]
        keys = np.concatenate([k[1, 70:, 0], np.zeros((28, 64), np.float32)])
        vals = np.concatenate([v[1, 70:, 0], np.zeros((28, 64), np.float32)])
        w = np.exp(keys @ qi * sm - (keys @ qi * sm).max())
        np.testing.assert_allclose(got[1, 80, 0], (w / w.sum()) @ vals, atol=2e-5)


# ------------------------------------------------------- modules vs flax


class TestModules:
    def test_config_field_set_matches_jax(self):
        for port, ref in ((PX.LxmertConfig, JX.LxmertConfig), (LayoutLMConfig, JL.LayoutLMConfig)):
            assert {f.name for f in dataclasses.fields(port)} == {f.name for f in dataclasses.fields(ref)}
        assert dataclasses.asdict(LayoutLMConfig()) == dataclasses.asdict(JL.LayoutLMConfig())
        for flag in ("activation_sharding", "seq_attention_sharding"):
            assert getattr(LayoutLMConfig(**{flag: True}), flag)  # ported: sequence parallelism under a mesh
        assert LayoutLMConfig(remat=True).remat  # ported: checkpointed encoder layers
        assert LayoutLMConfig(int8=True).int8  # ported: the int8 serving preset
        assert LayoutLMConfig(moe_experts=4).moe_experts == 4  # ported: the MoE feed-forward

    def test_embeddings_with_clipped_boxes(self, jax_model, port_sd, rng):
        """Coordinates clipped to [0, 1023], h and w clipped after the
        subtraction (x1 < x0 gives w = 0), x and y tables shared by both
        corners, everything summed before the LayerNorm."""
        jcfg, _, params = jax_model
        ids, boxes, _ = doc_inputs(rng)
        boxes[0, :5] = [[-20, 5, 2000, 7], [900, 900, 100, 50], [0, 0, 0, 0],
                        [1023, 1023, 1024, 5000], [10, -3, -8, 1100]]
        want = JL.LayoutLMEmbeddings(jcfg).apply(
            {"params": params["layoutlm"]["embeddings"]}, ids, boxes
        )
        mod = LayoutLMEmbeddings(port_cfg(jcfg)).eval()
        mod.load_state_dict(sub(port_sd, "layoutlm.embeddings."))
        got = mod(t(ids), t(boxes))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    def test_embeddings_refuse_a_length_past_the_table(self, jax_model):
        mod = LayoutLMEmbeddings(port_cfg(jax_model[0], max_position_embeddings=8))
        with pytest.raises(ValueError, match="max_position_embeddings"):
            mod(torch.zeros(1, 9, dtype=torch.int64), torch.zeros(1, 9, 4, dtype=torch.int64))

    def test_dense_attention(self, jax_model, port_sd, rng):
        jcfg, _, params = jax_model
        x = hidden(rng)
        _, _, mask = doc_inputs(rng)
        want = JX.MultiHeadAttention(jcfg).apply(
            {"params": params["layoutlm"]["layer_0"]["att"]}, x, x, mask
        )
        mod = PX.MultiHeadAttention(port_cfg(jcfg)).eval()
        mod.load_state_dict(sub(port_sd, "layoutlm.encoder.layer.0.attention."))
        xt = t(x)
        got = mod(xt, xt, t(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    def test_dense_attention_bf16_scale_and_precision(self, jax_model, port_sd, rng):
        """bf16 compute: projections in bf16, the bf16 scores divided by
        sqrt(dh) in bf16 plus the -10000 bias cast to bf16, softmax in f32,
        probabilities cast back to bf16; LayerNorm in f32 returns f32.
        XLA and torch may round the bf16 products at other places (flax
        adds the bias after rounding the product): the f32 LayerNorm
        outputs (unit scale) agree to 6e-5 on this input, and 2e-3 leaves
        room for a one-ulp bf16 flip upstream."""
        jcfg, _, params = jax_model
        jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
        x = hidden(rng)
        _, _, mask = doc_inputs(rng)
        want = JX.MultiHeadAttention(jcfg).apply(
            {"params": params["layoutlm"]["layer_0"]["att"]}, x, x, mask
        )
        mod = PX.MultiHeadAttention(port_cfg(jcfg)).eval()
        mod.load_state_dict(sub(port_sd, "layoutlm.encoder.layer.0.attention."))
        xt = t(x)
        got = mod(xt, xt, t(mask))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-3)

    def test_feed_forward(self, jax_model, port_sd, rng):
        jcfg, _, params = jax_model
        x = hidden(rng)
        want = JX.FeedForward(jcfg).apply({"params": params["layoutlm"]["layer_0"]["ffn"]}, x)
        mod = PX.FeedForward(port_cfg(jcfg)).eval()
        mod.load_state_dict(
            {k: v for k, v in sub(port_sd, "layoutlm.encoder.layer.0.").items()
             if k.startswith(("intermediate.", "output."))}
        )
        got = mod(t(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    def test_transformer_layer(self, jax_model, port_sd, rng):
        jcfg, _, params = jax_model
        x = hidden(rng)
        _, _, mask = doc_inputs(rng)
        want = JX.TransformerLayer(jcfg).apply({"params": params["layoutlm"]["layer_1"]}, x, mask)
        mod = PX.TransformerLayer(port_cfg(jcfg)).eval()
        mod.load_state_dict(sub(port_sd, "layoutlm.encoder.layer.1."))
        got = mod(t(x), t(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------- the whole model


class TestModel:
    def test_token_classification_dense_route(self, jax_model, port_sd, rng):
        jcfg, model, params = jax_model
        ids, boxes, mask = doc_inputs(rng)
        want = model.apply({"params": params}, ids, boxes, mask)
        port = LayoutLMForTokenClassification(port_cfg(jcfg)).eval()
        port.load_state_dict(port_sd)
        got = port(t(ids), t(boxes), t(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    def test_flash_route_matches_dense_at_real_positions_only(self, jax_model, port_sd, rng, monkeypatch):
        """The port's gate forced on (the plain flash version runs on the
        CPU, every layer) against JAX's dense model: equal at real
        positions, different at pad positions (segment ids keep a pad query
        from the real keys; the dense route's -10000 bias does not)."""
        jcfg, model, params = jax_model
        calls = []

        def counted(*args):
            calls.append(args[0].shape)
            return flash_self_attention(*args)

        monkeypatch.setattr(PX, "_flash_applicable", lambda s, det, drop, dev: s >= 128 and det)
        monkeypatch.setattr(PX, "flash_attention_auto", counted)
        ids, boxes, mask = doc_inputs(rng)
        want = np.asarray(model.apply({"params": params}, ids, boxes, mask))
        port = LayoutLMForTokenClassification(port_cfg(jcfg, attention_impl="flash")).eval()
        port.load_state_dict(port_sd)
        got = port(t(ids), t(boxes), t(mask)).detach().numpy()
        assert len(calls) == jcfg.l_layers
        real = mask.astype(bool)
        np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)
        assert np.abs(got[~real] - want[~real]).max() > 1e-3

    def test_gate_takes_dense_route_on_the_cpu(self, jax_model, port_sd, monkeypatch):
        """"auto" at padded length >= 1024 wants flash, but off CUDA the
        gate sends it to the dense route, as JAX's does off the TPU."""
        cfg = port_cfg(jax_model[0])
        assert cfg.attention_impl == "auto"
        assert PX._impl_wants_flash(cfg, 1000) and not PX._impl_wants_flash(cfg, 896)
        assert not PX._flash_applicable(1024, True, 0.1, torch.device("cpu"))
        assert PX._flash_applicable(1024, True, 0.1, torch.device("cuda"))
        assert not PX._flash_applicable(1024, False, 0.1, torch.device("cuda"))
        assert not PX._flash_applicable(127, True, 0.1, torch.device("cuda"))

    def test_span_qa_head(self, jax_model, rng):
        jcfg = jax_model[0]
        model = JL.LayoutLMForSpanQA(jcfg)
        ids, boxes, mask = doc_inputs(rng)
        params = model.init(jax.random.PRNGKey(3), ids[:1], boxes[:1])["params"]
        want = model.apply({"params": params}, ids, boxes, mask)
        port = LayoutLMForSpanQA(port_cfg(jcfg)).eval()
        port.load_state_dict(jax_layoutlm_to_torch(params))
        got = port(t(ids), t(boxes), t(mask))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)

    def test_converter_round_trip_is_exact(self, jax_model, port_sd):
        params = jax_model[2]
        back = torch_layoutlm_to_jax({k: v.numpy() for k, v in port_sd.items()})
        a = tu.flatten_dict(params["layoutlm"], sep="/")
        b = tu.flatten_dict(back, sep="/")
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
        np.testing.assert_array_equal(port_sd["classifier.weight"].numpy(),
                                      np.asarray(params["classifier"]["kernel"]).T)
        np.testing.assert_array_equal(port_sd["classifier.bias"].numpy(),
                                      np.asarray(params["classifier"]["bias"]))
        bare = jax_layoutlm_to_torch(params["layoutlm"])
        assert set(LayoutLM(LayoutLMConfig(**TINY)).state_dict()) == set(bare)


# ------------------------------------------------- tokenizer and predictor


@pytest.fixture(scope="module")
def tiny_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
              "what", "is", "the", "color", "cat", "on", "box", "##s"]
    path.write_text("\n".join(tokens) + "\n")
    return str(path)


class TestHostChain:
    def test_wordpiece_ids_match_the_jax_package(self):
        from vltk_tpu.data.tokenizer import Tokenizer as JTok

        from vltk_tpu_torch.data.tokenizer import Tokenizer

        words = ["Hello", "world!", "unaffable", "DocVQA", "naïve", "", "x" * 120,
                 "3.14", "form-field", "日本", "INVOICE#42", "co-operation"]
        ref, port = JTok(name="NativeWordPiece"), Tokenizer(name="NativeWordPiece")
        assert port.encode_words(words) == ref.encode_words(words)
        ids = ("cls_id", "sep_id", "pad_id", "mask_id", "unk_id", "vocab_size")
        assert [getattr(port, a) for a in ids] == [getattr(ref, a) for a in ids]
        assert port.vocab_size == 30522

    def test_other_backends_raise(self):
        from vltk_tpu_torch.data.tokenizer import Tokenizer

        with pytest.raises(NotImplementedError):
            Tokenizer(name="BertWordPieceTokenizer")
        with pytest.raises(NotImplementedError):
            Tokenizer(name="BertTokenizerFast", from_transformers=True)

    def test_doc_token_classifier_matches_the_jax_package(self, tiny_vocab):
        from vltk_tpu.data.tokenizer import Tokenizer as JTok
        from vltk_tpu.predict import DocTokenClassifier as JClf

        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.predict import DocTokenClassifier

        jcfg = JL.LayoutLMConfig(**dict(TINY, vocab_size=64, max_position_embeddings=128))
        ref = JClf(DOC_LABELS, config=jcfg, batch_size=2, max_seq_length=128,
                   tokenizer=JTok(name="NativeWordPiece", vocab_path=tiny_vocab, max_seq_length=128))
        port = DocTokenClassifier(
            DOC_LABELS, params=jax_layoutlm_to_torch(ref.params), config=port_cfg(ref.config),
            batch_size=2, max_seq_length=128, device="cpu",
            tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=128),
        )
        rng = np.random.default_rng(5)
        vocab_words = ["what", "is", "the", "color", "cat", "cats", "on", "boxs", "zebra", "Box"]
        docs = []
        for n_words, size in ((7, (200, 300)), (150, None), (40, (1200, 900))):
            words = list(rng.choice(vocab_words, n_words))
            xy = rng.integers(0, 800, (n_words, 2))
            boxes = np.concatenate([xy, xy + rng.integers(1, 150, (n_words, 2))], axis=1)
            doc = {"words": words, "boxes": boxes.tolist()}
            if size:
                doc["size"] = size
            docs.append(doc)
        want, got = ref(docs), port(docs)
        assert [len(d) for d in got] == [len(d) for d in want]
        assert len(got[1]) < 150  # truncated at the 127-sub-token budget
        for gd, wd in zip(got, want):
            assert [r["word"] for r in gd] == [r["word"] for r in wd]
            assert [r["label"] for r in gd] == [r["label"] for r in wd]
            np.testing.assert_allclose([r["score"] for r in gd], [r["score"] for r in wd], rtol=0, atol=1e-4)
        assert port([]) == []
        with pytest.raises(ValueError):
            port([{"words": ["a", "b"], "boxes": [[0, 0, 1, 1]]}])

    def test_predictor_guards(self, tiny_vocab, jax_model, port_sd):
        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.predict import DocTokenClassifier

        tok = Tokenizer(vocab_path=tiny_vocab, max_seq_length=16)
        with pytest.raises(ValueError, match="position"):
            DocTokenClassifier(DOC_LABELS, config=LayoutLMConfig(vocab_size=64, max_position_embeddings=8),
                               tokenizer=tok, max_seq_length=16, device="cpu")
        with pytest.raises(ValueError, match="head"):
            DocTokenClassifier(DOC_LABELS[:3], params=port_sd, config=port_cfg(jax_model[0]),
                               tokenizer=tok, max_seq_length=16, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                DocTokenClassifier(DOC_LABELS, tokenizer=tok, max_seq_length=16)
        clf = DocTokenClassifier(DOC_LABELS, config=port_cfg(jax_model[0]), tokenizer=tok,
                                 max_seq_length=16, device="cpu")
        with pytest.raises(ValueError, match="platforms"):  # the round trip: tests/test_torch_aot.py
            clf.export_bundle("x.zip", platforms=("tpu",))

    def test_from_pretrained_loads_hf_names(self, tiny_vocab, jax_model, port_sd, tmp_path):
        """An HF-named state dict (with a pooler and the position-id buffer,
        which the port drops) loads by name, head included."""
        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.predict import DocTokenClassifier

        sd = dict(port_sd)
        sd["layoutlm.pooler.dense.weight"] = torch.zeros(128, 128)
        sd["layoutlm.embeddings.position_ids"] = torch.arange(256)[None]
        path = str(tmp_path / "layoutlm.pt")
        torch.save(sd, path)
        clf = DocTokenClassifier.from_pretrained(
            path, DOC_LABELS, config=port_cfg(jax_model[0]), device="cpu",
            tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=16), max_seq_length=16,
        )
        got = clf.model.state_dict()
        for k, v in port_sd.items():
            assert torch.equal(got[k], v), k

    @pytest.mark.parametrize("dropped", ["layoutlm.encoder.layer.1.", "classifier."])
    def test_from_pretrained_partial_checkpoint(self, tiny_vocab, jax_model, port_sd, tmp_path, dropped):
        """A checkpoint without one layer's encoder weights raises and names
        a missing key (JAX fails on the missing parameter); one without
        only the ``classifier.*`` head loads, the head left as seeded."""
        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.predict import DocTokenClassifier

        sd = {k: v for k, v in port_sd.items() if not k.startswith(dropped)}
        assert len(sd) < len(port_sd)
        path = str(tmp_path / "partial.pt")
        torch.save(sd, path)
        kwargs = dict(config=port_cfg(jax_model[0]), device="cpu", max_seq_length=16,
                      tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=16))
        if dropped.startswith("layoutlm."):
            with pytest.raises(KeyError, match=r"lacks 16 encoder weights: layoutlm\.encoder\.layer\.1\."):
                DocTokenClassifier.from_pretrained(path, DOC_LABELS, **kwargs)
            return
        clf = DocTokenClassifier.from_pretrained(path, DOC_LABELS, **kwargs)
        seeded = DocTokenClassifier(DOC_LABELS, **kwargs).model.state_dict()
        got = clf.model.state_dict()
        for k, v in got.items():
            assert torch.equal(v, sd[k] if k in sd else seeded[k]), k


# --------------------------------------------------------------- guards


def test_no_port_source_names_a_path_inside_the_jax_package():
    """The vocabulary and the C++ source the port reads are its own copies,
    and no string in its code (docstrings aside) names a path in
    ``vltk_tpu/``."""
    from vltk_tpu_torch import native, vars as V

    pkg = os.path.dirname(os.path.abspath(vltk_tpu_torch.__file__))
    assert os.path.dirname(V.VOCABPATH).startswith(pkg) and os.path.exists(V.VOCABPATH)
    assert native._SRC_DIR.startswith(pkg) and native._SOURCES == ("wordpiece.cpp", "maskops.cpp")
    assert all(os.path.exists(os.path.join(native._SRC_DIR, s)) for s in native._SOURCES)
    bad = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            tree = ast.parse(open(path).read())
            docs = {
                id(node.body[0].value) for node in ast.walk(tree)
                if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and node.body and isinstance(node.body[0], ast.Expr)
                and isinstance(node.body[0].value, ast.Constant)
            }
            for node in ast.walk(tree):
                if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                        and id(node) not in docs):
                    text = node.value.replace("vltk_tpu_torch", "")
                    if "vltk_tpu/" in text or "vltk_tpu." in text or text == "vltk_tpu":
                        bad.append((path, node.lineno, node.value))
    assert not bad, bad

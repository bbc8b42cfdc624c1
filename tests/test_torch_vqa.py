"""The composed-VQA slice of the PyTorch port held against the JAX package on
the CPU, at the tiny geometry of tests/test_predict.py (a 2-layer R-50-C4
FRCNN of 4 detections; LXMERT with 2 language, 1 visual and 1 cross layer,
hidden 24, 2 heads; a 13-token vocabulary written by the test).

Weights are flax params carried across with ``jax_frcnn_to_torch`` and
``jax_lxmert_to_torch``: for the module tests drawn with numpy at unit
scale at flax's parameter shapes (flax's 0.02 draws leave attention near
uniform, where a wrong stream would hardly show), for the predictors the
port's seeded weights (flax's initialisers) carried into flax with the JAX
package's converters. Inputs are made with numpy from a seed. Tolerances:

* LXMERT modules and ``LxmertForVQA`` in float32: rtol/atol 1e-5 (flax's
  LayerNorm takes the variance as E[x^2] - E[x]^2, torch's as
  E[(x - E[x])^2]; float32 sums in another order);
* bf16 compute: both packages round to bf16 at the same points, but a
  float32 sum in another order flips a rounding by one ulp (2^-8 relative)
  now and then, and a flip in one layer carries through the next: the
  visual encoder's outputs (magnitude ~3) atol 2e-2 (9.3e-3 measured),
  ``LxmertForVQA``'s logits (magnitude ~1.3) atol 3e-2 (1.9e-2 measured);
  the pooler and the answer head, float32 in both, 1e-5;
* ``VQAPredictor`` end to end in float32: scores 1e-5, the same answers,
  top-k order, object ids and box counts, boxes within 1e-4 of the
  image's longer side (the preprocess resize is held within 2e-3 of JAX's
  in tests/test_torch_ops.py, and a box is a pixel coordinate after a conv
  stack on it).
"""

import dataclasses

import numpy as np
import pytest
from PIL import Image

jax = pytest.importorskip("jax")
import torch

import flax.traverse_util as tu

from vltk_tpu.models import FRCNNConfig as JFRCNNConfig
from vltk_tpu.models import lxmert as JX
from vltk_tpu.models.convert import jax_lxmert_to_torch as jx_lxmert_to_torch

from vltk_tpu_torch.models import FRCNNConfig, jax_frcnn_to_torch
from vltk_tpu_torch.models import lxmert as PX
from vltk_tpu_torch.models.convert import jax_lxmert_to_torch

RTOL = ATOL = 1e-5
TINY_FRCNN = dict(
    depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4,
    rpn_hidden_channels=16, anchor_sizes=(16, 32), aspect_ratios=(0.5, 1.0, 2.0),
    pre_nms_topk=64, post_nms_topk=16, num_classes=7, num_attrs=5,
    pooler_resolution=7, min_detections=4, max_detections=4,
)
TINY_LXMERT = dict(
    vocab_size=64, hidden_size=24, num_heads=2, intermediate_size=48, l_layers=2,
    x_layers=1, r_layers=1, visual_feat_dim=128, max_position_embeddings=32,
    num_answers=3, num_objects=7, num_attrs=5,
)
ANSWERS = ["yes", "no", "red", "2", "cat"]
GEOM = dict(batch_size=2, raw_canvas=(64, 64), resized_canvas=(64, 64), short=32.0, maximum=64.0)
S, V = 12, 4  # question tokens, regions


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=err_msg)


def lively(params, rng):
    """Draw flax params (or their shapes) at unit scale: kernels lecun-normal, biases and
    LayerNorm offsets N(0, 0.1), LayerNorm scales U(0.5, 1.5), embeddings
    N(0, 1)."""
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
    """ids, language mask (rows of 12, 7 and 3 real tokens), region
    features, [0, 1] boxes and a visual mask (4, 2 and 0 real regions)."""
    ids = rng.integers(0, TINY_LXMERT["vocab_size"], (n, S)).astype(np.int32)
    tmask = np.zeros((n, S), np.float32)
    vmask = np.zeros((n, V), np.float32)
    for i, (tl, vl) in enumerate(((S, V), (7, 2), (3, 0))[:n]):
        tmask[i, :tl] = 1.0
        vmask[i, :vl] = 1.0
    feats = rng.normal(size=(n, V, TINY_LXMERT["visual_feat_dim"])).astype(np.float32)
    corners = np.sort(rng.uniform(size=(n, V, 2, 2)), axis=2)
    boxes = corners.transpose(0, 1, 3, 2).reshape(n, V, 4).astype(np.float32)
    return ids, tmask, feats, boxes, vmask


@pytest.fixture(scope="module")
def lxmert():
    """(jax config, lively flax LxmertForVQA params, port state dict)."""
    jcfg = JX.LxmertConfig(**TINY_LXMERT)
    rng = np.random.default_rng(1)
    ids, tmask, feats, boxes, vmask = lxmert_inputs(rng)
    shapes = jax.eval_shape(lambda: JX.LxmertForVQA(jcfg).init(jax.random.PRNGKey(0), ids, feats, boxes))
    params = lively(shapes["params"], rng)
    return jcfg, params, jax_lxmert_to_torch(params)


def port_cfg(jcfg, **over):
    return dataclasses.replace(PX.LxmertConfig(**dataclasses.asdict(jcfg)), **over)


def loaded(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


# ------------------------------------------------------- modules vs flax


class TestModules:
    def test_embeddings_and_position_budget(self, lxmert):
        jcfg, params, sd = lxmert
        ids = np.random.default_rng(2).integers(0, 64, (3, S)).astype(np.int32)
        types = (np.arange(S)[None, :] >= 6).astype(np.int32).repeat(3, 0)
        mod = loaded(PX.Embeddings(port_cfg(jcfg)), sub(sd, "lxmert.embeddings."))
        for tt in (None, types):
            want = JX.Embeddings(jcfg).apply({"params": params["lxmert"]["embeddings"]}, ids, tt)
            got = mod(t(ids), None if tt is None else t(tt))
            assert got.dtype == torch.float32
            close(got, want)
        short = PX.Embeddings(port_cfg(jcfg, max_position_embeddings=8))
        with pytest.raises(ValueError, match="max_position_embeddings"):
            short(torch.zeros(1, 9, dtype=torch.int64))

    @pytest.mark.parametrize("dtype", [None, "bfloat16"])
    def test_visual_feat_encoder(self, lxmert, dtype):
        """Inputs cast to the compute type before both projections, the
        LayerNorms and the average in float32."""
        jcfg, params, sd = lxmert
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        _, _, feats, boxes, _ = lxmert_inputs(np.random.default_rng(3))
        dt = jcfg.compute_dtype
        want = JX.VisualFeatEncoder(jcfg).apply(
            {"params": params["lxmert"]["visn_fc"]}, feats.astype(dt), boxes.astype(dt)
        )
        mod = loaded(PX.VisualFeatEncoder(port_cfg(jcfg)), sub(sd, "lxmert.encoder.visn_fc."))
        pdt = port_cfg(jcfg).compute_dtype
        got = mod(t(feats).to(pdt), t(boxes).to(pdt))
        assert got.dtype == torch.float32
        tol = RTOL if dtype is None else 2e-2
        close(got, want, rtol=tol, atol=tol)

    @pytest.mark.parametrize("lang_lengths", [(12, 12, 12), (12, 7, 3), (1, 5, 9)])
    def test_cross_modality_layer(self, lxmert, lang_lengths):
        """One cross-attention in both directions, the visual direction
        reading the incoming language stream; one visual row fully masked,
        language rows of several lengths."""
        jcfg, params, sd = lxmert
        rng = np.random.default_rng(4)
        lang = rng.normal(size=(3, S, 24)).astype(np.float32)
        visn = rng.normal(size=(3, V, 24)).astype(np.float32)
        tmask = (np.arange(S)[None, :] < np.array(lang_lengths)[:, None]).astype(np.float32)
        vmask = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]], np.float32)
        want_l, want_v = JX.CrossModalityLayer(jcfg).apply(
            {"params": params["lxmert"]["x_layer_0"]}, lang, tmask, visn, vmask
        )
        mod = loaded(PX.CrossModalityLayer(port_cfg(jcfg)), sub(sd, "lxmert.encoder.x_layers.0."))
        got_l, got_v = mod(t(lang), t(tmask), t(visn), t(vmask))
        close(got_l, want_l, err_msg="lang")
        close(got_v, want_v, err_msg="visn")

    def test_lxmert_encoder(self, lxmert):
        jcfg, params, sd = lxmert
        ids, tmask, feats, boxes, vmask = lxmert_inputs(np.random.default_rng(5))
        want = JX.Lxmert(jcfg).apply({"params": params["lxmert"]}, ids, feats, boxes, tmask, vmask)
        got = loaded(PX.Lxmert(port_cfg(jcfg)), sub(sd, "lxmert."))(t(ids), t(feats), t(boxes), t(tmask), t(vmask))
        for name, g, w in zip(("lang", "visn", "pooled"), got, want):
            assert g.dtype == torch.float32
            close(g, w, err_msg=name)

    def test_answer_head(self, lxmert):
        jcfg, params, sd = lxmert
        pooled = np.random.default_rng(6).normal(size=(3, 24)).astype(np.float32)
        want = JX.AnswerHead(jcfg).apply({"params": params["answer_head"]}, pooled)
        got = loaded(PX.AnswerHead(port_cfg(jcfg)), sub(sd, "answer_head."))(t(pooled))
        close(got, want)

    def test_lxmert_for_vqa(self, lxmert):
        jcfg, params, sd = lxmert
        ids, tmask, feats, boxes, vmask = lxmert_inputs(np.random.default_rng(7))
        want = JX.LxmertForVQA(jcfg).apply({"params": params}, ids, feats, boxes, tmask, vmask)
        got = loaded(PX.LxmertForVQA(port_cfg(jcfg)), sd)(t(ids), t(feats), t(boxes), t(tmask), t(vmask))
        close(got, want)

    def test_lxmert_for_vqa_bf16(self, lxmert):
        """bf16 compute with float32 parameters; the pooler and the head
        stay float32 (flax ``nn.Dense`` without a dtype)."""
        jcfg, params, sd = lxmert
        jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
        ids, tmask, feats, boxes, vmask = lxmert_inputs(np.random.default_rng(8))
        want = np.asarray(JX.LxmertForVQA(jcfg).apply({"params": params}, ids, feats, boxes, tmask, vmask))
        model = loaded(PX.LxmertForVQA(port_cfg(jcfg)), sd)
        got = model(t(ids), t(feats), t(boxes), t(tmask), t(vmask))
        assert got.dtype == torch.float32 and np.abs(want).max() > 1.0
        close(got, want, rtol=0, atol=3e-2)

    def test_pooler_and_head_stay_float32_under_bf16(self, lxmert):
        """flax's Pooler and AnswerHead are ``nn.Dense`` without a dtype:
        float32 even when the encoder computes in bf16."""
        jcfg, params, sd = lxmert
        jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
        rng = np.random.default_rng(11)
        lang = rng.normal(size=(3, S, 24)).astype(np.float32)
        want = JX.Pooler(jcfg).apply({"params": params["lxmert"]["pooler"]}, lang)
        got = loaded(PX.Pooler(port_cfg(jcfg)), sub(sd, "lxmert.pooler."))(t(lang))
        assert got.dtype == torch.float32
        close(got, want)
        pooled = rng.normal(size=(3, 24)).astype(np.float32)
        want = JX.AnswerHead(jcfg).apply({"params": params["answer_head"]}, pooled)
        close(loaded(PX.AnswerHead(port_cfg(jcfg)), sub(sd, "answer_head."))(t(pooled)), want)

    def test_vqa_soft_loss(self):
        rng = np.random.default_rng(9)
        logits = (rng.normal(size=(4, 7)) * 30).astype(np.float32)
        targets = rng.choice([0.0, 0.3, 0.6, 0.9, 1.0], (4, 7)).astype(np.float32)
        want = float(JX.vqa_soft_loss(logits, targets))
        got = float(PX.vqa_soft_loss(t(logits), t(targets)))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_unported_options_name_their_roadmap_item(self):
        from vltk_tpu_torch.parallel.mesh import resolve_axes

        # the mesh options are ported (A.14a, A.14b); the ring backend needs a
        # mesh, as JAX's does; expert and pipeline axes build, and what JAX
        # rejects (a fixed product the world does not hold) raises
        cfg = PX.LxmertConfig(vocab_size=20, hidden_size=8, num_heads=2, intermediate_size=16, l_layers=1,
                              x_layers=1, r_layers=1, visual_feat_dim=4, activation_sharding=True,
                              seq_attention_sharding=True, seq_attention_backend="ring")
        with pytest.raises(ValueError, match="must run under a mesh"):
            PX.Lxmert(cfg)(torch.zeros((1, 4), dtype=torch.long), torch.zeros((1, 2, 4)), torch.zeros((1, 2, 4)))
        assert resolve_axes((("data", 1), ("expert", 2)), 2)[1] == [1, 2]
        assert resolve_axes((("pipe", -1),), 2)[1] == [2]
        with pytest.raises(ValueError, match="needs 4 devices, have 2"):
            resolve_axes((("pipe", 2), ("expert", 2)), 2)
        assert PX.LxmertConfig(remat=True).remat  # A.13 is ported
        assert PX.LxmertConfig(moe_experts=4).moe_experts == 4  # A.11b is ported
        assert PX.LxmertConfig(int8=True).int8  # A.9 is ported


# --------------------------------------------------------------- converter


class TestConverter:
    def test_keys_and_values_match_the_jax_converter(self, lxmert):
        jcfg, params, sd = lxmert
        ref = jx_lxmert_to_torch(params)
        assert set(sd) == set(ref)
        assert any(k.startswith("answer_head.") for k in sd) and all(
            k.startswith(("lxmert.", "answer_head.")) for k in sd
        )
        for k, v in ref.items():
            assert sd[k].dtype == torch.float32
            np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
        PX.LxmertForVQA(port_cfg(jcfg)).load_state_dict(sd, strict=True)

    def test_bare_encoder_gives_unprefixed_names(self, lxmert):
        jcfg, params, _ = lxmert
        bare = jax_lxmert_to_torch(params["lxmert"])
        ref = jx_lxmert_to_torch(params["lxmert"], prefixed=False)
        assert set(bare) == set(ref) and not any(k.startswith("lxmert.") for k in bare)
        PX.Lxmert(port_cfg(jcfg)).load_state_dict(bare, strict=True)

    def test_unknown_keys_raise(self, lxmert):
        _, params, _ = lxmert
        with pytest.raises(KeyError, match="mlm_head/mystery"):
            jax_lxmert_to_torch({**params, "mlm_head": {"mystery": {"bias": np.zeros(3)}}})
        with pytest.raises(KeyError, match="mystery_head"):
            jax_lxmert_to_torch({**params, "mystery_head": {"bias": np.zeros(3)}})
        with pytest.raises(KeyError, match="x_layer_0/mystery"):
            jax_lxmert_to_torch({"x_layer_0": {"mystery": {"kernel": np.zeros((2, 2))}}})


# --------------------------------------------------------------- host side


@pytest.fixture(scope="module")
def tiny_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
              "what", "is", "the", "color", "cat", "on", "box", "##s"]
    path.write_text("\n".join(tokens) + "\n")
    return str(path)


class TestHost:
    @pytest.mark.parametrize("vocab", ["tiny", "packaged"])
    def test_encode_batch_matches_the_jax_tokenizer(self, tiny_vocab, vocab):
        from vltk_tpu.data.tokenizer import Tokenizer as JTok

        from vltk_tpu_torch import vars as V
        from vltk_tpu_torch.data.tokenizer import Tokenizer

        path = tiny_vocab if vocab == "tiny" else None
        questions = ["what is the color", "Is the CAT on the boxs?", "", "naïve zebra",
                     " ".join(["what"] * 30), "What color is the dog's ball?", "日本 3.14"]
        ref = JTok(name="NativeWordPiece", vocab_path=path, max_seq_length=S)
        port = Tokenizer(vocab_path=path, max_seq_length=S)
        want, got = ref.encode_batch(questions), port.encode_batch(questions)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == {V.input_ids, V.type_ids, V.text_attention_mask}
            for key in g:
                assert g[key].dtype == np.int32 and g[key].shape == (S,)
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert port.special_ids == ref.special_ids
        for key, value in port.encode(questions[1]).items():
            np.testing.assert_array_equal(value, ref.encode(questions[1])[key])
        assert want[4][V.text_attention_mask].all() and got[4][V.input_ids][-1] == port.sep_id

    def test_collate_matches_the_jax_adapter(self):
        from vltk_tpu.adapters.frcnn import FRCNN as JAdapter

        from vltk_tpu_torch import vars as V
        from vltk_tpu_torch.adapters.frcnn import collate

        rng = np.random.default_rng(10)
        images = [
            rng.integers(0, 256, (48, 56, 3)).astype(np.uint8),
            rng.integers(0, 256, (128, 96, 3)).astype(np.uint8),  # shrunk to 64 x 48
            rng.integers(0, 256, (40, 200, 3)).astype(np.uint8),  # shrunk to 12 x 64
            rng.uniform(-20.0, 280.0, (30, 20, 3)).astype(np.float32),  # rounded and clipped
        ]
        entries = [{V.img: img, V.imgid: f"im{i}"} for i, img in enumerate(images)]
        ref = type("Sized", (JAdapter,), {"raw_canvas": (64, 64)}).collate(entries)
        got = collate(entries, (64, 64))
        assert got[V.img].dtype == np.uint8 and got[V.rawsize].dtype == np.int32
        np.testing.assert_array_equal(got[V.img], ref[V.img])
        np.testing.assert_array_equal(got[V.rawsize], ref[V.rawsize])
        assert got[V.imgid] == ref[V.imgid]
        assert got[V.rawsize].tolist() == [[48, 56], [64, 48], [12, 64], [30, 20]]


# ---------------------------------------------------------- the predictor


def _images(tmp_path):
    """An array, a JPEG path and an image larger than the 64 x 64 raw
    canvas (shrunk on the host)."""
    rng = np.random.default_rng(0)
    jpg = str(tmp_path / "img.jpg")
    Image.fromarray(rng.integers(0, 255, (40, 64, 3)).astype(np.uint8)).save(jpg)
    return [rng.integers(0, 255, (48, 56, 3)).astype(np.uint8), jpg,
            rng.integers(0, 255, (128, 96, 3)).astype(np.uint8)]


QUESTIONS = ["what is the color", "is the cat on the boxs", "what"]


def port_kwargs(ref, tiny_vocab, **over):
    from vltk_tpu_torch.data.tokenizer import Tokenizer

    kw = dict(
        frcnn_params=jax_frcnn_to_torch(ref.frcnn_params),
        lxmert_params=jax_lxmert_to_torch(ref.lxmert_params),
        frcnn_config=FRCNNConfig(**dataclasses.asdict(ref.frcnn_config)),
        lxmert_config=port_cfg(ref.lxmert_config),
        tokenizer=Tokenizer(vocab_path=tiny_vocab, max_seq_length=S),
        device="cpu", **GEOM,
    )
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def predictors(tiny_vocab, tmp_path_factory):
    """The JAX VQAPredictor and the port's on its params, float32, and
    both results on three pairs at batch_size 2 (so the second bucket has
    a pad row). The weights are the port's seeded ones (flax's
    initialisers) carried into flax with the JAX package's converters:
    flax's own ``init`` of the detector runs op by op and would take most
    of this file's time."""
    from vltk_tpu.data.tokenizer import Tokenizer as JTok
    from vltk_tpu.models.convert import torch_frcnn_to_jax, torch_lxmert_to_jax
    from vltk_tpu.predict import VQAPredictor as JVQA

    from vltk_tpu_torch.models.frcnn import FRCNN, init_weights as init_frcnn
    from vltk_tpu_torch.predict import VQAPredictor

    jcfg = JX.LxmertConfig(**TINY_LXMERT)
    frcnn_sd = init_frcnn(FRCNN(FRCNNConfig(**TINY_FRCNN)), seed=0).state_dict()
    lxmert_sd = PX.init_weights(PX.LxmertForVQA(port_cfg(jcfg, num_answers=len(ANSWERS))), seed=1).state_dict()
    ref = JVQA(
        ANSWERS, frcnn_config=JFRCNNConfig(**TINY_FRCNN), lxmert_config=jcfg,
        frcnn_params=torch_frcnn_to_jax(frcnn_sd), lxmert_params=torch_lxmert_to_jax(lxmert_sd),
        tokenizer=JTok(name="NativeWordPiece", vocab_path=tiny_vocab, max_seq_length=S), **GEOM,
    )
    port = VQAPredictor(ANSWERS, **port_kwargs(ref, tiny_vocab))
    images = _images(tmp_path_factory.mktemp("images"))
    return ref, port, images, ref(images, QUESTIONS, top_k=3), port(images, QUESTIONS, top_k=3)


class TestVQAPredictor:
    def test_matches_the_jax_predictor(self, predictors):
        ref, port, images, want, got = predictors
        sides = [64, 64, 128]  # the longer side of each image
        assert port.lxmert_config.num_answers == len(ANSWERS)
        assert port.lxmert_config.visual_feat_dim == TINY_FRCNN["res2_out_channels"] * 8
        assert len(got) == len(want) == 3
        assert sum(w["num_boxes"] for w in want) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            assert set(g) == set(w)
            assert g["answer"] == w["answer"] and g["num_boxes"] == w["num_boxes"], i
            assert [a for a, _ in g["topk"]] == [a for a, _ in w["topk"]], i
            np.testing.assert_allclose([s for _, s in g["topk"]], [s for _, s in w["topk"]], rtol=0, atol=1e-5)
            np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(g["objects"], np.asarray(w["objects"]))
            np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-4 * sides[i], err_msg=str(i))
            np.testing.assert_allclose(g["object_probs"], w["object_probs"], rtol=1e-5, atol=1e-5)
        # the oversized image's boxes are in its own 128 x 96 frame
        assert got[2]["boxes"][:, [0, 2]].max() > 64 or got[2]["boxes"][:, [1, 3]].max() > 64

    def test_padded_bucket_rows_equal_full_bucket_rows(self, predictors):
        """A bucket of one real pair and one pad row (raw size 0 x 0)
        gives that pair what a bucket of two real pairs gives it."""
        _, port, images, _, got = predictors
        alone = port(images[2:], QUESTIONS[2:], top_k=3)[0]
        full = port(images[1:], QUESTIONS[1:], top_k=3)[1]
        for res in (alone, full):
            assert res["topk"] == got[2]["topk"] and res["num_boxes"] == got[2]["num_boxes"]
            np.testing.assert_array_equal(res["boxes"], got[2]["boxes"])
            np.testing.assert_array_equal(res["objects"], got[2]["objects"])

    def test_step_zeroes_pad_rows_with_where(self, predictors):
        _, port, _, _, _ = predictors
        port.warmup()
        raw = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
        raw[0, :48, :56] = 100
        sizes = torch.tensor([[48.0, 56.0], [0.0, 0.0]])
        det = port.detect(raw, sizes)
        out = port.answer(det, sizes, torch.zeros((2, S), dtype=torch.int32), torch.ones((2, S)))
        assert out["scores"].shape == (2, len(ANSWERS)) and out["scores"].dtype == torch.float32
        assert bool(torch.isfinite(out["scores"][0]).all())
        assert out["obj_ids"].dtype == torch.int32 and out["mask"].shape == (2, 4)

    def test_request_guards(self, predictors):
        _, port, _, _, _ = predictors
        assert port([], []) == []
        with pytest.raises(ValueError, match="questions"):
            port([np.zeros((8, 8, 3), np.uint8)], ["q1", "q2"])
        with pytest.raises(ValueError, match="RGB"):
            port([np.zeros((8, 8), np.uint8)], ["q"])


class TestFromPretrained:
    @staticmethod
    def _files(ref, tmp_path, drop=None, wrapped=False):
        frcnn_path, lxmert_path = str(tmp_path / "frcnn.pt"), str(tmp_path / "lxmert.pt")
        torch.save(jax_frcnn_to_torch(ref.frcnn_params), frcnn_path)
        sd = dict(jax_lxmert_to_torch(ref.lxmert_params))
        # HF keys the model does not have: pretraining heads and a buffer
        sd["cls.predictions.bias"] = torch.zeros(64)
        sd["obj_predict_head.decoder_dict.obj.weight"] = torch.zeros(7, 24)
        sd["lxmert.embeddings.position_ids"] = torch.arange(32)[None]
        if drop:
            sd = {k: v for k, v in sd.items() if not k.startswith(drop)}
        # a training checkpoint keeps the state dict under "model"
        torch.save({"model": sd, "epoch": 3} if wrapped else sd, lxmert_path)
        return frcnn_path, lxmert_path, sd

    @staticmethod
    def _kwargs(ref, tiny_vocab):
        kw = port_kwargs(ref, tiny_vocab)
        del kw["frcnn_params"], kw["lxmert_params"]
        return kw

    @pytest.mark.parametrize("wrapped", [False, True])
    def test_round_trip(self, predictors, tiny_vocab, tmp_path, wrapped):
        from vltk_tpu_torch.predict import VQAPredictor

        ref, port, _, _, _ = predictors
        frcnn_path, lxmert_path, _ = self._files(ref, tmp_path, wrapped=wrapped)
        kw = self._kwargs(ref, tiny_vocab)
        got = VQAPredictor.from_pretrained(frcnn_path, lxmert_path, ANSWERS, **kw)
        for name in ("frcnn", "lxmert"):
            want = getattr(port, name).state_dict()
            have = getattr(got, name).state_dict()
            assert set(have) == set(want)
            for k in want:
                assert torch.equal(have[k], want[k]), k

    @pytest.mark.parametrize("drop", ["lxmert.encoder.x_layers.0.", "answer_head."])
    def test_missing_weights_raise(self, predictors, tiny_vocab, tmp_path, drop):
        """A missing layer raises; so does a missing answer head, which is
        what a bare HF ``LxmertModel`` checkpoint lacks."""
        from vltk_tpu_torch.predict import VQAPredictor

        ref, port, _, _, _ = predictors
        frcnn_path, lxmert_path, _ = self._files(ref, tmp_path, drop=drop)
        n = sum(k.startswith(drop) for k in port.lxmert.state_dict())
        kw = self._kwargs(ref, tiny_vocab)
        with pytest.raises(KeyError, match=rf"lacks {n} LxmertForVQA weights: {drop.replace('.', '[.]')}"):
            VQAPredictor.from_pretrained(frcnn_path, lxmert_path, ANSWERS, **kw)


class TestGuards:
    def test_construction_guards(self, predictors, tiny_vocab):
        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.predict import VQAPredictor

        ref, port, _, _, _ = predictors
        with pytest.raises(ValueError, match="head is 5-wide but 3 labels"):
            VQAPredictor(ANSWERS[:3], **port_kwargs(ref, tiny_vocab))
        with pytest.raises(ValueError, match="exceeds LxmertConfig.vocab_size"):
            VQAPredictor(ANSWERS, **port_kwargs(ref, None, lxmert_params=None, tokenizer=None, max_seq_length=S))
        with pytest.raises(ValueError, match="must equal max_seq_length"):
            VQAPredictor(ANSWERS, **port_kwargs(ref, tiny_vocab, max_seq_length=S + 1))
        tok = Tokenizer(vocab_path=tiny_vocab, max_seq_length=S)
        assert VQAPredictor(ANSWERS, **port_kwargs(ref, tiny_vocab, tokenizer=tok, max_seq_length=S)).tokenizer is tok
        int8 = VQAPredictor(ANSWERS, **port_kwargs(ref, tiny_vocab, frcnn_config=FRCNNConfig(**TINY_FRCNN, int8=True)))
        assert int8.frcnn_config.int8 and int8.frcnn_scales is None  # calibrates on its first request
        # bundles (the round trip: tests/test_torch_aot.py)
        with pytest.raises(ValueError, match="platforms"):
            port.export_bundle("vqa.bundle", platforms=("cpu", "tpu"))
        with pytest.raises(FileNotFoundError):
            VQAPredictor.from_bundle("vqa.bundle", device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                VQAPredictor(ANSWERS, **port_kwargs(ref, tiny_vocab, device=None))

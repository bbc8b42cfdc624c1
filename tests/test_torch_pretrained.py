"""``vltk_tpu_torch/models/pretrained.py`` against ``vltk_tpu/models/pretrained.py``.

Checkpoints are written from the port's seeded tiny models under the
reference names (HF's, the reference FRCNN's), so both packages read the
same file: ``resolve_checkpoint`` on a file and a directory,
``load_state_dict`` of a detectron ``.pkl`` with gamma/beta names and of a
torch ``.pt`` bitwise equal to JAX's dict, and ``from_pretrained`` for the
five architectures: the port's module against the flax model on JAX's
converted parameters, float32, 1e-5. A missing weight raises ``KeyError``
naming it; a hub id raises ``FileNotFoundError`` without the hub package and
when it cannot reach the hub (both stand-ins here: no network is touched).
"""

import dataclasses
import pickle
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from vltk_tpu.models import pretrained as JP
from vltk_tpu_torch.models import pretrained as PP

ATOL = RTOL = 1e-5


def _save(sd, path, kind="pt"):
    if kind == "pkl":
        with open(path, "wb") as f:
            pickle.dump({"model": {k: v.numpy() for k, v in sd.items()}}, f)
    else:
        torch.save(sd, path)
    return str(path)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL,
                               err_msg=what)


class TestResolveAndLoad:
    def test_resolve_a_file_and_a_directory(self, tmp_path):
        path = _save({"a": torch.zeros(2)}, tmp_path / "model.pt")
        assert PP.resolve_checkpoint(path) == JP.resolve_checkpoint(path) == path
        assert PP.resolve_checkpoint(str(tmp_path)) == JP.resolve_checkpoint(str(tmp_path)) == path
        (tmp_path / "pytorch_model.bin").write_bytes(open(path, "rb").read())
        want = str(tmp_path / "pytorch_model.bin")  # the first of the known names
        assert PP.resolve_checkpoint(str(tmp_path)) == JP.resolve_checkpoint(str(tmp_path)) == want
        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(FileNotFoundError, match="no known weight file"):
            PP.resolve_checkpoint(str(empty))

    @pytest.mark.parametrize("hub", ["missing", "offline"])
    def test_hub_id_raises_without_the_hub(self, monkeypatch, hub):
        """The hub package is replaced by a stand-in: absent (the import
        fails) or one whose downloads fail, as offline."""
        if hub == "missing":
            monkeypatch.setitem(sys.modules, "huggingface_hub", None)
        else:
            calls = []

            def download(repo, fname, cache_dir=None):
                calls.append(fname)
                raise OSError("offline")

            monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(hf_hub_download=download))
        for resolve in (PP.resolve_checkpoint, JP.resolve_checkpoint):
            with pytest.raises(FileNotFoundError, match="unc-nlp/frcnn-vg-finetuned"):
                resolve("unc-nlp/frcnn-vg-finetuned")
        if hub == "offline":
            assert calls == list(PP._WEIGHT_NAMES) * 2

    @pytest.mark.parametrize("kind", ["pkl", "pt"])
    def test_load_state_dict_is_jax_s(self, tmp_path, kind):
        """gamma/beta renamed, every value bitwise equal to JAX's numpy dict."""
        gen = torch.Generator().manual_seed(0)
        sd = {
            "backbone.stem.conv1.weight": torch.randn(4, 3, 3, 3, generator=gen),
            "backbone.stem.conv1.norm.gamma": torch.rand(4, generator=gen),
            "backbone.stem.conv1.norm.beta": torch.randn(4, generator=gen),
            "backbone.stem.conv1.norm.running_mean": torch.randn(4, generator=gen),
            "roi_heads.box_predictor.cls_score.bias": torch.randn(7, generator=gen),
            "counter": torch.tensor(3),
        }
        path = _save(sd, tmp_path / f"m.{kind}", kind)
        got, want = PP.load_state_dict(path), JP.load_state_dict(path)
        assert set(got) == set(want)
        assert "backbone.stem.conv1.norm.weight" in got and "backbone.stem.conv1.norm.bias" in got
        for k, v in want.items():
            assert got[k].numpy().dtype == v.dtype and np.array_equal(got[k].numpy(), v), k

    def test_wrapped_training_checkpoints(self, tmp_path):
        sd = {"w": torch.ones(2)}
        for key in ("state_dict", "model"):
            path = _save({key: sd}, tmp_path / f"{key}.pt")
            assert torch.equal(PP.load_state_dict(path)["w"], sd["w"])


# ------------------------------------------------------- from_pretrained


def _frcnn(tmp_path):
    from tests.test_torch_vqa import TINY_FRCNN
    from vltk_tpu.models import FRCNN as JFRCNN
    from vltk_tpu.models import FRCNNConfig as JCfg
    from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, init_weights

    cfg = FRCNNConfig(**TINY_FRCNN)
    path = _save(init_weights(FRCNN(cfg), seed=0).state_dict(), tmp_path / "frcnn.pkl", "pkl")
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32) * 50
    sizes = np.array([[64.0, 64.0], [48.0, 60.0]], np.float32)
    jmodel = JFRCNN(JCfg(**TINY_FRCNN))

    def flax(params):
        out = jax.jit(lambda p, i, s: jmodel.apply({"params": p}, i, s))(params, images, sizes)
        return {k: out[k] for k in ("boxes", "roi_features", "obj_probs")}

    def port(model):
        with torch.no_grad():
            out = model(torch.from_numpy(images), torch.from_numpy(sizes))
        return {k: out[k].numpy() for k in ("boxes", "roi_features", "obj_probs")}

    return path, cfg, flax, port


def _lxmert(tmp_path):
    from tests.test_torch_vqa import TINY_LXMERT
    from vltk_tpu.models import lxmert as JX
    from vltk_tpu_torch.models.lxmert import LxmertConfig, LxmertForVQA, init_weights

    cfg = LxmertConfig(**TINY_LXMERT)
    path = _save(init_weights(LxmertForVQA(cfg), seed=1).state_dict(), tmp_path / "lxmert.bin")
    rng = np.random.default_rng(1)
    args = (rng.integers(0, 64, (2, 9)).astype(np.int32), rng.normal(size=(2, 4, 128)).astype(np.float32),
            rng.uniform(0, 1, (2, 4, 4)).astype(np.float32), np.ones((2, 9), np.float32))
    jmodel = JX.LxmertForVQA(JX.LxmertConfig(**TINY_LXMERT))
    return path, cfg, (lambda p: {"logits": jmodel.apply({"params": p}, *args)}), \
        (lambda m: {"logits": m(*(torch.from_numpy(a) for a in args)).detach().numpy()})


def _layoutlm(tmp_path):
    from vltk_tpu.models import layoutlm as JL
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification
    from vltk_tpu_torch.models.lxmert import init_weights

    tiny = dict(vocab_size=64, hidden_size=32, num_heads=2, intermediate_size=64, l_layers=2,
                max_position_embeddings=64)
    cfg = LayoutLMConfig(**tiny)
    # JAX converts the encoder alone (heads skipped): an HF LayoutLMModel file
    headed = init_weights(LayoutLMForTokenClassification(cfg), seed=2).state_dict()
    path = _save({k[len("layoutlm."):]: v for k, v in headed.items() if k.startswith("layoutlm.")},
                 tmp_path / "layoutlm.pt")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (2, 16)).astype(np.int32)
    boxes = np.sort(rng.integers(0, 1000, (2, 16, 2, 2)), axis=2).reshape(2, 16, 4).astype(np.int32)
    mask = np.ones((2, 16), np.float32)
    mask[1, 10:] = 0
    jmodel = JL.LayoutLM(JL.LayoutLMConfig(**tiny))
    return path, cfg, (lambda p: {"hidden": jmodel.apply({"params": p}, ids, boxes, mask)}), \
        (lambda m: {"hidden": m(*(torch.from_numpy(a) for a in (ids, boxes, mask))).detach().numpy()})


def _visualbert(tmp_path):
    from vltk_tpu.models import visualbert as JB
    from vltk_tpu_torch.models.lxmert import init_weights
    from vltk_tpu_torch.models.visualbert import VisualBertConfig, VisualBertForClassification

    tiny = dict(vocab_size=99, hidden_size=32, num_heads=4, intermediate_size=64, l_layers=2, visual_feat_dim=16,
                max_position_embeddings=64, num_labels=3)
    cfg = VisualBertConfig(**tiny)
    # JAX converts the encoder alone (heads skipped): an HF VisualBertModel file
    headed = init_weights(VisualBertForClassification(cfg), seed=3).state_dict()
    path = _save({k[len("visual_bert."):]: v for k, v in headed.items() if k.startswith("visual_bert.")},
                 tmp_path / "visualbert.pt")
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 99, (2, 10)).astype(np.int32)
    feats = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jmodel = JB.VisualBert(JB.VisualBertConfig(**tiny))

    def flax(p):
        seq, pooled = jmodel.apply({"params": p}, ids, feats)
        return {"sequence": seq, "pooled": pooled}

    def port(m):
        seq, pooled = m(torch.from_numpy(ids), torch.from_numpy(feats))
        return {"sequence": seq.detach().numpy(), "pooled": pooled.detach().numpy()}

    return path, cfg, flax, port


def _vit(tmp_path):
    from vltk_tpu.models import vit as JV
    from vltk_tpu_torch.models.vit import ViT, ViTConfig, init_vit_weights

    tiny = dict(hidden_size=24, num_heads=2, num_layers=2, intermediate_size=48, image_size=32, patch_size=16)
    cfg = ViTConfig(**tiny)
    path = _save(init_vit_weights(ViT(cfg), seed=4).state_dict(), tmp_path / "vit.pt")
    images = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jmodel = JV.ViT(JV.ViTConfig(**tiny))

    def flax(p):
        seq, pooled = jmodel.apply({"params": p}, images)
        return {"sequence": seq, "pooled": pooled}

    def port(m):
        seq, pooled = m(torch.from_numpy(images))
        return {"sequence": seq.detach().numpy(), "pooled": pooled.detach().numpy()}

    return path, cfg, flax, port


ARCHS = {"frcnn": _frcnn, "lxmert": _lxmert, "layoutlm": _layoutlm, "visualbert": _visualbert, "vit": _vit}


class TestFromPretrained:
    @pytest.mark.parametrize("arch", sorted(ARCHS))
    def test_outputs_match_jax_from_pretrained(self, tmp_path, arch):
        path, cfg, flax, port = ARCHS[arch](tmp_path)
        model = PP.from_pretrained(arch, path, config=cfg, device="cpu")
        assert not model.training and next(model.parameters()).device.type == "cpu"
        got, want = port(model), flax(JP.from_pretrained(arch, path))
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key], f"{arch} {key}")

    def test_head_width_and_bare_encoder(self, tmp_path):
        """The headed class where the checkpoint has its head, sized to it;
        the bare encoder where it has none (HF's root prefix dropped)."""
        from vltk_tpu_torch.models.layoutlm import LayoutLM, LayoutLMConfig, LayoutLMForTokenClassification
        from vltk_tpu_torch.models.lxmert import init_weights

        cfg = LayoutLMConfig(vocab_size=64, hidden_size=32, num_heads=2, intermediate_size=64, l_layers=1,
                             max_position_embeddings=64, num_labels=7)
        sd = init_weights(LayoutLMForTokenClassification(cfg), seed=0).state_dict()
        path = _save(sd, tmp_path / "headed.pt")
        model = PP.from_pretrained("layoutlm", path, config=dataclasses.replace(cfg, num_labels=2), device="cpu")
        assert isinstance(model, LayoutLMForTokenClassification) and model.cfg.num_labels == 7
        bare = {k[len("layoutlm."):]: v for k, v in sd.items() if k.startswith("layoutlm.")}
        model = PP.from_pretrained("layoutlm", _save(bare, tmp_path / "bare.pt"), config=cfg, device="cpu")
        assert isinstance(model, LayoutLM)
        assert all(torch.equal(v, bare[k]) for k, v in model.state_dict().items())

    def test_missing_weight_raises_naming_it(self, tmp_path):
        from tests.test_torch_vqa import TINY_FRCNN
        from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, init_weights

        cfg = FRCNNConfig(**TINY_FRCNN)
        sd = init_weights(FRCNN(cfg), seed=0).state_dict()
        del sd["roi_heads.box_predictor.cls_score.weight"]
        path = _save(sd, tmp_path / "partial.pt")
        with pytest.raises(KeyError, match=r"lacks 1 frcnn weights: roi_heads\.box_predictor\.cls_score\.weight"):
            PP.from_pretrained("frcnn", path, config=cfg, device="cpu")
        with pytest.raises(ValueError, match="unknown arch"):
            PP.from_pretrained("resnet", path, device="cpu")

    @staticmethod
    def _frcnn_pt_and_pkl(tmp_path):
        """The tiny FRCNN's seeded weights as a torch ``.pt`` and as a
        detectron ``.pkl`` with gamma/beta names."""
        from tests.test_torch_vqa import TINY_FRCNN
        from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, init_weights

        sd = init_weights(FRCNN(FRCNNConfig(**TINY_FRCNN)), seed=0).state_dict()
        pt = _save(sd, tmp_path / "frcnn.pt")
        renamed = {(k[: k.rindex(".")] + (".gamma" if k.endswith("weight") else ".beta"))
                   if ".norm." in k and k.endswith((".weight", ".bias")) else k: v for k, v in sd.items()}
        assert any(k.endswith(".gamma") for k in renamed)
        return pt, _save(renamed, tmp_path / "frcnn.pkl", "pkl")

    def test_extraction_loads_a_detectron_pickle(self, tmp_path):
        """The extraction step (``adapters.frcnn.setup``, which ``vltk-torch
        extract --checkpoint=`` reaches) reads the same checkpoint kinds as
        ``from_pretrained``: a ``.pkl`` and a directory give the ``.pt``'s
        weights bitwise, and a missing weight raises ``KeyError``."""
        from tests.test_torch_vqa import TINY_FRCNN
        from vltk_tpu_torch.adapters.frcnn import setup
        from vltk_tpu_torch.models.frcnn import FRCNNConfig

        pt, pkl = self._frcnn_pt_and_pkl(tmp_path)
        want = PP.from_pretrained("frcnn", pt, config=FRCNNConfig(**TINY_FRCNN), device="cpu").state_dict()
        (tmp_path / "ckpt").mkdir()
        (tmp_path / "frcnn.pt").rename(tmp_path / "ckpt" / "model.pt")
        for ckpt in (pkl, str(tmp_path / "ckpt")):
            got = setup(checkpoint=ckpt, device="cpu", **TINY_FRCNN)[0]["model"].state_dict()
            assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
        with open(pkl, "rb") as f:
            partial = pickle.load(f)
        partial["model"].pop("roi_heads.box_predictor.cls_score.weight")
        with open(pkl, "wb") as f:
            pickle.dump(partial, f)
        with pytest.raises(KeyError, match=r"roi_heads\.box_predictor\.cls_score\.weight"):
            setup(checkpoint=pkl, device="cpu", **TINY_FRCNN)

    def test_predictors_load_a_detectron_pickle(self, tmp_path):
        """``VQAPredictor.from_pretrained`` reads the FRCNN from a detectron
        ``.pkl`` (gamma/beta names) as from the ``.pt``, bitwise."""
        from tests.test_torch_vqa import ANSWERS, GEOM, S, TINY_FRCNN, TINY_LXMERT
        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.models.frcnn import FRCNNConfig
        from vltk_tpu_torch.models.lxmert import LxmertConfig, LxmertForVQA
        from vltk_tpu_torch.models.lxmert import init_weights as init_lxmert
        from vltk_tpu_torch.predict import VQAPredictor

        pt, pkl = self._frcnn_pt_and_pkl(tmp_path)
        lcfg = LxmertConfig(**{**TINY_LXMERT, "num_answers": len(ANSWERS)})
        lxmert = _save(init_lxmert(LxmertForVQA(lcfg), seed=1).state_dict(), tmp_path / "lxmert.bin")
        vocab = tmp_path / "vocab.txt"
        vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what"]) + "\n")
        kw = dict(frcnn_config=FRCNNConfig(**TINY_FRCNN), lxmert_config=lcfg, device="cpu",
                  tokenizer=Tokenizer(vocab_path=str(vocab), max_seq_length=S), **GEOM)
        a = VQAPredictor.from_pretrained(pt, lxmert, ANSWERS, **kw).frcnn.state_dict()
        b = VQAPredictor.from_pretrained(pkl, lxmert, ANSWERS, **kw).frcnn.state_dict()
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)

"""The port's data plane (``build(config)``, datasets, loaders, the device
feed, the data experiment and experiments that build their own loaders)
held against the JAX package on the CPU.

One synthetic COCO-2014 + VQA corpus, drawn with numpy from a seed
(``tools.synthetic_corpus``: 6 images of 40 x 56, 48 questions, 8 a
image), is copied twice; ``vltk_tpu.build`` runs on one copy and
``vltk_tpu_torch.build`` on the other, each extracting its own tables, with
``num_workers=0``. Every key of every batch must be bitwise equal: text
first (real images on a fixed canvas, gt annotations merged), shuffled,
``rand_feats`` (numpy's global generator reseeded before each run), image
first through ``transpose_vl``, the eval loader. The JAX package's default
tokenizer (HF ``tokenizers``' BERT WordPiece) runs on the port's native
WordPiece over the same vocabulary. LXMERT's first training step from
``build`` is held to tests/test_torch_lxmert_train.py's tolerance (1e-4).
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import vltk_tpu as J
from vltk_tpu import config as JC
from vltk_tpu.models import lxmert as JX

import vltk_tpu_torch as P
from vltk_tpu_torch import config as PC
from vltk_tpu_torch.data import loader as PL
from vltk_tpu_torch.experiments import DataExperiment, Experiments, LxmertVQAExperiment
from vltk_tpu_torch.models import lxmert as PX
from vltk_tpu_torch.models.convert import jax_lxmert_to_torch
from vltk_tpu_torch.tools.synthetic_corpus import write_corpus

S = 16  # question tokens


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    jdir, pdir = str(root / "jax"), str(root / "port")
    write_corpus(jdir, n_images=6, n_questions=48, hw=(40, 56), seed=7)
    shutil.copytree(jdir, pdir)
    return jdir, pdir


def configs(corpora, lang=None, **data):
    out = []
    for mod, d in ((JC, corpora[0]), (PC, corpora[1])):
        cfg = mod.Config()
        cfg.data.update({
            "datadir": d, "train_datasets": [["vqa", "train"]], "train_batch_size": 8, "num_workers": 0,
            "shuffle": False, "vision": {"size": (24, 40)}, **data,
        })
        cfg.data.lang.update({"max_seq_length": S, **(lang or {})})
        out.append(cfg)
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want) and want
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for k, wv in w.items():
            gv = g[k]
            if isinstance(wv, np.ndarray):
                assert isinstance(gv, np.ndarray) and gv.dtype == wv.dtype and gv.shape == wv.shape, (i, k)
                np.testing.assert_array_equal(gv, wv, err_msg=f"batch {i} key {k}")
            else:
                assert gv == wv, (i, k)


def both_batches(corpora, seed=None, eval_loader=False, transposed=False, **data):
    out = []
    for build, cfg in zip((J.build, P.build), configs(corpora, **data)):
        if seed is not None:
            np.random.seed(seed)
        loaders = build(cfg)
        loader = loaders[1] if eval_loader else loaders[0]
        batches = list(loader.transposed(max_size=20) if transposed else loader)
        for b in batches:  # the two copies' paths, relative to their roots
            if "filepath" in b:
                b["filepath"] = [os.path.relpath(p, cfg.data.datadir) for p in b["filepath"]]
        out.append(batches)
    return out


class TestBatches:
    def test_text_first_real_images_and_annotations(self, corpora):
        want, got = both_batches(corpora)
        assert_batches_equal(got, want)
        b = got[0]
        assert b["image"].shape == (8, 64, 64, 3) and b["gt_boxes"].shape == (8, 36, 4)
        assert b["labels"].shape == (8, 16) and b["vlabels"].dtype == np.int32
        assert b["gt_boxes_mask"].sum() > 0 and (b["label"] >= 0).all()

    def test_shuffled(self, corpora):
        want, got = both_batches(corpora, shuffle=True, drop_last=False, train_batch_size=5)
        assert_batches_equal(got, want)
        assert [q for b in got for q in b["qid"]] != [str(i) for i in range(48)]

    def test_rand_feats(self, corpora):
        want, got = both_batches(corpora, seed=11, rand_feats=(4, 32), ignore_annotations=True)
        assert_batches_equal(got, want)
        assert got[0]["features"].shape == (8, 4, 32)

    def test_img_first_transposed(self, corpora):
        want, got = both_batches(corpora, transposed=True, img_first=True, rand_feats=(4, 32), seed=3,
                                 train_batch_size=2, ignore_annotations=True)
        assert_batches_equal(got, want)
        assert got[0]["input_ids"].shape == (16, S) and got[0]["sentence_mask"].sum() == 16

    def test_eval_loader(self, corpora):
        want, got = both_batches(corpora, eval_loader=True, eval_datasets=[["vqa", "train"]], eval_batch_size=20,
                                 ignore_image=True)
        assert_batches_equal(got, want)
        assert [len(b["qid"]) for b in got] == [20, 20, 8]  # eval keeps the short last batch


class TestLoaderMechanics:
    def test_host_shards_cover_disjointly(self, corpora):
        seen = []
        for rank in range(3):
            (jcfg, pcfg) = configs(corpora, shard_count=3, shard_rank=rank, shuffle=True, rand_feats=(2, 8),
                                   ignore_annotations=True, train_batch_size=4)
            loader = P.build(pcfg)[0]
            qids = [q for b in loader for q in b["qid"]]
            assert qids == [q for b in J.build(jcfg)[0] for q in b["qid"]]
            seen.append(set(qids))
            assert len(loader) == 4
        assert set.union(*seen) == {str(i) for i in range(48)}
        assert all(not (a & b) for i, a in enumerate(seen) for b in seen[i + 1:])
        with pytest.raises(ValueError, match="shard_rank"):
            P.build(configs(corpora, shard_count=2, shard_rank=2)[1])

    def test_shard_rank_defaults_to_zero_without_a_process_group(self):
        assert not torch.distributed.is_initialized()
        assert PL._config_shard(PC.DataConfig(shard_count=4), None) == (0, 4)
        assert PL._config_shard(PC.DataConfig(shard_count=4), (1, 2)) == (1, 2)
        assert PL._config_shard(PC.DataConfig(), None) is None

    @pytest.mark.parametrize("workers", [0, 2])
    def test_iter_from_skips_without_fetching(self, workers):
        class Recording:
            def __init__(self):
                self.fetched = []
                self.lock = threading.Lock()

            def __len__(self):
                return 12

            def __getitem__(self, i):
                with self.lock:
                    self.fetched.append(int(i))
                return {"i": np.int32(i)}

        data = Recording()
        loader = PL._BaseLoader(data, 3, True, num_workers=workers, seed=5)
        want = [list(b["i"]) for b in loader][2:]
        data.fetched.clear()
        got = [list(b["i"]) for b in loader.iter_from(2)]
        assert got == want and sorted(data.fetched) == sorted(i for b in want for i in b)
        assert [list(b["i"]) for b in loader][2:] == want  # plain iteration unaffected

    @pytest.mark.parametrize("case", ["order", "raises", "early_stop"])
    def test_prefetched(self, case):
        made = []

        def items():
            for i in range(20):
                if case == "raises" and i == 3:
                    raise OSError("bad file")
                made.append(i)
                yield i

        before = threading.active_count()
        gen = PL.prefetched(items, 2)
        if case == "order":
            assert list(gen) == list(range(20))
        elif case == "raises":
            with pytest.raises(OSError, match="bad file"):
                list(gen)
            assert made == [0, 1, 2]
        else:
            assert [next(gen), next(gen)] == [0, 1]
            gen.close()
            # at most depth + 2 made: two taken, two queued, one blocked in put
            assert len(made) <= 5
        assert threading.active_count() == before  # the producer is joined

    def test_max_text_per_img_warns(self, corpora):
        _, pcfg = configs(corpora, img_first=True, max_text_per_img=3, rand_feats=(2, 8), ignore_annotations=True,
                          train_batch_size=2)
        with pytest.warns(UserWarning, match=r"max_text_per_img=3 TRUNCATES 6/6 images"):
            loader = P.build(pcfg)[0]
        assert next(iter(loader))["input_ids"].shape == (2, 3, S)

    def test_metadata_ids_shared_with_the_eval_loader(self, corpora):
        jcfg, pcfg = configs(corpora, eval_datasets=[["vqa", "train"]], rand_feats=(2, 8))
        train, evl = P.build(pcfg)
        assert train.metadata_ids is evl.metadata_ids
        assert train.metadata_ids == J.build(jcfg)[0].metadata_ids
        assert sorted(train.metadata_ids["answers"]) == ["2", "no", "red", "yes"]
        assert train.tokenizer is not None and train.tokenizer.decode(
            next(iter(train))["input_ids"][0]).startswith("what is the colour of object")

    def test_collate_and_transpose_as_jax(self):
        from vltk_tpu.data.loader import collate as jcollate, transpose_vl as jtranspose

        rng = np.random.default_rng(0)
        entries = [{"a": rng.normal(size=(2,)).astype(np.float32), "s": "x", "only_first": 1}, {
            "a": rng.normal(size=(2,)).astype(np.float32), "s": "y"}]
        assert_batches_equal([PL.collate(entries)], [jcollate(entries)])
        batch = {"text_mask": np.array([[1, 1, 0], [1, 0, 0]], np.int32),
                 "input_ids": rng.integers(0, 9, (2, 3, 4)).astype(np.int32),
                 "features": rng.normal(size=(2, 3, 5)).astype(np.float32), "imgid": ["a", "b"]}
        assert_batches_equal([PL.transpose_vl(batch, max_size=4)], [jtranspose(batch, max_size=4)])
        with pytest.warns(RuntimeWarning, match="not fixed-shape"):
            PL.collate([{"a": np.zeros(2)}, {"a": np.zeros(3)}])


class TestDevicePutIter:
    def test_order_keys_and_passthrough_on_the_cpu(self):
        batches = [{"x": np.full((2,), i, np.float32), "t": torch.full((1,), i), "name": [f"n{i}"]} for i in range(4)]
        out = list(PL.device_put_iter(batches, device="cpu"))
        assert [int(b["x"][0]) for b in out] == [0, 1, 2, 3]
        assert all(torch.is_tensor(b["x"]) and b["x"].device.type == "cpu" for b in out)
        assert [b["name"] for b in out] == [[f"n{i}"] for i in range(4)]
        only = list(PL.device_put_iter(batches, keys=["x"], device="cpu"))
        assert all(list(b) == ["x"] for b in only)
        assert list(PL.device_put_iter([], device="cpu")) == []

    def test_no_silent_cpu_path(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(PL.device_put_iter([{"x": np.zeros(1)}]))


TINY = dict(vocab_size=30522, hidden_size=24, num_heads=2, intermediate_size=48, l_layers=2, x_layers=1,
            r_layers=1, visual_feat_dim=32, max_position_embeddings=32, num_answers=3, num_objects=7, num_attrs=5,
            hidden_dropout=0.0, attention_dropout=0.0)


class TestExperiments:
    def test_data_experiment(self, corpora, capsys):
        jcfg, pcfg = configs(corpora, rand_feats=(4, 32), eval_datasets=[["vqa", "train"]])
        assert Experiments.get("data") is DataExperiment
        np.random.seed(0)
        report = DataExperiment(pcfg)()
        np.random.seed(0)
        from vltk_tpu.experiments.data import DataExperiment as JData

        assert report == JData(jcfg)()
        assert report["train"]["features"] == (8, 4, 32) and "[eval]" in capsys.readouterr().out

    def test_lxmert_vqa_builds_its_loaders(self, corpora, tmp_path):
        """LxmertVQAExperiment(config) with loaders=None in both packages,
        the port's weights the JAX experiment's initial ones: the loaders'
        answer tables size the head, and the first step's loss and
        vqa_score agree (1e-4)."""
        from vltk_tpu.experiments.lxmert_vqa import LxmertVQAExperiment as JVQA

        jcfg, pcfg = configs(corpora, rand_feats=(4, 32), ignore_annotations=True, train_batch_size=16)
        for cfg, name in ((jcfg, "jax"), (pcfg, "port")):
            cfg.logdir = str(tmp_path / name)
            cfg.train.update({"epochs": 1, "learning_rate": 5e-3})
            cfg.data.update({"max_detections": 4})

        class JTiny(JVQA):
            model_config = JX.LxmertConfig(**TINY)

        np.random.seed(2)
        jexp = JTiny(jcfg)
        init = jax_lxmert_to_torch(jax.device_get(jexp.state.params))

        class PTiny(LxmertVQAExperiment):
            model_config = PX.LxmertConfig(**{**TINY, "num_answers": 3})

            def build_model(self):
                model = super().build_model()
                model.load_state_dict(init)
                return model

        np.random.seed(2)
        pexp = PTiny(pcfg, device="cpu")
        assert pexp.model_config.num_answers == jexp.model_config.num_answers == 4
        assert len(pexp.train_loader) == len(jexp.train_loader) == 3
        np.random.seed(2)
        jexp()
        np.random.seed(2)
        pexp()
        logs = []
        for exp in (jexp, pexp):
            with open(os.path.join(exp.logdir, "steps_log.json")) as f:
                logs.append([json.loads(line) for line in f])
        assert len(logs[1]) == len(logs[0]) == 3
        for key in ("loss", "vqa_score"):
            np.testing.assert_allclose(logs[1][0][key], logs[0][0][key], rtol=1e-4, atol=1e-4, err_msg=key)
        assert all(np.isfinite(r["loss"]) for r in logs[1])

    def test_simple_experiment_without_datasets(self, tmp_path):
        cfg = PC.Config(logdir=str(tmp_path))
        with pytest.raises(ValueError, match="train loader"):
            LxmertVQAExperiment(cfg, device="cpu")

"""The nine adapters of the port's second host-plane slice, and its
profiling, memory and drawing helpers, held against the JAX package on the
CPU.

One seeded raw corpus of every layout (``tools.synthetic_corpus``: FUNSD
forms, DocVQA OCR results and questions, GQA questions over Visual Genome
images, VGQA, CLEVR and CLEVR-ref+ scenes, COCO captions) is copied twice
and extracted by each package into its own copy. For every adapter the
rows, the metadata (row map, ``*_frequencies`` counters, ``huggingface``
column types) and the Arrow schemas are equal, and each package reads the
other's files to the same rows. JAX's adapter regressions
(tests/test_adapters_more.py, tests/test_adapters.py) run on the port.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from vltk_tpu.adapters import Adapters as JAdapters
from vltk_tpu.utils import memory as JM
from vltk_tpu.utils import viz as JViz

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters import Adapters
from vltk_tpu_torch.tools import synthetic_corpus as sc
from vltk_tpu_torch.utils import memory, profiling, viz

VISION = ("funsd", "docvqavisn", "clevr", "clevrref")
LANGUAGE = (("docvqa", "train"), ("gqa", "train"), ("vgqa", "train"), ("cococaptions", "train"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("more")
    jdir, pdir = str(root / "jax"), str(root / "port")
    sc.write_funsd(jdir, n_forms=3, n_words=60, seed=1)
    sc.write_docvqa(jdir, n_docs=3, n_words=50, questions_per_doc=3, seed=2)
    sc.write_gqa(jdir, n_images=4, n_questions=40, hw=(24, 32), seed=3)
    sc.write_vgqa(jdir, n_images=4, n_questions=160, seed=4)
    sc.write_clevrref(jdir, n_images=3, hw=(24, 32), seed=5, max_objects=5)
    sc.write_cococaptions(jdir, n_images=4, per_image=2, seed=6)
    shutil.copytree(jdir, pdir)
    out = {}
    for tag, d, reg in (("jax", jdir, JAdapters), ("port", pdir, Adapters)):
        out[tag] = {name: reg.get(name).extract(d) for name in VISION}
        out[tag].update({name: reg.get(name).extract(d)[split] for name, split in LANGUAGE})
    return jdir, pdir, out


def rows(adapter):
    return [{k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in adapter.get_idx(i).items()}
            for i in range(len(adapter))]


@pytest.mark.parametrize("name", list(VISION) + [n for n, _ in LANGUAGE])
def test_rows_metadata_and_cross_reads_equal_jax(corpus, name):
    jdir, pdir, out = corpus
    jad, pad = out["jax"][name], out["port"][name]
    assert len(pad) == len(jad) > 0
    assert rows(pad) == rows(jad)
    assert pad.metadata == jad.metadata and pad.img_to_row_map == jad.img_to_row_map
    assert pad.table.schema.equals(jad.table.schema, check_metadata=True)
    # each package reads the other's file
    split = dict(LANGUAGE).get(name)
    fname = f"{split}.arrow" if split else "annotations.arrow"
    from_jax = Adapters.get(name)._load_one_arrow(os.path.join(jdir, name, fname))
    from_port = JAdapters.get(name)._load_one_arrow(os.path.join(pdir, name, fname))
    assert rows(from_jax) == rows(pad) and rows(from_port) == rows(jad)


def test_corpus_contents(corpus):
    """What the seeded corpus gives each adapter: FUNSD's header -> other,
    xywh boxes; DocVQA's 8-point boxes and grounded spans; GQA's stripped
    "n"; VGQA's rare answers dropped; CLEVR's (n, 3) positions; CLEVR-ref's
    point runs decode to the ellipses inside their boxes."""
    _, pdir, out = corpus
    p = out["port"]
    funsd = p["funsd"].get_idx(0)
    assert set(funsd[V.label]) <= {"question", "answer", "other"} and len(funsd[V.text]) == 60
    assert p["funsd"].metadata["label_frequencies"]
    box = np.asarray(funsd[V.tokenbox])
    assert (box[:, 2:] > 0).all() and box.shape == (60, 4)
    doc = p["docvqavisn"].get_idx(0)
    assert len(doc[V.text]) == 50 and np.asarray(doc[V.tokenbox]).shape == (50, 4)
    qa = p["docvqa"]
    assert len(qa) == 9
    for i in range(len(qa)):
        row = qa.get_idx(i)
        words = [w.lower() for w in p["docvqavisn"].get(row[V.imgid])[V.text]]
        start, end = row[V.span]
        assert row["answer"] == " ".join(words[start : end + 1])
    gqa = p["gqa"].get_idx(1)
    assert gqa[V.imgid] == str(sc.vg_ids(4)[1]) and gqa["layout"] and gqa[V.label][0] in sc.GQA_ANSWERS
    assert len(p["vgqa"]) == 150 and all(r[V.label][0] in sc.GQA_ANSWERS for r in rows(p["vgqa"]))
    clevr = p["clevr"].get_idx(0)
    assert np.asarray(clevr["positions"]).shape[1] == 3 and len(clevr["colors"]) == len(clevr["positions"])
    ref = p["clevrref"].get_idx(0)
    from vltk_tpu_torch.utils.adapters import imagepoints_to_mask

    for pts, (x, y, w, h) in zip(ref[V.RLE], ref[V.box]):
        mask = imagepoints_to_mask(pts, (24, 32))
        ys, xs = np.nonzero(mask)
        assert mask.any() and xs.min() >= x and xs.max() < x + w and ys.min() >= y and ys.max() < y + h
    assert len(p["cococaptions"]) == 8 and p["cococaptions"].get_idx(0)[V.imgid] == "COCO_train2014_000000000000"
    assert Adapters.get("visualgenome").load_imgid2path(pdir, "train") == {
        str(i): os.path.join(pdir, "visualgenome", "train", f"{i}.jpg") for i in sc.vg_ids(4)}


class TestRegistry:
    def test_every_jax_adapter_resolves(self):
        # "frcnn" registers on first use, and other tests add tiny extraction
        # adapters to either registry, so the built-in eleven are checked as a
        # subset of both
        names = ("clevr", "clevrref", "coco2014", "cococaptions", "docvqa", "docvqavisn", "funsd", "gqa", "vgqa",
                 "visualgenome", "vqa")
        assert set(names) <= set(JAdapters.avail()) and set(names) <= set(Adapters.avail())
        for name in names:
            assert Adapters.get(name.upper()).name() == name
            assert Adapters.is_visnlang(name) == JAdapters.is_visnlang(name)
            assert Adapters.is_visn(name) == JAdapters.is_visn(name)
        assert Adapters.is_visnlang("vgqa") and Adapters.is_visn("visualgenome")
        with pytest.raises(KeyError, match="unknown adapter"):
            Adapters.get("no_such")


def _write(path, payload):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)


class TestJaxRegressions:
    """tests/test_adapters_more.py's and tests/test_adapters.py's cases."""

    def test_funsd_labels_and_boxes(self, tmp_path):
        _write(str(tmp_path / "funsd" / "annotations" / "form_00.json"), {"form": [
            {"label": "question", "words": [{"text": "Name:", "box": [10, 10, 60, 24]}]},
            {"label": "weird_label", "words": [{"text": "X", "box": [0, 0, 8, 8]}]},
        ]})
        Adapters.get("funsd").extract(str(tmp_path))
        row = Adapters.get("funsd").load(str(tmp_path)).get("form_00")
        assert row[V.text] == ["Name:", "X"] and row[V.label] == ["question", "other"]
        assert row[V.tokenbox][0] == [10.0, 10.0, 50.0, 14.0]
        _write(str(tmp_path / "funsd" / "annotations" / "sub" / "form_00.json"), {"form": []})
        with pytest.raises(ValueError, match="duplicate FUNSD form id"):
            Adapters.get("funsd").extract(str(tmp_path))

    def test_docvqa_grounding(self, tmp_path):
        words = ["total", "amount", "due", "42.00"]
        _write(str(tmp_path / "docvqavisn" / "annotations" / "doc1.json"), {
            "status": "Succeeded", "recognitionResults": [{"lines": [{
                "boundingBox": [0, 0, 90, 0, 90, 12, 0, 12],
                "words": [{"text": w, "boundingBox": [i * 20, 0, i * 20 + 18, 0, i * 20 + 18, 12, i * 20, 12]}
                          for i, w in enumerate(words)]}]}]})
        _write(str(tmp_path / "docvqavisn" / "annotations" / "doc2.json"), {"status": "Failed"})
        Adapters.get("docvqavisn").extract(str(tmp_path))
        vds = Adapters.get("docvqavisn").load(str(tmp_path))
        assert len(vds) == 1 and vds.get("doc1")[V.tokenbox][1] == [20.0, 0.0, 18.0, 12.0]
        _write(str(tmp_path / "docvqa" / "docvqa_val.json"), {"data": [
            {"question": 'What is the "amount due"?', "image": "documents/doc1.png", "answers": ["amount due"],
             "docId": 77},
            {"question": "ungroundable?", "image": "documents/doc1.png", "answers": ["zebra stripes"], "docId": 78},
            {"question": "no ocr?", "image": "documents/doc9.png", "answers": ["total"], "docId": 79},
        ]})
        lds = Adapters.get("docvqa").extract(str(tmp_path))["val"]
        assert len(lds) == 1
        row = lds.get("doc1")
        row = row[0] if isinstance(row, list) else row
        assert row["answer"] == "amount due" and row[V.span] == [1, 2] and row[V.text] == "what is the amount due?"

    def test_ragged_clevr_positions(self, tmp_path):
        scenes = {"scenes": [
            {"image_filename": f"CLEVR_val_{i:06d}.png", "objects": [
                {"pixel_coords": [float(j), 0.0, 0.0], "color": "red", "shape": "cube", "size": "large",
                 "material": "rubber"} for j in range(n)]}
            for i, n in enumerate((2, 4))]}
        _write(str(tmp_path / "clevr" / "annotations" / "scenes_val.json"), scenes)
        Adapters.get("clevr").extract(str(tmp_path))
        ds = Adapters.get("clevr").load(str(tmp_path))
        assert np.asarray(ds.get("CLEVR_val_000000")["positions"])[:, 0].tolist() == [0.0, 1.0]
        assert np.asarray(ds.get("CLEVR_val_000001")["positions"]).shape == (4, 3)
        assert ds.metadata["colors_frequencies"]["red"] == 6

    def test_gqa_split_files_and_min_frequency(self, tmp_path):
        base = str(tmp_path / "gqa")
        qa = {"q0": {"question": "?", "answer": "yes", "imageId": "n1", "semantic": []}}
        for name in ("test", "testdev", "train_all_00", "val_unbalanced"):
            _write(os.path.join(base, f"{name}_balanced_questions.json"), qa)
        GQA = Adapters.get("gqa")
        assert [os.path.basename(f) for f in GQA._locate_split_files(base, "test")] == [
            "test_balanced_questions.json"]
        assert [os.path.basename(f) for f in GQA._locate_split_files(base, "testdev")] == [
            "testdev_balanced_questions.json"]
        assert GQA._locate_split_files(base, "val") == [] and GQA._locate_split_files(base, "train") == []
        test = GQA.extract(str(tmp_path), splits=["test"])["test"]
        assert test.get_idx(0)[V.imgid] == "1" and V.label not in test.column_names
        with pytest.raises(FileNotFoundError):
            GQA.extract(str(tmp_path), splits=["train"])

    def test_vgqa_min_frequency(self, tmp_path):
        groups = [{"qas": [{"qa_id": i, "image_id": 10 + (i % 2), "question": f"what {i}?",
                            "answer": "dog" if i < 10 else f"rare{i}"} for i in range(12)]}]
        _write(str(tmp_path / "vgqa" / "qa_train.json"), groups)
        Adapters.get("vgqa").extract(str(tmp_path))
        assert len(Adapters.get("vgqa").load(str(tmp_path), split="train")) == 10


class TestProfiling:
    def test_duration_timer_and_trace(self, tmp_path):
        @profiling.get_duration
        def work(n):
            return sum(range(n))

        assert work.last_duration is None and work(1000) == 499500 and work.last_duration > 0
        timer = profiling.StepTimer()
        for n in (4, 8, 8):
            timer.tic()
            timer.toc(n, {"x": torch.ones(3)})
        summary = timer.summary()
        assert summary["steps"] == 2 and summary["items_per_s"] > 0
        assert summary["p50_s"] <= summary["p99_s"] and timer.summary(skip_first=False)["steps"] == 3
        assert profiling.StepTimer().summary() == {}
        with profiling.trace(str(tmp_path / "trace")) as prof:
            with profiling.annotate("port_region"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        assert any(e.key == "port_region" for e in prof.key_averages())
        assert os.listdir(tmp_path / "trace") == [f"trace_{os.getpid()}.json"]


class TestMemory:
    def test_oom_ladder(self):
        calls = []

        def fn(batch=8):
            calls.append(batch)
            if batch > 2:
                raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
            return batch

        assert memory.handle_cuda_oom(fn, alternatives=[{"batch": 4}, {"batch": 2}]) == 2
        assert calls == [8, 4, 2]
        with pytest.raises(torch.OutOfMemoryError):
            memory.handle_cuda_oom(fn, alternatives=[{"batch": 4}])

        def broken():
            raise ValueError("not oom")

        with pytest.raises(ValueError):
            memory.handle_cuda_oom(broken, alternatives=[{}])
        assert memory.is_oom_error(RuntimeError("CUDA error: out of memory"))
        assert not memory.is_oom_error(ValueError("nope")) and not JM.is_oom_error(ValueError("nope"))
        assert isinstance(memory.device_memory_stats(), dict)


def test_draw_boxes_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (60, 80, 3)).astype(np.uint8)
    boxes = np.array([[5, 5, 30, 40], [40, 10, 70, 50]], np.float32)
    got = viz.draw_boxes(torch.from_numpy(img), torch.from_numpy(boxes), labels=["cat", "dog"], scores=[0.9, 0.7])
    want = JViz.draw_boxes(img, boxes, labels=["cat", "dog"], scores=[0.9, 0.7])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (np.asarray(got) != img).any()
    dets = {"boxes": boxes, "obj_ids": np.array([0, 1]), "obj_probs": np.array([0.9, 0.7]),
            "mask": np.array([True, False])}
    path = viz.save_detections(str(tmp_path / "p.png"), img, dets, ["cat", "dog"])
    JViz.save_detections(str(tmp_path / "j.png"), img, dets, ["cat", "dog"])
    np.testing.assert_array_equal(np.asarray(viz.Image.open(path)), np.asarray(viz.Image.open(tmp_path / "j.png")))

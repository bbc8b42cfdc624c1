"""The port's ETL (adapters, Arrow tables, column types, the image
pipeline) held against the JAX package on the CPU.

One synthetic COCO-2014 + VQA corpus, drawn with numpy from a seed
(``tools.synthetic_corpus``), is extracted by both packages into two
copies of the same raw files. Rows, metadata (``img_to_row_map``, the
``*_frequencies`` counters, the ``huggingface`` key) and the answer tables
must be equal; each package reads the other's files; the column types of
every ported ``Features`` constructor give HF ``datasets``' Arrow types and
JSON; a write that raises leaves no temporary file. Both packages use
pyarrow for the tables, so pyarrow reads the port's bytes by construction.
"""

import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pytest

jax = pytest.importorskip("jax")

from vltk_tpu.adapters import Adapters as JAdapters
from vltk_tpu.adapters.base import Adapter as JAdapter
from vltk_tpu.features import Features as JFeatures
from vltk_tpu.processing import build_image_pipeline as j_pipeline
from vltk_tpu.config import VisionConfig as JVisionConfig

from vltk_tpu_torch.adapters import Adapters
from vltk_tpu_torch.adapters.base import Adapter
from vltk_tpu_torch.config import VisionConfig
from vltk_tpu_torch.features import Features
from vltk_tpu_torch.processing import Processors, build_image_pipeline
from vltk_tpu_torch.tools.synthetic_corpus import write_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(jax datadir, port datadir): the same raw files, each extracted by
    one package (coco2014 annotations, vqa train)."""
    root = tmp_path_factory.mktemp("corpus")
    jdir, pdir = str(root / "jax"), str(root / "port")
    write_corpus(jdir, n_images=6, n_questions=48, hw=(40, 56), seed=3)
    shutil.copytree(jdir, pdir)
    out = {}
    for tag, d, reg in (("jax", jdir, JAdapters), ("port", pdir, Adapters)):
        out[tag] = (reg.get("coco2014").extract(d), reg.get("vqa").extract(d)["train"])
    return jdir, pdir, out


def rows(adapter):
    return [adapter.get_idx(i) for i in range(len(adapter))]


def normalized(row):
    """Tensor columns as nested lists (the JAX rows' form)."""
    return {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in row.items()}


class TestETL:
    def test_rows_and_metadata_equal(self, corpus):
        _, _, out = corpus
        for (jad, pad) in zip(out["jax"], out["port"]):
            assert pad.metadata == jad.metadata
            assert pad.img_to_row_map == jad.img_to_row_map and pad.img_to_row_map
            assert rows(pad) == rows(jad)
            assert pad.table.schema.equals(jad.table.schema, check_metadata=True)
        jvqa, pvqa = out["jax"][1], out["port"][1]
        assert pvqa.answer_frequencies == jvqa.answer_frequencies
        assert sorted(pvqa.answer_frequencies) == ["2", "no", "red", "yes"]
        assert out["port"][0].labels_frequencies == out["jax"][0].labels_frequencies
        assert pvqa.get("COCO_train2014_000000000001") == jvqa.get("COCO_train2014_000000000001")

    def test_answer_tables_equal(self, corpus):
        from vltk_tpu.data.builder import _build_metadata_ids as j_ids

        from vltk_tpu_torch.data.builder import _build_metadata_ids as p_ids

        _, _, out = corpus
        want = j_ids([out["jax"][1]], [out["jax"][0]])
        assert p_ids([out["port"][1]], [out["port"][0]]) == want
        assert set(want) == {"answers", "labels", "objects"}

    def test_tables_cross_read(self, corpus):
        jdir, pdir, out = corpus
        for name in ("coco2014", "vqa"):
            got_j = JAdapters.get(name).load(pdir)  # the JAX package on the port's files
            got_p = Adapters.get(name).load(jdir)  # the port on the JAX package's files
            got_j = got_j.get("train", got_j) if isinstance(got_j, dict) else got_j
            got_p = got_p.get("train", got_p) if isinstance(got_p, dict) else got_p
            assert rows(got_j) == rows(got_p)
            assert got_j.metadata == got_p.metadata

    def test_imgid_filter(self, corpus):
        _, _, out = corpus
        keep = ["COCO_train2014_000000000004", "COCO_train2014_000000000001"]
        jsub, psub = out["jax"][0].imgid_filter(keep), out["port"][0].imgid_filter(keep)
        assert psub.img_to_row_map == jsub.img_to_row_map and len(psub) == 2
        assert rows(psub) == rows(jsub)


SCHEMA_NAMES = {
    "imgid": ("Imgid", ()), "text": ("String", ()), "words": ("StringList", ()), "n": ("Int", ()),
    "ints": ("IntList", ()), "f": ("Float", ()), "floats": ("FloatList", ()), "span": ("Span", ()),
    "ids": ("Ids", ()), "nested": ("NestedIds", ()), "boxes": ("Boxes", ()), "poly": ("Polygons", ()),
    "feats": ("FeaturesMatrix", (3, 5)), "boxtensor": ("Boxtensor", (3,)), "rows2d": ("Features2D", (4,)),
    "mask": ("Mask", (2, 3)), "f3d": ("Features3D", (2, 3)),
}


def schemas():
    return tuple(
        {name: getattr(feats, ctor)(*args) for name, (ctor, args) in SCHEMA_NAMES.items()}
        for feats in (JFeatures, Features)
    )


def typed_entries(rng):
    """Rows covering every column type: nulls, empty and nested lists,
    UTF-8 strings, fixed and ragged tensors."""
    out = []
    for i in range(5):
        out.append({
            "imgid": f"img{i}", "text": ["naïve café", "日本語", "", "plain", "x" * 40][i],
            "words": [["ä", "b"], [], ["hello world"], None, ["z"] * 3][i],
            "n": [1, None, -7, 2 ** 30, 0][i], "ints": [[1, 2], [], None, [5], [0, -1, 2]][i],
            "f": float(rng.normal()), "floats": [[0.3, 0.6], [], [1.0], None, [2.5]][i],
            "span": [[1, 2], [3, 4], None, [0, 0], [7, 9]][i],
            "ids": rng.normal(size=i).tolist(), "nested": [[[1.0], []], [], None, [[2.0, 3.0]], [[]]][i],
            "boxes": [[[0.0, 1.0, 2.0, 3.0]], [], None, [[1.0, 1.0, 1.0, 1.0]] * 2, [[5.0, 6.0, 7.0, 8.0]]][i],
            "poly": [[[[1.0, 2.0, 3.0]]], [], None, [[]], [[[0.5] * 6, [1.5] * 4]]][i],
            "feats": rng.normal(size=(3, 5)).astype(np.float32),
            "boxtensor": rng.uniform(0, 9, (3, 4)).astype(np.float32),
            "rows2d": rng.normal(size=(i + 1, 4)).astype(np.float32),
            "mask": rng.integers(0, 2, (2, 3)).astype(np.uint8),
            "f3d": rng.normal(size=(i, 2, 3)).astype(np.float32),
        })
    return out


class TestTables:
    def test_every_column_type_round_trips_and_cross_reads(self, tmp_path):
        """The same rows written by both packages: the same Arrow schema
        (field types, extension metadata, the huggingface JSON), the same
        metadata, equal rows in both directions."""
        jschema, pschema = schemas()
        jpath, ppath = str(tmp_path / "j" / "t.arrow"), str(tmp_path / "p" / "t.arrow")
        entries = typed_entries(np.random.default_rng(0))
        jad = JAdapter._write_entries([dict(e) for e in entries], jschema, jpath, extra_metadata={"k": [1, "ü"]})
        pad = Adapter._write_entries([dict(e) for e in entries], pschema, ppath, extra_metadata={"k": [1, "ü"]})
        assert pad.table.schema.equals(jad.table.schema, check_metadata=True)
        for fj, fp in zip(jad.table.schema, pad.table.schema):
            assert fp.metadata == fj.metadata, fp.name
        assert pad.metadata == jad.metadata
        assert pad.metadata["words_frequencies"] == {"ä": 1, "b": 1, "hello world": 1, "z": 3}
        want = rows(jad)
        for got in (rows(pad), rows(Adapter._load_one_arrow(jpath)), rows(JAdapter._load_one_arrow(ppath))):
            assert [normalized(r) for r in got] == want
        # fixed-shape tensors come back as numpy views of the mapped file
        row = pad.get_idx(2)
        assert isinstance(row["feats"], np.ndarray) and row["feats"].dtype == np.float32
        np.testing.assert_array_equal(row["feats"], entries[2]["feats"])
        assert isinstance(row["rows2d"], list)  # a ragged first dim stays lists

    def test_schema_json_is_hf_datasets(self):
        """The ``huggingface`` key and the Arrow types are HF ``datasets``'
        for every constructor, and HF reads the features back."""
        import datasets

        jschema, pschema = schemas()
        from vltk_tpu_torch.features import arrow_schema

        hf = datasets.Features(jschema)
        ours = arrow_schema(pschema)
        assert json.loads(ours.metadata[b"huggingface"])["info"]["features"] == json.loads(json.dumps(hf.to_dict()))
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, ours) as writer:
            writer.write_table(ours.empty_table())
        back = pa.ipc.open_stream(sink.getvalue()).schema  # tensor columns typed by HF's extension
        assert datasets.Features.from_arrow_schema(back) == datasets.Features.from_arrow_schema(hf.arrow_schema)
        for name, feat in pschema.items():
            want = hf.arrow_schema.field(name).type
            want = want.storage_type if isinstance(want, pa.ExtensionType) else want
            assert feat.arrow_type() == want, name

    def test_crash_atomic_write(self, tmp_path, monkeypatch):
        """A write that raises removes its temporary and leaves the earlier
        file as it was."""
        _, pschema = schemas()
        path = str(tmp_path / "t.arrow")
        entries = typed_entries(np.random.default_rng(1))
        Adapter._write_entries([dict(e) for e in entries], pschema, path)
        before = open(path, "rb").read()

        def broken(*args, **kwargs):
            raise OSError("disk full")

        monkeypatch.setattr(pa.ipc, "new_stream", broken)
        with pytest.raises(OSError, match="disk full"):
            Adapter._write_entries([dict(e) for e in entries[:2]], pschema, path)
        assert os.listdir(tmp_path) == ["t.arrow"]
        assert open(path, "rb").read() == before


class TestRegistry:
    def test_ported_and_unported(self):
        """Every adapter and processor name of the JAX package resolves (its
        registries list them all); an unknown name still raises."""
        from vltk_tpu.processing import Processors as JProcessors

        # other tests add tiny extraction adapters to either registry, so the
        # built-in eleven are checked as a subset of both
        jax_adapters = ("clevr", "clevrref", "coco2014", "cococaptions", "docvqa", "docvqavisn", "funsd", "gqa",
                        "vgqa", "visualgenome", "vqa")
        assert set(jax_adapters) <= set(JAdapters.avail()) and set(jax_adapters) <= set(Adapters.avail())
        for name in jax_adapters:
            assert Adapters.get(name.upper()).name() == name
        assert Adapters.is_visnlang("vqa") and Adapters.is_visn("coco2014") and Adapters.is_visnlang("vgqa")
        assert Adapters.is_extraction("frcnn") and "frcnn" in Adapters.avail()
        with pytest.raises(KeyError, match="unknown"):
            Adapters.get("no_such")
        with pytest.raises(NotImplementedError, match="downloads nothing"):
            Adapters.get("vqa").download("/nonexistent")
        assert Processors.avail() == JProcessors.avail()
        for name in ("PolygonProcessor", "rleprocessor", "ocrbox", "removebox", "xywhtoxyxy", "span"):
            assert Processors.get(name) is Processors.get(name.lower())
        with pytest.raises(KeyError, match="unknown"):
            Processors.get("no_such")


class TestImagePipeline:
    @pytest.mark.parametrize("over", [
        {}, {"size": (24, 40)}, {"transforms": ("fromfile", "resizetensor", "pad"), "bgr": False},
        {"transforms": ("fromfile",), "device_fused": True, "decode_dtype": "uint8"}, {"gray": True},
    ], ids=["default", "small", "rgb_pad", "decode_only", "gray"])
    def test_bitwise_equal_to_jax(self, corpus, over):
        jdir, _, _ = corpus
        path = os.path.join(jdir, "coco2014", "train", "COCO_train2014_000000000002.jpg")
        want = j_pipeline(JVisionConfig(**over))(path)
        got = build_image_pipeline(VisionConfig(**over))(path)
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k

    def test_transforms_without_config_fields(self, corpus):
        """ToTensor and GrayScale build from a config in the port (the JAX
        ``build_image_pipeline`` hands them every config field and raises): the JAX
        transforms applied one by one give the same entry."""
        from vltk_tpu.processing import image as jimg

        jdir, _, _ = corpus
        path = os.path.join(jdir, "coco2014", "train", "COCO_train2014_000000000003.jpg")
        got = build_image_pipeline(VisionConfig(transforms=("fromfile", "totensor", "grayscale", "pad"),
                                                size=(24, 40)))(path)
        want = jimg.Pad(canvas=(64, 64))(jimg.GrayScale()(jimg.ToTensor()(jimg.FromFile()(path))))
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w), err_msg=k)

    def test_rand_feats_transform(self):
        from vltk_tpu.processing import image as jimg

        from vltk_tpu_torch.processing import image as pimg

        j, p = jimg.RandFeats((4, 6, 3), seed=5), pimg.RandFeats((4, 6, 3), seed=5)
        for _ in range(2):
            a, b = j("x.jpg"), p("x.jpg")
            np.testing.assert_array_equal(b["image"], a["image"])
        assert pimg.canvas_for((800, 1333)) == jimg.canvas_for((800, 1333)) == (1344, 1344)

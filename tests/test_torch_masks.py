"""The port's mask decoders, mask and box processors and the adapter-side
helpers of ``utils/adapters.py`` held against the JAX package on the CPU.

* The native decoders (``native/src/maskops.cpp``, the JAX package's
  source, built by the port on its own) against their NumPy versions bit
  for bit, on fixed, fuzzed and malformed inputs (the cases of
  tests/test_native.py), and against the JAX package's native decoders
  bit for bit; the PIL polygon fill agrees with the native one up to
  boundary pixels (IoU > 0.9, as tests/test_native.py holds it).
* ``rle_encode``, ``seg_to_mask``, ``resize_binary_mask``, the box
  conversions, ``get_span_via_jaccard`` (ties included),
  ``map_ocr_predictions`` (with JAX's zero-subtoken regression) and
  ``histogram_from_counter``: equal to JAX's.
* ``PolygonProcessor``, ``RLEProcessor``, ``OCRBox``, ``XYWHtoXYXY`` and
  ``RemoveBox``: outputs bitwise equal to JAX's, alone and through
  ``build(config)`` on seeded COCO-polygon and CLEVR-ref corpora
  (``tools.synthetic_corpus``).
"""

import json
import os
import shutil
from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import vltk_tpu as J
from vltk_tpu import config as JC
from vltk_tpu.native import masks as jmasks
from vltk_tpu.processing import Processors as JProcessors
from vltk_tpu.utils import adapters as JA

import vltk_tpu_torch as P
from vltk_tpu_torch import config as PC
from vltk_tpu_torch import native
from vltk_tpu_torch.native import masks
from vltk_tpu_torch.processing import Processors
from vltk_tpu_torch.tools.synthetic_corpus import write_clevrref, write_corpus
from vltk_tpu_torch.utils import adapters as PA

BAD_POLYS = [
    [[float("nan")] * 8],
    [[float("inf"), 0.0, 5.0, 5.0, 0.0, 5.0]],
    [[1e30, 1e30, -1e30, 1e30, 0.0, -1e30]],
    [[0.0, 0.0]],
    [[0.0, 0.0, 1.0, 1.0]],
    [[]],
    [[5.0, 5.0, 5.0, 5.0, 5.0, 5.0]],
    [[-50.0, -50.0, 100.0, -50.0, 23.5, 100.0]],
]


FILL_FIXTURE = os.path.join(os.path.dirname(__file__), "data", "polygon_fill.json")


def mask_to_runs(mask):
    """Row-major run lengths of a {0, 1} mask, zeros first."""
    flat = np.concatenate([[0], mask.ravel().astype(np.int8)])
    edges = np.flatnonzero(np.diff(flat)).tolist() + [mask.size]
    return np.diff([0] + edges).tolist()


def runs_to_mask(runs, h, w):
    return np.repeat(np.arange(len(runs)) % 2, runs).astype(np.uint8).reshape(h, w)


def write_fill_fixture(path=FILL_FIXTURE):
    """Polygons and JAX's native fill of each: pairs at 64 x 64 (seed 10),
    the malformed cases at 32 x 32, and each instance of the seeded COCO
    polygon corpus of eight 480 x 640 images that the card's mask phase
    reads."""
    import tempfile

    cases = []
    rng = np.random.default_rng(10)
    for _ in range(4):
        cases.append(([random_polygon(rng), random_polygon(rng)[:10]], 64, 64))
    cases += [(polys, 32, 32) for polys in BAD_POLYS]
    with tempfile.TemporaryDirectory() as d:
        write_corpus(d, 8, 0, hw=(480, 640), seed=1, shapes="polygons")
        with open(os.path.join(d, "coco2014", "annotations", "instances_train2014.json")) as f:
            ann = json.load(f)["annotations"]
    cases += [(a["segmentation"], 480, 640) for a in ann]
    out = [{"polygons": polys, "height": h, "width": w, "runs": mask_to_runs(jmasks.polygons_fill(polys, h, w))}
           for polys, h, w in cases]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"cases": out}, f)


def random_polygon(rng, size=64):
    angles = np.sort(rng.uniform(0, 2 * np.pi, 8))
    r = rng.uniform(12, 22)
    cx, cy = rng.uniform(28, 36, 2)
    return np.stack([cx + r * np.cos(angles), cy + r * np.sin(angles)], -1).ravel().tolist()


class TestNativeDecoders:
    def test_fixed_cases_equal_the_plain_versions(self):
        h, w = 13, 7
        counts = [5, 10, 3, 20, 1, 13, 4, h * w - 56]
        np.testing.assert_array_equal(PA.rle_decode(counts, h, w), PA.rle_decode_plain(counts, h, w))
        pts = [0, 4, 10, 3, 30, 5]
        np.testing.assert_array_equal(PA.imagepoints_to_mask(pts, (6, 8)), PA.imagepoints_to_mask_plain(pts, (6, 8)))
        square = [[5.0, 5.0, 15.0, 5.0, 15.0, 15.0, 5.0, 15.0]]
        got = PA.polygon_to_mask(square, 30, 30)
        assert got.dtype == np.uint8 and 95 <= int(got.sum()) <= 125 and got[10, 6:14].all()

    def test_fuzzed_valid_inputs_equal_the_plain_versions_and_jax(self):
        """40 random RLE and point-run inputs (tests/test_native.py's fuzz,
        same seed): native == numpy bit for bit, and == the JAX package's
        native decoders."""
        rng = np.random.default_rng(7)
        for _ in range(40):
            h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
            runs, left = [], h * w
            while left > 0 and rng.random() > 0.05:
                r = int(rng.integers(1, left + 1))
                runs.append(r)
                left -= r
            got = masks.rle_decode(runs, h, w)
            np.testing.assert_array_equal(got, PA.rle_decode_plain(runs, h, w), err_msg=f"rle {runs} {h}x{w}")
            np.testing.assert_array_equal(got, jmasks.rle_decode(runs, h, w))
            pts = []
            for _ in range(int(rng.integers(0, 6))):
                pts += [int(rng.integers(0, h * w)), int(rng.integers(0, h * w))]
            got = masks.points_decode(pts, h, w)
            np.testing.assert_array_equal(got, PA.imagepoints_to_mask_plain(pts, (h, w)), err_msg=f"pts {pts}")
            np.testing.assert_array_equal(got, jmasks.points_decode(pts, h, w))

    def test_malformed_inputs_are_safe_and_equal_jax(self):
        """Negative runs, huge or non-finite coordinates, degenerate
        polygons: a {0, 1} mask of the right shape, equal to JAX's native
        output; a negative count is a zero-length run that still toggles,
        a negative start clamps to 0."""
        h, w = 16, 24
        for counts in ([-5, 9999999, -3, 4], [0, -1, 2**40, 3], [-(2**50)] * 8):
            m = masks.rle_decode(counts, h, w)
            assert m.shape == (h, w) and set(np.unique(m)) <= {0, 1}
            np.testing.assert_array_equal(m, jmasks.rle_decode(counts, h, w))
        assert masks.rle_decode([-5, 9999999], h, w).all()
        np.testing.assert_array_equal(masks.rle_decode([-5, 30, 7], h, w), PA.rle_decode_plain([-5, 30, 7], h, w))
        for pts in ([-100, 5, 10**15, 10**15, 5, -7], [2**62, 2**62]):
            m = masks.points_decode(pts, h, w)
            assert m.shape == (h, w) and set(np.unique(m)) <= {0, 1}
            np.testing.assert_array_equal(m, jmasks.points_decode(pts, h, w))
        m = masks.points_decode([-100, 5], h, w)
        assert m.ravel()[:5].all() and m.sum() == 5
        np.testing.assert_array_equal(m, PA.imagepoints_to_mask_plain([-100, 5], (h, w)))
        for polys in BAD_POLYS:
            m = masks.polygons_fill(polys, h, w)
            assert m.shape == (h, w) and set(np.unique(m)) <= {0, 1}
            np.testing.assert_array_equal(m, jmasks.polygons_fill(polys, h, w))
        assert masks.polygons_fill(BAD_POLYS[-1], h, w).sum() > 20
        assert not masks.polygons_fill([], h, w).any()

    def test_polygon_fill_equals_jax_and_is_close_to_pil(self):
        """Bitwise equal to JAX's native fill on pairs of polygons; within
        IoU 0.9 of PIL's on tests/test_native.py's five polygons (seed 0)."""
        rng = np.random.default_rng(10)
        for _ in range(8):
            polys = [random_polygon(rng), random_polygon(rng)[:10]]
            np.testing.assert_array_equal(PA.polygon_to_mask(polys, 64, 64), JA.polygon_to_mask(polys, 64, 64))
        rng = np.random.default_rng(0)
        for _ in range(5):
            flat = [random_polygon(rng)]
            got, want = PA.polygon_to_mask(flat, 64, 64), PA.polygon_to_mask_plain(flat, 64, 64)
            inter, union = np.sum((got > 0) & (want > 0)), np.sum((got > 0) | (want > 0))
            assert union > 0 and inter / union > 0.9, inter / union

    def test_fill_fixture_is_the_jax_native_fill(self):
        """The committed polygons and their expected masks (FILL_FIXTURE,
        which chip_smoke.py holds the card machine's build against) are
        JAX's native fill of them bit for bit, and the port's."""
        with open(FILL_FIXTURE) as f:
            cases = json.load(f)["cases"]
        assert len(cases) >= 20
        for case in cases:
            h, w = case["height"], case["width"]
            want = runs_to_mask(case["runs"], h, w)
            np.testing.assert_array_equal(jmasks.polygons_fill(case["polygons"], h, w), want)
            np.testing.assert_array_equal(masks.polygons_fill(case["polygons"], h, w), want)

    def test_plain_polygon_equals_jax_fallback(self, monkeypatch):
        """The PIL version is JAX's fallback (its native library off)."""
        rng = np.random.default_rng(1)
        polys = [random_polygon(rng), [1.0, 2.0, 30.0, 4.0, 12.0, 40.0]]
        monkeypatch.setenv("VLTK_NO_NATIVE", "1")
        want = JA.polygon_to_mask(polys, 50, 60)
        np.testing.assert_array_equal(PA.polygon_to_mask_plain(polys, 50, 60), want)
        np.testing.assert_array_equal(PA.rle_decode_plain([3, 7, 100, 2], 20, 9), JA.rle_decode([3, 7, 100, 2], 20, 9))

    def test_failed_build_raises(self, monkeypatch, tmp_path):
        """No quiet fallback: a source g++ refuses raises with its output."""
        src = tmp_path / "src"
        src.mkdir()
        for name in native._SOURCES:
            (src / name).write_text("this is not C++;\n")
        monkeypatch.setattr(native, "_SRC_DIR", str(src))
        monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
        monkeypatch.setattr(native, "_lib", None)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            masks.rle_decode([1, 2], 2, 2)


class TestHelpers:
    def test_masks_and_boxes(self):
        rng = np.random.default_rng(2)
        mask = (rng.random((9, 13)) > 0.6).astype(np.uint8)
        assert PA.rle_encode(mask) == JA.rle_encode(mask)
        np.testing.assert_array_equal(PA.rle_decode(PA.rle_encode(mask), 9, 13), mask)
        np.testing.assert_array_equal(PA.rle_decode(PA.rle_encode(1 - mask), 9, 13), 1 - mask)
        seg = {"counts": PA.rle_encode(mask), "size": [9, 13]}
        np.testing.assert_array_equal(PA.seg_to_mask(seg, 1, 1), JA.seg_to_mask(seg, 1, 1))
        polys = [random_polygon(rng)]
        np.testing.assert_array_equal(PA.seg_to_mask(polys, 64, 70), JA.seg_to_mask(polys, 64, 70))
        with pytest.raises(ValueError, match="compressed"):
            PA.seg_to_mask({"counts": "abc", "size": [2, 2]}, 2, 2)
        for size in ((5, 7), (30, 26), (9, 13)):
            np.testing.assert_array_equal(PA.resize_binary_mask(mask, size), JA.resize_binary_mask(mask, size))
        boxes = rng.uniform(0, 50, (3, 5, 4)).astype(np.float32)
        np.testing.assert_array_equal(PA.xywh_to_xyxy(boxes), JA.xywh_to_xyxy(boxes))
        np.testing.assert_array_equal(PA.xyxy_to_xywh(boxes), JA.xyxy_to_xywh(boxes))

    def test_jaccard_spans(self):
        """Random words and answers, exact matches, ties between equal
        character sets, answers below the threshold and empty inputs."""
        rng = np.random.default_rng(3)
        letters = list("abcdeft0123")
        words = ["".join(rng.choice(letters, int(rng.integers(1, 6)))) for _ in range(40)]
        cases = [(words, " ".join(words[i : i + k])) for i, k in ((3, 1), (10, 2), (25, 3), (38, 2))]
        cases += [(words, "".join(rng.choice(letters, int(rng.integers(2, 9))))) for _ in range(30)]
        cases += [(["ab", "ba", "ab"], "ab"), (["total", "due", "due", "total"], "due total"),
                  ([], "x"), (["a"], ""), (["zzz"], "amount due"), (["A B", "c"], "ab C")]
        for ws, ans in cases:
            for thr in (0.56, 0.2):
                assert PA.get_span_via_jaccard(ws, ans, thr) == JA.get_span_via_jaccard(ws, ans, thr), (ws, ans)
        assert PA.get_span_via_jaccard(["ab", "ba", "ab"], "ab")[0] == (0, 0)

    def test_ocr_prediction_mapping(self):
        """JAX's regression (tests/test_adapters_more.py): a word of zero
        sub-tokens keeps the alignment; then random maps in both modes."""
        assert PA.map_ocr_predictions([1, 1, 3], [2, 0, 1, -100, -100]) == [1, -100, 3]
        rng = np.random.default_rng(4)
        for _ in range(20):
            tokenmap = rng.integers(0, 4, int(rng.integers(1, 12))).tolist() + [-100] * int(rng.integers(0, 3))
            preds = rng.integers(0, 3, int(rng.integers(0, 30))).tolist()
            for mode in ("majority", "first"):
                assert PA.map_ocr_predictions(preds, tokenmap, mode) == JA.map_ocr_predictions(preds, tokenmap, mode)

    def test_histogram(self):
        counter = Counter({"cat": 12, "dog": 3, "a very long label that gets cut": 1})
        assert PA.histogram_from_counter(counter) == JA.histogram_from_counter(counter)
        assert PA.histogram_from_counter(counter, top_k=1) == JA.histogram_from_counter(counter, top_k=1)
        assert PA.histogram_from_counter(Counter()) == "(empty)"


def processor_pair(name, **kwargs):
    return JProcessors.get(name)(**kwargs), Processors.get(name)(**kwargs)


def assert_entries_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


class TestProcessors:
    def test_registry_resolves_every_jax_processor(self):
        assert Processors.avail() == JProcessors.avail()
        for name in JProcessors.avail():
            assert Processors.get(name.upper()).name() == name
        with pytest.raises(KeyError, match="unknown processor"):
            Processors.get("no_such")

    @pytest.mark.parametrize("max_len", [2, 6])
    def test_polygon_and_rle_processors(self, max_len):
        """Raw-size polygons / point runs -> masks at the model size, cut or
        padded to ``max_len``; an entry with no instance gives one zero
        mask, then the padding."""
        rng = np.random.default_rng(5)
        raw, size = (40, 56), (24, 40)
        polys = [[random_polygon(rng, 40)], [[2.0, 3.0, 30.0, 5.0, 14.0, 33.0]], []]
        runs = [[56 * y + 10, 20] for y in range(5, 15)]
        points = [sum(runs, []), [100, 40, 600, 90], [-5, 12]]
        for name, key, value in (("polygonprocessor", "poly", polys), ("rleprocessor", "RLE", points),
                                 ("polygonprocessor", "poly", [])):
            jp, pp = processor_pair(name, max_visual_seq_length=max_len)
            entry = {key: value, "size": size, "rawsize": raw}
            got, want = pp(dict(entry)), jp(dict(entry))
            assert_entries_equal(got, want)
            assert got["segmentation"].shape == (max_len, *size) and got["segmentation"].dtype == np.uint8
            assert got["segmentation"][: min(len(value), max_len)].any() or not value

    @pytest.mark.parametrize("add_cls", [False, True])
    def test_box_processors(self, add_cls):
        rng = np.random.default_rng(6)
        words = 5
        base = {
            "tokenbox": rng.uniform(0, 90, (words, 4)).round(1).tolist(),
            "tokenmap": np.asarray([2, 1, 0, 3, 1, 2][: words + int(add_cls)] + [-100] * 4, np.int32),
            "size": (24, 40), "scale": (0.5, 0.25), "rawsize": (96, 80),
        }
        jp, pp = processor_pair("ocrbox", max_visual_seq_length=12, add_visual_cls=add_cls)
        assert_entries_equal(pp(dict(base)), jp(dict(base)))
        no_scale = {k: v for k, v in base.items() if k != "scale"}
        assert_entries_equal(pp(dict(no_scale)), jp(dict(no_scale)))
        entry = {"tokenbox": base["tokenbox"], "box": np.asarray(base["tokenbox"][:2], np.float32),
                 "boxes": np.zeros((0, 4), np.float32), "imgid": "x"}
        jp, pp = processor_pair("xywhtoxyxy")
        got = pp(dict(entry))
        assert_entries_equal(got, jp(dict(entry)))
        np.testing.assert_array_equal(got["box"][:, 2:], entry["box"][:, :2] + entry["box"][:, 2:])
        jp, pp = processor_pair("removebox")
        assert_entries_equal(pp(dict(entry)), jp(dict(entry)))
        assert "box" not in pp(dict(entry))


@pytest.fixture(scope="module")
def mask_corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("masks")
    jdir, pdir = str(root / "jax"), str(root / "port")
    write_corpus(jdir, n_images=4, n_questions=0, hw=(40, 56), seed=8, shapes="polygons")
    write_clevrref(jdir, n_images=3, hw=(40, 56), seed=9, max_objects=5)
    shutil.copytree(jdir, pdir)
    return jdir, pdir


@pytest.mark.parametrize("dataset,proc,max_len", [("coco2014", "polygonprocessor", 4), ("clevrref", "rleprocessor", 6)])
def test_mask_processors_through_build(mask_corpora, dataset, proc, max_len):
    """``build(config)`` on a vision dataset with a mask processor: the
    batches of both packages bitwise equal, masks uint8 (B, n, h, w) at
    the resized image's size."""
    batches = []
    for build, mod, d in ((J.build, JC, mask_corpora[0]), (P.build, PC, mask_corpora[1])):
        cfg = mod.Config()
        cfg.data.update({"datadir": d, "train_datasets": [[dataset, "train"]], "train_batch_size": 2,
                         "num_workers": 0, "shuffle": False, "drop_last": False, "vision": {"size": (24, 40)},
                         "visn_processors": [proc], "ignore_segmentation": False})
        cfg.data.lang.update({"max_visual_seq_length": max_len})
        out = list(build(cfg)[0])
        for b in out:
            if "filepath" in b:
                b["filepath"] = [os.path.relpath(p, d) for p in b["filepath"]]
        batches.append(out)
    want, got = batches
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_entries_equal(g, w)
    seg = got[0]["segmentation"]
    size = tuple(int(x) for x in got[0]["size"][0])  # the resized image, aspect kept
    assert seg.dtype == np.uint8 and seg.shape[1:] == (max_len, *size) and size == (24, 34) and seg.any()


if __name__ == "__main__":
    write_fill_fixture()

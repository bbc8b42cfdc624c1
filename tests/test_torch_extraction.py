"""The port's FRCNN extraction adapter under the extraction pipeline, held
against the JAX package's on the CPU.

The tiny geometry of tests/test_loader.py's ``TinyFRCNN`` (R-50-C4 of
stem 8, res2 16, 4 detections of 128 features; raw and resized canvases
64 x 64, short side 48, longer at most 64). The weights are flax params
drawn with numpy from a seed at the shapes ``jax.eval_shape`` gives
(lecun-normal kernels and embeddings, zero biases, identity frozen norms;
flax's own ``init`` of the detector takes ~20 s even under ``jax.jit``),
carried to the port with ``convert.jax_frcnn_to_torch`` and written as the
state dict both adapters read through ``checkpoint=`` (the JAX adapter
converts it back with ``torch_frcnn_to_jax``). Both extract the same synthetic
COCO-2014 images, drawn with numpy from a seed, B=2 over 5 images (the last
batch filled with a copy). Features within rtol/atol 1e-4 (float32 convs
summed in another order, as tests/test_torch_models.py holds the step),
object and attribute ids and raw sizes equal, boxes (whole pixels) within
one pixel; the loader built on the JAX package's table gives bitwise equal
batches in both packages.
"""

import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import vltk_tpu as J
from vltk_tpu.adapters import Adapters as JAdapters

import vltk_tpu_torch as P
from vltk_tpu_torch.adapters import Adapters
from vltk_tpu_torch.adapters.frcnn import FRCNN, unpack
from vltk_tpu_torch.models.convert import jax_frcnn_to_torch
from vltk_tpu_torch.tools.synthetic_corpus import write_corpus

TINY = dict(
    depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4, rpn_hidden_channels=16,
    anchor_sizes=(16, 32), pre_nms_topk=32, post_nms_topk=8, num_classes=7, num_attrs=5,
    pooler_resolution=7, min_detections=4, max_detections=4,
)
EXTRACT = dict(TINY, max_detections_schema=4, visual_dim=128)
GEOM = dict(model_batch_size=2, raw_canvas=(64, 64), resized_canvas=(64, 64), short=48.0, maximum=64.0)


def flax_params(rng):
    """Flax FRCNN params at TINY: lecun-normal kernels and embeddings, zero
    biases and means, unit scales and variances."""
    import flax.traverse_util as tu
    import jax.numpy as jnp

    from vltk_tpu.models import FRCNN as JFRCNN, FRCNNConfig as JConfig

    shapes = jax.eval_shape(JFRCNN(cfg=JConfig(**TINY)).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray([[64.0, 64.0]]))["params"]
    out = {}
    for key, leaf in tu.flatten_dict(shapes, sep="/").items():
        shape, kind = leaf.shape, key.rsplit("/", 1)[-1]
        if kind in ("kernel", "embedding"):
            fan_in = shape[-1] if kind == "embedding" else int(np.prod(shape[:-1]))
            out[key] = (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            out[key] = np.full(shape, 1.0 if kind in ("scale", "var") else 0.0, np.float32)
    return tu.unflatten_dict(out, sep="/")


def tiny_adapter(base):
    return type("TinyFRCNN", (base,), dict(GEOM, _name="frcnn"))


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    root = tmp_path_factory.mktemp("extraction")
    jdir, pdir = str(root / "jax"), str(root / "port")
    write_corpus(jdir, n_images=5, n_questions=40, hw=(48, 60), seed=5)
    shutil.copytree(jdir, pdir)
    ckpt = str(root / "frcnn.pt")
    torch.save(jax_frcnn_to_torch(flax_params(np.random.default_rng(3))), ckpt)
    jout = tiny_adapter(JAdapters.get("frcnn")).extract(jdir, dataset_name="coco2014", checkpoint=ckpt, **EXTRACT)
    pout = tiny_adapter(FRCNN).extract(pdir, dataset_name="coco2014", checkpoint=ckpt, device="cpu", **EXTRACT)
    return jdir, pdir, ckpt, jout["train"], pout["train"]


class TestExtraction:
    def test_rows_match_the_jax_adapter(self, extracted):
        _, _, _, jad, pad = extracted
        assert len(pad) == len(jad) == 5 and pad.img_to_row_map == jad.img_to_row_map
        assert pad.column_names == jad.column_names
        for key in ("model_config", "processor_args"):
            assert pad.metadata[key] == jad.metadata[key], key
        n_boxes = 0
        for i in range(5):
            got, want = pad.get_idx(i), jad.get_idx(i)
            np.testing.assert_allclose(got["features"], np.asarray(want["features"], np.float32), rtol=1e-4,
                                       atol=1e-4)
            assert got["object_ids"] == want["object_ids"] and got["attr_ids"] == want["attr_ids"]
            assert got["rawsize"] == want["rawsize"] == [48, 60]
            np.testing.assert_allclose(got["boxes"], np.asarray(want["boxes"], np.float32), rtol=0, atol=1.0)
            n_boxes += int((np.asarray(want["boxes"]) != 0).any(-1).sum())
        assert n_boxes > 0

    def test_stored_rows_are_the_direct_step(self, extracted):
        """What the pipeline stored equals one direct call of the step on the
        same decoded batch: the pipeline adds nothing."""
        _, pdir, ckpt, _, pad = extracted
        adapter = tiny_adapter(FRCNN)
        bundle, _ = adapter.setup(checkpoint=ckpt, device="cpu", **TINY)
        proc = adapter.default_processor.build()
        ids = sorted(pad.img_to_row_map)[:2]
        entries = []
        for imgid in ids:
            entry = proc(os.path.join(pdir, "coco2014", "train", imgid + ".jpg"))
            entry["imgid"] = imgid
            entries.append(entry)
        batch = adapter.collate(entries)
        packed = bundle["step"](torch.from_numpy(batch["image"]), torch.from_numpy(batch["rawsize"])).numpy()
        for want in unpack(packed, ids, batch["rawsize"]):
            got = pad.get(want["imgid"])
            np.testing.assert_array_equal(got["features"], want["features"])
            np.testing.assert_array_equal(got["boxes"], np.asarray(want["boxes"], np.float32))
            assert got["object_ids"] == want["object_ids"] and got["attr_ids"] == want["attr_ids"]

    def test_loader_on_the_features_is_bitwise_jax(self, extracted):
        jdir, _, _, _, _ = extracted
        batches = []
        for build, mod in ((J.build, J), (P.build, P)):
            cfg = mod.Config()
            cfg.data.update({"train_datasets": [["vqa", "train"]], "extractor": "frcnn", "datadir": jdir,
                             "train_batch_size": 8, "num_workers": 0, "max_detections": 4, "visual_dim": 128,
                             "shuffle": False})
            cfg.data.lang.update({"max_seq_length": 12})
            batches.append(list(build(cfg)[0]))
        want, got = batches
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k, v in w.items():
                if isinstance(v, np.ndarray):
                    assert g[k].dtype == v.dtype, k
                    np.testing.assert_array_equal(g[k], v, err_msg=k)
                elif k != "filepath":
                    assert g[k] == v, k
        assert got[0]["features"].shape == (8, 4, 128) and got[0]["rawsize"].shape == (8, 2)

    def test_guards(self, extracted):
        jdir, _, ckpt, _, _ = extracted
        with pytest.raises(ValueError, match="host-only"):
            FRCNN.extract(jdir, dataset_name="coco2014", host_workers=2, device="cpu")
        with pytest.raises(FileNotFoundError):
            tiny_adapter(FRCNN).extract(jdir, dataset_name="coco2014", img_format="png", checkpoint=ckpt,
                                        device="cpu", **EXTRACT)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tiny_adapter(FRCNN).extract(jdir, dataset_name="coco2014", checkpoint=ckpt, **EXTRACT)
        assert Adapters.get("frcnn") is FRCNN

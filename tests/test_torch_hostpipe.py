"""The port's multi-process host ETL (``data/hostpipe.py``) held against its
own inline run and against the JAX package's, on the CPU.

tests/test_hostpipe.py's cases on the port: two spawned workers give the
inline run's rows in its order, with its row map and metadata; the stage
accounting; workers clamped to the images; ``FRCNN.extract(host_workers=2)``
of a host-only adapter runs sharded and a device adapter raises JAX's
``ValueError``; a class that spawned children cannot re-import is refused.
The JAX package's inline run over the same 8 images (``TinyHostDecodeFRCNN``
of both packages; seeded JPEGs of varied sizes under
``visualgenome/train``) gives the same rows. The two spawn runs (one
through ``extract``, one clamped) happen once, in the module fixture.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from vltk_tpu.data import hostpipe as JH

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.frcnn import FRCNN
from vltk_tpu_torch.data.hostpipe import HostDecodeFRCNN, TinyHostDecodeFRCNN, run_sharded_split

N_IMAGES = 8
SIZES = [(40, 64), (64, 48), (96, 96), (32, 80), (120, 70)]  # the last larger than the canvas


def write_images(d):
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(d, exist_ok=True)
    for i in range(N_IMAGES):
        h, w = SIZES[i % len(SIZES)]
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(os.path.join(d, f"{1000 + i}.jpg"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hostpipe")
    pdir, jdir = str(root / "port"), str(root / "jax")
    write_images(os.path.join(pdir, "visualgenome", "train"))
    shutil.copytree(pdir, jdir)
    id2path = {str(1000 + i): os.path.join(pdir, "visualgenome", "train", f"{1000 + i}.jpg") for i in range(N_IMAGES)}
    jid2path = {k: p.replace(pdir, jdir) for k, p in id2path.items()}
    out = {"id2path": id2path, "root": root}
    out["inline"], out["inline_stats"] = run_sharded_split(TinyHostDecodeFRCNN, id2path, str(root / "inline.arrow"))
    out["extract_inline"] = TinyHostDecodeFRCNN.extract(pdir, dataset_name="visualgenome")["train"]
    out["extract_pooled"] = TinyHostDecodeFRCNN.extract(pdir, dataset_name="visualgenome", host_workers=2)["train"]
    two = {k: id2path[k] for k in sorted(id2path)[:2]}
    out["clamped"], out["clamped_stats"] = run_sharded_split(TinyHostDecodeFRCNN, two, str(root / "clamp.arrow"),
                                                             num_workers=8)
    out["jax_inline"], _ = JH.run_sharded_split(JH.TinyHostDecodeFRCNN, jid2path, str(root / "jax_inline.arrow"))
    out["jax_extract"] = JH.TinyHostDecodeFRCNN.extract(jdir, dataset_name="visualgenome")["train"]
    return out


def rows(adapter):
    return [{k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in adapter.get_idx(i).items()}
            for i in range(len(adapter))]


def pooled_path(runs):
    return os.path.join(str(runs["root"]), "port", "visualgenome", "tinyhostdecodefrcnn", "train.arrow")


def test_two_workers_equal_inline(runs):
    pooled, inline, direct = runs["extract_pooled"], runs["extract_inline"], runs["inline"]
    assert len(pooled) == len(inline) == len(direct) == N_IMAGES
    assert rows(pooled) == rows(inline) == rows(direct)
    assert pooled.img_to_row_map == inline.img_to_row_map
    for imgid, row in pooled.img_to_row_map.items():
        assert pooled.table[V.imgid][row].as_py() == imgid
    # the merged file is the inline file: columns, row map, counters and the
    # column types' metadata, plus extract's own keys
    assert pooled.table.schema.equals(inline.table.schema, check_metadata=True)
    assert pooled.metadata == inline.metadata and pooled.metadata["model_config"] == {"model": "host-decode-stub"}
    assert [r[V.rawsize] for r in rows(pooled)][4] == [96, 56]  # 120 x 70 shrunk onto the 96 x 96 canvas
    assert not [f for f in os.listdir(os.path.dirname(pooled_path(runs))) if ".shard" in f or f.endswith(".tmp")]


def test_stage_accounting(runs):
    stats = runs["extract_pooled"].host_stats
    agg = stats["aggregate"]
    assert agg["n_images"] == N_IMAGES and agg["workers"] == 2 and agg["n_batches"] == 2
    assert agg["decode_s"] > 0 and agg["wall_s"] > 0 and agg["img_per_s"] > 0
    assert {"decode_s", "collate_s", "forward_s", "write_s"} <= set(agg)
    assert sorted(s["n_images"] for s in stats["per_worker"]) == [4, 4]
    assert runs["inline_stats"]["aggregate"]["workers"] == 1 and runs["inline_stats"]["per_worker"][0]["n_batches"] == 2


def test_workers_clamped_to_items(runs):
    assert runs["clamped"].num_rows == 2 and runs["clamped_stats"]["aggregate"]["workers"] == 2
    assert rows(runs["clamped"]) == rows(runs["inline"])[:2]


def test_rows_equal_jax(runs):
    """The port's pooled and inline tables against the JAX package's inline
    run: rows, row maps and counters equal (JAX's merge drops the
    ``huggingface`` key, the port's keeps it)."""
    for port, jx in ((runs["extract_pooled"], runs["jax_extract"]), (runs["inline"], runs["jax_inline"])):
        assert rows(port) == rows(jx)
        assert port.img_to_row_map == jx.img_to_row_map
        drop = lambda m: {k: v for k, v in m.items() if k not in ("huggingface", "dataset")}  # noqa: E731
        assert drop(port.metadata) == drop(jx.metadata)


def test_device_adapter_rejected(tmp_path):
    with pytest.raises(ValueError, match="host-only"):
        FRCNN.extract(str(tmp_path), dataset_name="coco2014", host_workers=2)


def test_local_class_rejected(runs, tmp_path):
    class Local(HostDecodeFRCNN):
        pass

    with pytest.raises(ValueError, match="module scope"):
        run_sharded_split(Local, runs["id2path"], str(tmp_path / "x.arrow"), num_workers=2)
    with pytest.raises(ValueError, match="empty"):
        run_sharded_split(TinyHostDecodeFRCNN, {}, str(tmp_path / "y.arrow"))


def test_import_builds_nothing():
    """What a spawned child imports (the module and the adapter class)
    starts no CUDA context and builds no library."""
    code = (
        "import torch, vltk_tpu_torch.data.hostpipe as h, vltk_tpu_torch.native as n, vltk_tpu_torch.ops._build as b;"
        "h._resolve_adapter(h._adapter_spec(h.HostDecodeFRCNN));"
        "assert not torch.cuda.is_initialized() and n._lib is None and not getattr(b, '_loaded', None);"
        "print('ok')"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

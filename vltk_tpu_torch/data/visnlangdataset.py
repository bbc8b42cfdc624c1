"""The image-id join of language datasets with vision sources:
counterpart of ``vltk_tpu/data/visnlangdataset.py``.

Two orders:

* text first (the default): one row a sentence, its vision entry fetched
  by image id;
* image first: one row an image, its sentences encoded in one call and
  stacked to ``max_text_per_img`` with a ``text_mask`` (more sentences
  than that are cut, with one warning that counts them).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.data.basedataset import CollatedSets
from vltk_tpu_torch.data.langdataset import LangHandler
from vltk_tpu_torch.data.visndataset import VisnHandler


class VisionLanguageDataset:
    def __init__(
        self,
        config,
        text_sets: CollatedSets,
        visn: VisnHandler,
        lang: LangHandler,
        visnlang_processors: Sequence[Callable] = (),
        max_text_per_img: int = 8,
    ):
        self.config = config
        self.texts = text_sets
        self.visn = visn
        self.lang = lang
        self.visnlang_processors = list(visnlang_processors)
        self.max_text_per_img = int(max_text_per_img)
        self._image_side_keys = None

        self._check_and_tighten()
        if config.img_first:
            self._uniq_imgs = sorted(self._text_imgids & self._visn_imgids)
            self._img_texts = self._index_texts_by_img()
            self._warn_if_truncating()
            n = len(self._uniq_imgs)
        else:
            self._rows = self._usable_text_rows()
            n = len(self._rows)
        if config.percent < 1.0:
            n = max(1, int(n * config.percent))
            if config.img_first:
                self._uniq_imgs = self._uniq_imgs[:n]
            else:
                self._rows = self._rows[:n]
        self._n = n

    def _check_and_tighten(self) -> None:
        """The image ids the text and the vision sides share; none raises."""
        self._text_imgids = set(self.texts.imgids)
        visn_ids = set()
        if self.visn.extractors is not None:
            visn_ids |= set(self.visn.extractors.imgids)
        visn_ids |= set(self.visn.imgid2path)
        if self.visn.annotations is not None and not visn_ids:
            visn_ids |= set(self.visn.annotations.imgids)
        if self.config.rand_feats is not None or self.config.ignore_image:
            visn_ids = visn_ids or set(self._text_imgids)
        self._visn_imgids = visn_ids
        if not self._text_imgids & visn_ids:
            raise ValueError(
                "no image-id overlap between language and vision datasets (text ids like "
                f"{sorted(self._text_imgids)[:3]}, vision ids like {sorted(visn_ids)[:3]}): check adjust_imgid"
            )

    def _all_text_imgids_by_row(self) -> List[str]:
        """One column read an adapter, not one row read a row."""
        out: List[str] = []
        for _, _, adapter in self.texts.ranges.parts:
            out.extend(str(v) for v in adapter.table.column(V.imgid).to_pylist())
        return out

    def _usable_text_rows(self) -> List[int]:
        return [i for i, imgid in enumerate(self._all_text_imgids_by_row()) if imgid in self._visn_imgids]

    def _warn_if_truncating(self) -> None:
        t = self.max_text_per_img
        over = {i: len(r) for i, r in self._img_texts.items() if len(r) > t}
        if not over:
            return
        worst = max(over.values())
        dropped = sum(n - t for n in over.values())
        total = sum(len(r) for r in self._img_texts.values())
        warnings.warn(
            f"img_first with max_text_per_img={t} TRUNCATES {len(over)}/{len(self._img_texts)} images (max "
            f"{worst} sentences/image in this data): {dropped}/{total} sentences will never be seen. Raise "
            f"DataConfig.max_text_per_img to at least {worst} to train on all text.",
            stacklevel=3,
        )

    def _index_texts_by_img(self) -> Dict[str, List[int]]:
        by_img: Dict[str, List[int]] = {}
        for i, imgid in enumerate(self._all_text_imgids_by_row()):
            if imgid in self._visn_imgids:
                by_img.setdefault(imgid, []).append(i)
        return by_img

    @property
    def image_side_keys(self) -> frozenset:
        """Every key the vision side gives an entry, and the image id: the
        keys ``transpose_vl`` repeats a sentence instead of flattening."""
        if self._image_side_keys is None:
            probe = self._uniq_imgs[0] if self.config.img_first else str(self.texts[self._rows[0]][V.imgid])
            self._image_side_keys = frozenset(self.visn.get_entry(probe)) | {V.imgid}
        return self._image_side_keys

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self._get_img_first(idx) if self.config.img_first else self._get_text_first(idx)

    def _get_text_first(self, idx: int) -> Dict[str, Any]:
        entry = self.lang.encode_entry(self.texts[self._rows[idx]])
        for k, v in self.visn.get_entry(str(entry[V.imgid])).items():
            entry.setdefault(k, v)
        for proc in self.visnlang_processors:
            entry = proc(entry)
        return _clean(entry)

    def _get_img_first(self, idx: int) -> Dict[str, Any]:
        """One image with its sentences stacked to (T, L) and a text mask."""
        imgid = self._uniq_imgs[idx]
        rows = self._img_texts[imgid][: self.max_text_per_img]
        text_entries = self.lang.encode_batch([self.texts[r] for r in rows])
        t = self.max_text_per_img
        entry: Dict[str, Any] = {V.imgid: imgid}
        entry.update(self.visn.get_entry(imgid))
        stacked: Dict[str, List] = {}
        strings: Dict[str, List] = {}
        for te in text_entries:
            for k, v in te.items():
                if k == V.imgid:
                    continue
                if isinstance(v, (str, bytes)):
                    # strings stay lists (np.isscalar(str) is True)
                    strings.setdefault(k, []).append(v)
                elif isinstance(v, np.ndarray) or np.isscalar(v):
                    stacked.setdefault(k, []).append(np.asarray(v))
        for k, vals in stacked.items():
            arr = np.stack(vals)
            pad = t - arr.shape[0]
            if pad > 0:
                fill = np.zeros((pad, *arr.shape[1:]), arr.dtype)
                if "label" in k:  # labels, label, masked_labels, tokenlabels
                    fill += self.lang.config.ignore_id
                arr = np.concatenate([arr, fill])
            entry[k] = arr[:t]
        for k, vals in strings.items():
            entry[k] = (vals + [""] * t)[:t]
        mask = np.zeros((t,), np.int32)
        mask[: len(text_entries)] = 1
        entry["text_mask"] = mask
        entry["n_texts"] = np.int32(len(text_entries))
        for proc in self.visnlang_processors:
            entry = proc(entry)
        return _clean(entry)


def _clean(entry: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the join's bookkeeping keys."""
    entry.pop("__dataset__", None)
    entry.pop("__split__", None)
    return entry

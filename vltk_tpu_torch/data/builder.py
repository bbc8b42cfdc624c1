"""One config -> (train loader, eval loader): counterpart of
``vltk_tpu/data/builder.py``.

Parse the dataset / split pairs, tell vision-language datasets from vision
ones, load or extract their Arrow tables, add the vision datasets the text
ones point at (their annotations, image files and, with ``extractor``,
their extracted features), build the global string -> id tables (shared by
the train and eval loaders), and wrap it all in loaders.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.data.basedataset import CollatedSets
from vltk_tpu_torch.data.langdataset import LangHandler
from vltk_tpu_torch.data.loader import VisionLanguageLoader, VisionLoader
from vltk_tpu_torch.data.visndataset import VisnHandler
from vltk_tpu_torch.data.visnlangdataset import VisionLanguageDataset
from vltk_tpu_torch.inspection import collect_args_to_func

_ALIASES = {
    "val": "val", "valid": "val", "validation": "val", "eval": "val", "evaluation": "val",
    "dev": "dev", "test": "test", "train": "train",
}


def split_handler(split: str) -> str:
    return _ALIASES.get(str(split).lower(), str(split).lower())


def parse_datasets(specs) -> List[Tuple[str, str]]:
    """``[["vqa", "train"], ("gqa", "val")]`` (or one pair) -> [(name, split)]."""
    if not specs:
        return []
    if isinstance(specs[0], str):
        specs = [specs]
    return [(str(item[0]).lower(), split_handler(item[1] if len(item) > 1 else "train")) for item in specs]


def _load_vl_adapter(cls, datadir: str, split: str, reextract: bool):
    adapter = None if reextract else cls.load(datadir, split=split)
    if isinstance(adapter, dict):
        adapter = adapter.get(split)
    if adapter is None:
        adapter = cls.extract(datadir, splits=[split]).get(split)
    if adapter is None:
        raise FileNotFoundError(f"could not load or extract {cls.name()}:{split} under {datadir}")
    return adapter


def _vision_names_for(vl_classes, vl_splits) -> Dict[str, List[str]]:
    """The vision datasets and splits the chosen text splits point at."""
    out: Dict[str, List[str]] = {}
    for cls, split in zip(vl_classes, vl_splits):
        for vname, vsplits in cls.data_info.get(split, {}).items():
            names = out.setdefault(vname.lower(), [])
            names.extend(s for s in vsplits if s not in names)
    return out


def _build_metadata_ids(vl_adapters: Sequence, annotation_adapters: Sequence,
                        filedict: Optional[Mapping[str, str]] = None) -> Dict[str, Dict[str, int]]:
    """String -> id tables: ``answers`` over the text datasets' answers,
    ``labels`` / ``objects`` over the annotations' counters, and any
    ``metadata_filedict`` table read from its file, each sorted."""
    ids: Dict[str, Dict[str, int]] = {}
    answers: set = set()
    for adapter in vl_adapters:
        answers |= set(getattr(adapter, "answer_frequencies", {}) or {})
    if answers:
        ids["answers"] = {a: i for i, a in enumerate(sorted(answers))}
    label_strings: set = set()
    for adapter in annotation_adapters:
        for key, value in adapter.metadata.items():
            if key.endswith("_frequencies") and isinstance(value, dict):
                label_strings |= set(value)
    if label_strings:
        table = {s: i for i, s in enumerate(sorted(label_strings))}
        ids[V.labels] = table
        ids[V.objects] = table
    for key, path in (filedict or {}).items():
        with open(path) as f:
            ids[key] = json.load(f)
    return ids


class VisionOnlyDataset:
    """One row an image id, for ``VisionLoader``."""

    def __init__(self, imgids: List[str], visn: VisnHandler):
        self.imgids = list(imgids)
        self.visn = visn

    def __len__(self) -> int:
        return len(self.imgids)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.visn.get_entry(self.imgids[idx])


def init_datasets(config):
    """(train loader, eval loader) of a Config or DataConfig; None where no
    dataset is named."""
    from vltk_tpu_torch.adapters import Adapters

    cfg = getattr(config, "data", config)
    shared: Dict[str, Any] = {}
    loaders = {}
    for tag, specs, train in (("train", cfg.train_datasets, True), ("eval", cfg.eval_datasets, False)):
        specs = parse_datasets(specs)
        loaders[tag] = _build_one(cfg, Adapters, cfg.datadir, specs, train, shared) if specs else None
    return loaders["train"], loaders["eval"]


def _build_one(cfg, Adapters, datadir: str, specs, train: bool, shared: Dict):
    vl_parts: List[Tuple[str, str, Any]] = []
    vl_classes, vl_splits = [], []
    vision_only_parts: List[Tuple[str, str]] = []
    for name, split in specs:
        cls = Adapters.get(name)
        if Adapters.is_visnlang(name):
            vl_parts.append((name, split, _load_vl_adapter(cls, datadir, split, cfg.reextract)))
            vl_classes.append(cls)
            vl_splits.append(split)
        else:
            vision_only_parts.append((name, split))

    vision_names = _vision_names_for(vl_classes, vl_splits)
    for name, split in vision_only_parts:
        names = vision_names.setdefault(name, [])
        if split not in names:
            names.append(split)

    annotation_parts: List[Tuple[str, str, Any]] = []
    extractor_parts: List[Tuple[str, str, Any]] = []
    imgid2path: Dict[str, str] = {}
    for vname, vsplits in vision_names.items():
        if vname not in Adapters:
            continue
        vcls = Adapters.get(vname)
        loaded = None if cfg.reextract else vcls.load(datadir)
        if loaded is None and not cfg.ignore_annotations:
            try:  # extract from the raw files once
                loaded = vcls.extract(datadir) or None
            except (FileNotFoundError, NotImplementedError):
                loaded = None
        if loaded is not None:
            if not isinstance(loaded, dict):
                loaded = {loaded.split or "train": loaded}
            annotation_parts.extend((vname, s, a) for s, a in loaded.items())
        if not cfg.ignore_filepath:
            for s in vsplits or [None]:
                imgid2path.update(vcls.load_imgid2path(datadir, s))
        if cfg.extractor:
            eload = Adapters.get(cfg.extractor).load(os.path.join(datadir, vname))
            if eload is not None:
                if not isinstance(eload, dict):
                    eload = {eload.split or "train": eload}
                extractor_parts.extend((vname, s, a) for s, a in eload.items())

    metadata_ids = _build_metadata_ids(
        [a for _, _, a in vl_parts], [a for _, _, a in annotation_parts], cfg.metadata_filedict
    )
    # the tables are shared by the train and eval loaders: strings the
    # second loader brings get fresh ids after the first's
    shared_tables = shared.setdefault("metadata_ids", {})
    for key, table in metadata_ids.items():
        merged = shared_tables.setdefault(key, {})
        for s in sorted(table):
            if s not in merged:
                merged[s] = len(merged)

    from vltk_tpu_torch.processing import Processors

    def build_procs(names, **init_kwargs):
        return [Processors.get(n)(**collect_args_to_func(Processors.get(n).__init__, init_kwargs)) for n in names]

    lang = LangHandler(cfg.lang, metadata_ids=shared["metadata_ids"], lang_processors=cfg.lang_processors)
    proc_kwargs = dict(
        tokenizer=lang.tokenizer,
        max_visual_seq_length=cfg.lang.max_visual_seq_length,
        max_seq_length=cfg.lang.max_seq_length,
        metadata_ids=shared["metadata_ids"],
        ignore_id=cfg.lang.ignore_id,
    )
    visn = VisnHandler(
        cfg,
        imgid2path=imgid2path,
        extractor_sets=CollatedSets(extractor_parts) if extractor_parts else None,
        annotation_sets=CollatedSets(annotation_parts) if annotation_parts else None,
        metadata_ids=shared["metadata_ids"],
        visn_processors=build_procs(cfg.visn_processors, **proc_kwargs),
    )
    if vl_parts:
        dataset = VisionLanguageDataset(
            cfg, CollatedSets(vl_parts), visn, lang,
            visnlang_processors=build_procs(cfg.visnlang_processors, **proc_kwargs),
            max_text_per_img=cfg.max_text_per_img,
        )
        loader = VisionLanguageLoader(cfg, dataset, train=train)
    else:
        ids = sorted(imgid2path) if imgid2path else sorted({i for _, _, a in annotation_parts for i in a.imgids})
        loader = VisionLoader(cfg, VisionOnlyDataset(ids, visn), train=train)
    loader.metadata_ids = shared["metadata_ids"]
    loader.tokenizer = lang.tokenizer if vl_parts else None
    return loader

"""Configuration of the port's train layer.

A copy of the parts of ``vltk_tpu/config.py`` that the data plane, the
train layer and the experiments read: ``BaseConfig`` (iteration,
``to_dict``, recursive ``update`` with string coercion and overwrite
tracking), ``LangConfig`` (the tokenizer, ``ignore_id``, the sequence
lengths and the pretraining corruption rates), ``VisionConfig`` (the host
image pipeline), ``DataConfig`` (datasets, extractor, processors,
iteration order, batching, capacities, ETL control, the host feed and host
shards), ``TrainConfig`` (every field, same defaults), ``ModelsConfig`` /
``ModelConfig`` and ``EvalConfig`` (declared, as in the JAX package, where
nothing reads them either), ``MeshConfig`` and ``Config`` (``logdir``,
``checkpoint_dir``, ``test_run``, ``break_loop_on_test``, ``save_on_crash``;
``from_flags`` and ``unflatten_dict`` for the CLI). Field names and defaults are
the JAX package's. The default tokenizer ``"BertWordPieceTokenizer"`` runs
on the port's native WordPiece over the same vocabulary.

``MeshConfig`` is honoured: ``build()`` makes the ``parallel.Mesh`` (data,
tensor, sequence and expert parallelism, ZeRO-1; ``pipe`` ranks are
replicas outside ``parallel.gpipe_spmd``). ``accum_steps`` is honoured too.
Left out because no code reads them: ``LangConfig.pad_direction`` and
``add_special_tokens``, ``DataConfig.redownload``, and ``Config.email``
(the JAX CLI mails its crash report; the port's writes it to disk only);
``update`` raises ``KeyError`` on them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Tuple


def _parse_nested(text: str):
    """``(a,(b,1))`` / ``[x,2]`` CLI literals with unquoted strings; raises
    ValueError on trailing input."""
    pos = 0

    def parse():
        nonlocal pos
        open_ch = text[pos]
        close_ch = ")" if open_ch == "(" else "]"
        pos += 1
        items, token = [], ""

        def flush():
            nonlocal token
            if token.strip():
                items.append(_coerce(token.strip()))
            token = ""

        while pos < len(text):
            ch = text[pos]
            if ch in "([":
                items.append(parse())
            elif ch == close_ch:
                flush()
                pos += 1
                return tuple(items) if open_ch == "(" else list(items)
            elif ch == ",":
                flush()
                pos += 1
            else:
                token += ch
                pos += 1
        flush()
        return tuple(items) if open_ch == "(" else list(items)

    out = parse()
    if pos != len(text):
        raise ValueError(f"trailing input after position {pos} in {text!r}")
    return out


def _coerce(value: Any) -> Any:
    """CLI-style strings to Python values: booleans, None, tuples/lists,
    ints, floats; anything else as it is."""
    if not isinstance(value, str):
        return value
    low = value.strip()
    if low.lower() in ("true", "false"):
        return low.lower() == "true"
    if low.lower() in ("none", "null"):
        return None
    if (low.startswith("(") and low.endswith(")")) or (low.startswith("[") and low.endswith("]")):
        return _parse_nested(low)
    for cast in (int, float):
        try:
            return cast(low)
        except ValueError:
            pass
    return value


def unflatten_dict(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a.b": 1}`` -> ``{"a": {"b": 1}}``: dot flags into nested updates."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        cur = out
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = value
    return out


@dataclass
class BaseConfig:
    """Shared behaviour of the config dataclasses."""

    def __post_init__(self):
        object.__setattr__(self, "_overwritten", {})
        self._check_ported()

    def _check_ported(self) -> None:
        """Raise on a field the port does not honour yet."""

    def __iter__(self):
        for f in fields(self):
            yield f.name, getattr(self, f.name)

    def to_dict(self) -> Dict[str, Any]:
        return {
            name: value.to_dict() if isinstance(value, BaseConfig) else value
            for name, value in self
        }

    def update(self, updates: Dict[str, Any]) -> "BaseConfig":
        """Recursively apply ``updates``; unknown keys raise KeyError; the
        previous value of every changed field is kept in ``overwritten``."""
        known = {f.name for f in fields(self)}
        for key, value in updates.items():
            if key.startswith("_"):
                continue
            if key not in known:
                raise KeyError(
                    f"{type(self).__name__} has no config field {key!r}; known: {sorted(known)}"
                )
            current = getattr(self, key)
            if isinstance(current, BaseConfig) and isinstance(value, dict):
                current.update(value)
            else:
                coerced = _coerce(value)
                if coerced != current:
                    self._overwritten[key] = current
                object.__setattr__(self, key, coerced)
        self._check_ported()
        return self

    @property
    def overwritten(self) -> Dict[str, Any]:
        return dict(self._overwritten)

    def print_config(self) -> str:
        """Print (and return) ``to_dict()`` as indented JSON."""
        text = json.dumps(self.to_dict(), indent=2, default=str)
        print(text)
        return text


@dataclass
class LangConfig(BaseConfig):
    tokenizer: str = "BertWordPieceTokenizer"
    from_transformers: bool = False
    vocab_path: Optional[str] = None
    lowercase: bool = True
    max_seq_length: int = 128
    max_visual_seq_length: int = 128
    mask_rate: float = 0.15
    mask_token_rate: float = 0.8
    random_token_rate: float = 0.1
    sentence_match_rate: float = 0.5
    feature_mask_rate: float = 0.15
    ignore_id: int = -100


@dataclass
class VisionConfig(BaseConfig):
    """Host image pipeline: ``transforms`` are names of the image
    transforms of ``processing``; each transform gets the other fields its
    constructor declares."""

    transforms: Tuple[str, ...] = ("fromfile", "resizetensor", "normalize")
    gray: bool = False
    # "float32", or "uint8" for decode-only pipelines feeding a
    # preprocess on the device
    decode_dtype: str = "float32"
    size: Tuple[int, int] = (800, 1333)
    mode: str = "bilinear"
    pad_value: float = 0.0
    mean: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)
    sdev: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    bgr: bool = True
    # True: a device program resizes, normalises and pads, so the host
    # only decodes; False: the host pipeline ends on a fixed canvas
    device_fused: bool = False

    def build(self):
        """The composed host pipeline (``processing.build_image_pipeline``)."""
        from vltk_tpu_torch.processing import build_image_pipeline

        return build_image_pipeline(self)


@dataclass
class DataConfig(BaseConfig):
    # what to load
    train_datasets: Tuple = ()
    eval_datasets: Tuple = ()
    extractor: Optional[str] = None
    datadir: str = "/tmp/vltk_tpu_data"
    # processors
    visn_processors: Tuple[str, ...] = ()
    lang_processors: Tuple[str, ...] = ()
    visnlang_processors: Tuple[str, ...] = ()
    # iteration order
    img_first: bool = False
    shuffle: bool = True
    percent: float = 1.0
    # stage switches
    ignore_image: bool = False
    ignore_filepath: bool = False
    ignore_annotations: bool = False
    ignore_segmentation: bool = True
    rand_feats: Optional[Tuple[int, ...]] = None
    # batching
    train_batch_size: int = 32
    eval_batch_size: int = 64
    num_workers: int = 4
    drop_last: bool = True
    # fixed-shape capacities
    max_detections: int = 36
    visual_dim: int = 2048
    # img_first: sentences kept per image (the dataset warns once, with
    # counts, when the data has more)
    max_text_per_img: int = 8
    # ETL control
    reextract: bool = False
    metadata_filedict: Optional[Dict[str, str]] = None
    # host feed: batches fetched ahead
    prefetch_depth: int = 2
    # host shards: every process reads a disjoint, equal-length slice of
    # the seeded global order; shard_rank None = the torch.distributed
    # rank when a process group is up, else 0
    shard_count: Optional[int] = None
    shard_rank: Optional[int] = None
    lang: LangConfig = field(default_factory=LangConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)


@dataclass
class TrainConfig(BaseConfig):
    """Optimisation schedule: the JAX package's fields and defaults."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_ratio: float = 0.1
    epochs: int = 4
    clip_grad_norm: float = 1.0
    seed: int = 9595
    # mid-epoch checkpoint cadence (0 = end-of-epoch only)
    save_every_steps: int = 0
    # periodic mid-epoch saves write on a background thread
    async_save: bool = True
    # retain only the K highest-epoch checkpoints (0 = keep all)
    keep_checkpoints: int = 0
    # gradient accumulation: microbatches per optimizer step
    accum_steps: int = 1
    half_precision: bool = True
    task_matched: bool = False
    task_mask_lm: bool = False
    task_obj_predict: bool = False
    task_qa: bool = True


@dataclass
class ModelConfig(BaseConfig):
    """One model's checkpoint and dtype (declared as in the JAX package;
    the experiments build their models from their own configs)."""

    name: str = ""
    checkpoint: Optional[str] = None
    dtype: str = "bfloat16"
    freeze_layers: Tuple[str, ...] = ()


@dataclass
class ModelsConfig(BaseConfig):
    """Named model collection."""

    main: ModelConfig = field(default_factory=ModelConfig)
    aux: ModelConfig = field(default_factory=ModelConfig)


@dataclass
class EvalConfig(BaseConfig):
    half_precision: bool = True
    metrics: Tuple[str, ...] = ("accuracy",)


@dataclass
class MeshConfig(BaseConfig):
    """The device-mesh declaration (the JAX package's fields). ``axes`` maps
    axis name -> size, -1 = every rank left; ``zero1_axis`` shards the AdamW
    moments over that axis (ZeRO-1). As in the JAX package, the models read
    the standard axis names (``data``, ``model``, ``seq``) whatever
    ``batch_axis`` / ``model_axis`` / ``seq_axis`` say, and
    ``force_host_platform`` (JAX's virtual CPU devices) has no use here: a
    CPU mesh is a gloo group of processes."""

    axes: Tuple[Tuple[str, int], ...] = (("data", -1),)
    batch_axis: str = "data"
    model_axis: str = "model"
    seq_axis: str = "seq"
    force_host_platform: bool = False
    zero1_axis: Optional[str] = None

    def build(self, device=None):
        """``parallel.make_mesh(self, device=device)``."""
        from vltk_tpu_torch.parallel import make_mesh

        return make_mesh(self, device=device)


@dataclass
class Config(BaseConfig):
    """Top-level experiment config."""

    data: DataConfig = field(default_factory=DataConfig)
    models: ModelsConfig = field(default_factory=ModelsConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    evaluate: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    logdir: str = "logs"
    test_run: bool = False
    break_loop_on_test: bool = True
    save_on_crash: bool = False
    checkpoint_dir: Optional[str] = None

    def __post_init__(self):
        super().__post_init__()
        if self.test_run:
            self.data.num_workers = 0

    @classmethod
    def from_flags(cls, yaml_path: Optional[str] = None, **dot_flags) -> "Config":
        """A YAML base (when given) with ``a.b.c=x`` overrides on top."""
        cfg = cls()
        if yaml_path is not None:
            import yaml

            with open(yaml_path) as f:
                cfg.update(yaml.safe_load(f) or {})
        if dot_flags:
            cfg.update(unflatten_dict(dot_flags))
        return cfg

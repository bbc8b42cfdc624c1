"""Configuration of the port's train layer.

A copy of the parts of ``vltk_tpu/config.py`` that the train layer and the
LayoutLM experiments read: ``BaseConfig`` (iteration, ``to_dict``,
recursive ``update`` with string coercion and overwrite tracking),
``LangConfig`` (``ignore_id``, the sequence lengths and the pretraining
corruption rates), ``DataConfig`` (its ``lang`` child, ``max_detections``), ``TrainConfig`` (every field, same defaults),
``MeshConfig`` and ``Config`` (``logdir``, ``checkpoint_dir``,
``test_run``, ``break_loop_on_test``, ``save_on_crash``). Field names and
defaults are the JAX package's.

Not honoured yet: a device mesh (data, tensor or sequence parallelism).
Setting any ``MeshConfig`` field to a value other than its default raises
``NotImplementedError``. ``accum_steps`` is honoured: it needs no mesh.
"""

from __future__ import annotations

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


@dataclass
class LangConfig(BaseConfig):
    max_seq_length: int = 128
    max_visual_seq_length: int = 128
    mask_rate: float = 0.15
    mask_token_rate: float = 0.8
    random_token_rate: float = 0.1
    sentence_match_rate: float = 0.5
    feature_mask_rate: float = 0.15
    ignore_id: int = -100


@dataclass
class DataConfig(BaseConfig):
    lang: LangConfig = field(default_factory=LangConfig)
    max_detections: int = 36


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
class MeshConfig(BaseConfig):
    """The JAX package's device-mesh declaration. Not ported: any
    non-default value raises."""

    axes: Tuple[Tuple[str, int], ...] = (("data", -1),)
    batch_axis: str = "data"
    model_axis: str = "model"
    seq_axis: str = "seq"
    force_host_platform: bool = False
    zero1_axis: Optional[str] = None

    def _check_ported(self) -> None:
        changed = [f.name for f in fields(self) if getattr(self, f.name) != f.default]
        if changed:
            raise NotImplementedError(
                f"a device mesh is not ported yet (ROADMAP A.14); non-default mesh fields: {changed}"
            )


@dataclass
class Config(BaseConfig):
    """Top-level experiment config."""

    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    logdir: str = "logs"
    test_run: bool = False
    break_loop_on_test: bool = True
    save_on_crash: bool = False
    checkpoint_dir: Optional[str] = None

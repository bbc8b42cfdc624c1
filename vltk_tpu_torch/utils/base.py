"""Arrow schema metadata and JSON loading: copies of ``set_metadata``,
``get_metadata`` and ``try_load`` of ``vltk_tpu/utils/base.py``."""

from __future__ import annotations

import json
from collections import Counter
from typing import Any, Dict, Mapping, Optional

import numpy as np
import pyarrow as pa


def set_metadata(table: pa.Table, tbl_meta: Mapping[str, Any]) -> pa.Table:
    """The table with ``tbl_meta`` added to its schema's key/value metadata,
    each value JSON-encoded; existing keys (``huggingface``) are kept."""
    meta = dict(table.schema.metadata or {})
    for k, v in tbl_meta.items():
        meta[k.encode() if isinstance(k, str) else k] = json.dumps(v, default=_json_default).encode()
    return table.replace_schema_metadata(meta)


def get_metadata(table: pa.Table) -> Dict[str, Any]:
    """Every schema metadata entry, JSON-decoded where it parses."""
    out: Dict[str, Any] = {}
    for k, v in (table.schema.metadata or {}).items():
        key = k.decode() if isinstance(k, bytes) else k
        raw = v.decode() if isinstance(v, bytes) else v
        try:
            out[key] = json.loads(raw)
        except (json.JSONDecodeError, TypeError):
            out[key] = raw
    return out


def _json_default(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, set):
        return sorted(obj)
    if isinstance(obj, Counter):
        return dict(obj)
    return str(obj)


def try_load(path: str) -> Optional[Any]:
    """A .json or .jsonl file, or None when it cannot be read or parsed."""
    try:
        with open(path) as f:
            if path.endswith(".jsonl"):
                return [json.loads(line) for line in f if line.strip()]
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None

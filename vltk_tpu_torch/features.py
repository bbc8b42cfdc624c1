"""Column types of the adapters' schemas, without HF ``datasets``.

The port's counterpart of ``vltk_tpu/features.py``: the same named
constructors (``Features.Boxes()``, ``FeaturesMatrix(n, d)``, ``Ids()``,
``IntList()``, ``String()``, ...) over three small types of its own:

* ``Value(dtype)``: one scalar;
* ``Sequence(feature, length=-1)``: a variable list, or a fixed-size one;
* ``ArrayXD(shape, dtype)``: a tensor of fixed trailing dims (``Array2D``,
  ``Array3D``), stored as nested variable lists.

Each type gives its Arrow type and the JSON that HF ``datasets`` writes
under the schema's ``huggingface`` key, and a tensor column's field carries
the extension name and metadata HF writes. So the tables the port writes
read back in HF ``datasets`` and in the JAX package as the tables those
write, and the port reads theirs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import pyarrow as pa

_ARROW_TYPES = {
    "bool": pa.bool_(),
    "int8": pa.int8(),
    "int16": pa.int16(),
    "int32": pa.int32(),
    "int64": pa.int64(),
    "uint8": pa.uint8(),
    "float16": pa.float16(),
    "float32": pa.float32(),
    "float64": pa.float64(),
    "string": pa.string(),
}
EXTENSION_NAME_KEY = b"ARROW:extension:name"
EXTENSION_META_KEY = b"ARROW:extension:metadata"


@dataclass(frozen=True)
class Value:
    dtype: str

    def arrow_type(self) -> pa.DataType:
        return _ARROW_TYPES[self.dtype]

    def to_json(self) -> Dict[str, Any]:
        return {"dtype": self.dtype, "_type": "Value"}


@dataclass(frozen=True)
class Sequence:
    feature: Any
    length: int = -1

    def arrow_type(self) -> pa.DataType:
        inner = self.feature.arrow_type()
        return pa.list_(inner) if self.length < 0 else pa.list_(inner, self.length)

    def to_json(self) -> Dict[str, Any]:
        out = {"feature": self.feature.to_json()}
        if self.length != -1:
            out["length"] = self.length
        out["_type"] = "List"
        return out


@dataclass(frozen=True)
class ArrayXD:
    """A tensor column of ``shape`` (the first dim may be None: rows of
    varying length); rows are stored as ``len(shape)`` nested lists."""

    shape: Tuple[Optional[int], ...]
    dtype: str

    def arrow_type(self) -> pa.DataType:
        t = _ARROW_TYPES[self.dtype]
        for _ in self.shape:
            t = pa.list_(t)
        return t

    def to_json(self) -> Dict[str, Any]:
        return {"shape": list(self.shape), "dtype": self.dtype, "_type": f"Array{len(self.shape)}D"}

    def field_metadata(self) -> Dict[bytes, bytes]:
        return {
            # the extension type HF ``datasets`` gives its tensor columns
            EXTENSION_NAME_KEY: f"datasets.features.features.Array{len(self.shape)}DExtensionType".encode(),
            EXTENSION_META_KEY: json.dumps((list(self.shape), self.dtype)).encode(),
        }


def Array2D(shape, dtype: str = "float32") -> ArrayXD:
    return ArrayXD(tuple(shape), dtype)


def Array3D(shape, dtype: str = "float32") -> ArrayXD:
    return ArrayXD(tuple(shape), dtype)


def arrow_field(name: str, feature) -> pa.Field:
    meta = feature.field_metadata() if isinstance(feature, ArrayXD) else None
    return pa.field(name, feature.arrow_type(), metadata=meta)


def arrow_schema(schema: Mapping[str, Any]) -> pa.Schema:
    """The Arrow schema of an adapter schema, with the ``huggingface`` key."""
    hf = {"info": {"features": {name: f.to_json() for name, f in schema.items()}}}
    return pa.schema(
        [arrow_field(name, f) for name, f in schema.items()],
        metadata={b"huggingface": json.dumps(hf).encode()},
    )


def is_stringy(feature) -> bool:
    """A string column, or a list of them at any depth."""
    if isinstance(feature, Value):
        return feature.dtype == "string"
    if isinstance(feature, Sequence):
        return is_stringy(feature.feature)
    return False


class Features:
    """Named column constructors (``Features.Boxes()``, ...)."""

    # ragged types: host storage only; the loader pads them to fixed
    # capacities before anything reaches a device
    @staticmethod
    def Boxes():
        """Ragged list of (x, y, w, h) float boxes: [n, 4]."""
        return Sequence(Sequence(Value("float32")))

    Box = Boxes

    @staticmethod
    def Polygons():
        """Ragged list of polygons, each a list of flat xy coordinates."""
        return Sequence(Sequence(Sequence(Value("float32"))))

    @staticmethod
    def RLE():
        return Sequence(Sequence(Value("float32")))

    @staticmethod
    def Segmentation():
        return Features.Polygons()

    # fixed-shape types
    @staticmethod
    def Boxtensor(n: int):
        """Exactly n boxes: (n, 4)."""
        return Array2D((n, 4), dtype="float32")

    @staticmethod
    def Features2D(d: int):
        """Rows of d features, their count varying: [-1, d]."""
        return Array2D((None, d), dtype="float32")

    @staticmethod
    def FeaturesMatrix(n: int, d: int):
        """Exactly (n, d) features."""
        return Array2D((n, d), dtype="float32")

    @staticmethod
    def Features3D(n: int, d: int):
        return Array3D((None, n, d), dtype="float32")

    @staticmethod
    def Mask(h: int, w: int):
        return Array2D((h, w), dtype="uint8")

    # scalars and lists
    @staticmethod
    def String():
        return Value("string")

    @staticmethod
    def StringList():
        return Sequence(Value("string"))

    @staticmethod
    def Int():
        return Value("int32")

    @staticmethod
    def IntList():
        return Sequence(Value("int32"))

    @staticmethod
    def Float():
        return Value("float32")

    @staticmethod
    def FloatList():
        return Sequence(Value("float32"))

    @staticmethod
    def Span():
        """(start, end) token span."""
        return Sequence(Value("int32"), length=2)

    @staticmethod
    def Ids():
        return Sequence(Value("float32"))

    @staticmethod
    def NestedIds():
        return Sequence(Sequence(Value("float32")))

    @staticmethod
    def Imgid():
        return Value("string")

"""Inference protocols — V1 and V2 (Open Inference Protocol) data plane.

Parity with the reference's KServe data plane (SURVEY.md §2.4 'Python model
server': V1 `/v1/models/X:predict` + V2 Open Inference REST), as plain
dataclasses + numpy codecs so the same objects serve HTTP, the in-proc
router, and tests.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Any, Optional

import numpy as np

# V2 datatype <-> numpy dtype
V2_TO_NP = {
    "BOOL": np.bool_, "UINT8": np.uint8, "UINT16": np.uint16,
    "UINT32": np.uint32, "UINT64": np.uint64, "INT8": np.int8,
    "INT16": np.int16, "INT32": np.int32, "INT64": np.int64,
    "FP16": np.float16, "FP32": np.float32, "FP64": np.float64,
}
NP_TO_V2 = {np.dtype(v): k for k, v in V2_TO_NP.items()}


def np_to_v2_dtype(arr: np.ndarray) -> str:
    if arr.dtype.kind in ("U", "S", "O"):
        return "BYTES"
    try:
        return NP_TO_V2[arr.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {arr.dtype}") from None


@dataclasses.dataclass
class InferTensor:
    """One named tensor in a V2 request/response."""

    name: str
    shape: list[int]
    datatype: str
    data: list = dataclasses.field(default_factory=list)
    parameters: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_numpy(cls, name: str, arr: np.ndarray) -> "InferTensor":
        dt = np_to_v2_dtype(arr)
        if dt == "BYTES":
            data = [str(x) for x in arr.reshape(-1)]
        else:
            data = arr.reshape(-1).tolist()
        return cls(name=name, shape=list(arr.shape), datatype=dt, data=data)

    def to_numpy(self) -> np.ndarray:
        if self.datatype == "BYTES":
            return np.array(self.data, dtype=object).reshape(self.shape)
        return np.array(self.data, dtype=V2_TO_NP[self.datatype]).reshape(
            self.shape)

    def to_dict(self) -> dict:
        d = {"name": self.name, "shape": self.shape,
             "datatype": self.datatype, "data": self.data}
        if self.parameters:
            d["parameters"] = self.parameters
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "InferTensor":
        return cls(name=d["name"], shape=list(d["shape"]),
                   datatype=d["datatype"], data=d.get("data", []),
                   parameters=d.get("parameters", {}))


@dataclasses.dataclass
class InferRequest:
    """V2 inference request; ``from_v1`` adapts the V1 "instances" format."""

    model_name: str
    inputs: list[InferTensor]
    id: str = ""
    parameters: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"id": self.id, "inputs": [t.to_dict() for t in self.inputs]}
        if self.parameters:
            d["parameters"] = self.parameters
        return d

    @classmethod
    def from_dict(cls, model_name: str, d: dict) -> "InferRequest":
        return cls(
            model_name=model_name,
            inputs=[InferTensor.from_dict(t) for t in d.get("inputs", [])],
            id=d.get("id", ""),
            parameters=d.get("parameters", {}),
        )

    @classmethod
    def from_v1(cls, model_name: str, d: dict) -> "InferRequest":
        instances = np.asarray(d["instances"])
        if instances.dtype.kind in ("U", "S", "O"):
            tensor = InferTensor(
                name="input-0", shape=list(instances.shape), datatype="BYTES",
                data=[str(x) for x in instances.reshape(-1)])
        else:
            tensor = InferTensor.from_numpy("input-0", instances)
        return cls(model_name=model_name, inputs=[tensor],
                   parameters=d.get("parameters", {}))

    def as_numpy(self, name: Optional[str] = None) -> np.ndarray:
        if name is None:
            return self.inputs[0].to_numpy()
        for t in self.inputs:
            if t.name == name:
                return t.to_numpy()
        raise KeyError(f"no input tensor {name!r}")


@dataclasses.dataclass
class InferResponse:
    model_name: str
    outputs: list[InferTensor]
    id: str = ""
    model_version: str = "1"
    parameters: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_numpy(cls, model_name: str, arrays: dict[str, np.ndarray],
                   id: str = "") -> "InferResponse":
        return cls(model_name=model_name, id=id, outputs=[
            InferTensor.from_numpy(k, np.asarray(v)) for k, v in arrays.items()
        ])

    def to_dict(self) -> dict:
        return {
            "model_name": self.model_name,
            "model_version": self.model_version,
            "id": self.id,
            "outputs": [t.to_dict() for t in self.outputs],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "InferResponse":
        return cls(
            model_name=d.get("model_name", ""),
            outputs=[InferTensor.from_dict(t) for t in d.get("outputs", [])],
            id=d.get("id", ""),
            model_version=d.get("model_version", "1"),
        )

    def to_v1(self) -> dict:
        return {"predictions": self.outputs[0].to_numpy().tolist()
                if self.outputs else []}

    def as_numpy(self, name: Optional[str] = None) -> np.ndarray:
        if name is None:
            return self.outputs[0].to_numpy()
        for t in self.outputs:
            if t.name == name:
                return t.to_numpy()
        raise KeyError(f"no output tensor {name!r}")


def decode_b64(s: str) -> bytes:
    return base64.b64decode(s)

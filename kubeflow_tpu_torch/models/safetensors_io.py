"""A small reader of the safetensors format, so the port loads HF
checkpoints without the ``safetensors`` package.

A file is: 8 bytes little-endian header length N, N bytes of JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...,
"__metadata__": {...}}``, then the raw little-endian tensor bytes, offsets
relative to the end of the header. The file is memory-mapped and each
tensor is copied out when asked for, so host memory holds one tensor at
a time; asked for a slice (``index``), only the slice is copied, so a
tensor-parallel rank reads its shard and never the whole tensor. The sharded form (``model.safetensors.index.json`` with a
``weight_map`` of name -> file) is read through ``CheckpointIndex``.

``save_file`` is the writer: F32 / BF16 / F16 tensors from any device,
copied to the host and written one at a time, so host memory holds one
tensor's bytes at a time. The header is padded with spaces to a multiple
of 8 bytes and the tensors lie back to back in the order given, as the
``safetensors`` package lays a file out, so its reader takes the file.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np
import torch

# dtype tag -> (numpy dtype of the raw bytes, torch dtype to view them as)
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
}


_TAGS = {t_dtype: tag for tag, (_, t_dtype) in _DTYPES.items()}


def save_file(tensors: dict, path: str) -> None:
    """Write ``{name: tensor}`` to ``path`` in the safetensors format."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _TAGS:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; this "
                             f"writer takes {sorted(map(str, _TAGS))}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            host = t.detach().contiguous().cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            f.write(host.numpy().data)


class SafetensorsFile:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        header.pop("__metadata__", None)
        self._header = header
        self._data_start = 8 + n

    def keys(self) -> list[str]:
        return list(self._header)

    def get(self, name: str, index=None) -> torch.Tensor:
        """A CPU tensor holding a copy of ``name``'s bytes, or of the
        part ``index`` (a tuple of slices, numpy basic indexing) selects."""
        meta = self._header[name]
        tag = meta["dtype"]
        if tag not in _DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype {tag}; "
                             f"this reader takes {sorted(_DTYPES)}")
        np_dtype, t_dtype = _DTYPES[tag]
        begin, end = meta["data_offsets"]
        raw = np.frombuffer(self._map, dtype=np_dtype,
                            count=(end - begin) // np.dtype(np_dtype).itemsize,
                            offset=self._data_start + begin
                            ).reshape(meta["shape"])
        if index is not None:
            raw = raw[index]
        t = torch.from_numpy(np.array(raw, order="C"))
        return t.view(t_dtype) if t.dtype != t_dtype else t

    def close(self) -> None:
        self._map.close()


class CheckpointIndex:
    """name -> tensor over ``model.safetensors`` or the sharded
    ``model-0000x-of-0000y.safetensors`` + index form."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        self._open: dict[str, SafetensorsFile] = {}
        index_path = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self._where: dict[str, str] = json.load(f)["weight_map"]
        else:
            single = os.path.join(model_dir, "model.safetensors")
            if not os.path.exists(single):
                raise FileNotFoundError(
                    f"no model.safetensors[.index.json] in {model_dir}")
            st = self._open["model.safetensors"] = SafetensorsFile(single)
            self._where = {k: "model.safetensors" for k in st.keys()}

    def names(self) -> set[str]:
        return set(self._where)

    def get(self, name: str, index=None) -> torch.Tensor:
        fname = self._where[name]
        if fname not in self._open:
            self._open[fname] = SafetensorsFile(
                os.path.join(self.model_dir, fname))
        return self._open[fname].get(name, index)

    def close(self) -> None:
        for f in self._open.values():
            f.close()
        self._open.clear()

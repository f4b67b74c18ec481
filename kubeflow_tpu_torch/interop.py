"""Conversion from the JAX package's objects to the port's, through numpy
only (this module imports neither JAX nor ``kubeflow_tpu``).

- ``params_from_jax``: a Llama parameter tree in the ``llama.init_params``
  layout whose leaves are numpy arrays (``jax.device_get`` of the JAX
  tree) -> the same dict of torch tensors, same keys, same stacked shapes.
- ``config_from_jax``: a JAX ``LlamaConfig`` -> the port's, field by
  field, with ``dtype`` as a torch dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models.llama import LlamaConfig

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """A numpy / JAX dtype (or its name) -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = getattr(dtype, "__name__", str(dtype))
    if name not in _TORCH_DTYPES:
        raise ValueError(f"no torch dtype for {dtype!r}")
    return _TORCH_DTYPES[name]


def _leaf(x, device, dtype):
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: widen exactly, then cast back
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    return torch.tensor(arr, device=device, dtype=dtype)


def params_from_jax(tree, device: DeviceLike = None, dtype=None):
    """Nested dict of numpy arrays -> nested dict of torch tensors on
    ``device`` (``device.resolve_device``: CUDA unless ``"cpu"`` is asked
    for), cast to ``dtype`` when given, else kept."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _leaf(node, device, dtype)

    return convert(tree)


def config_from_jax(cfg) -> LlamaConfig:
    """Mirror a JAX ``LlamaConfig`` field for field."""
    kw = {}
    for f in dataclasses.fields(LlamaConfig):
        if hasattr(cfg, f.name):
            kw[f.name] = getattr(cfg, f.name)
    kw["dtype"] = torch_dtype(kw.get("dtype", torch.bfloat16))
    return LlamaConfig(**kw)

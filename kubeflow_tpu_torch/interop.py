"""Conversion from the JAX package's objects to the port's, through numpy
only (this module imports neither JAX nor ``kubeflow_tpu``).

- ``params_from_jax``: a Llama parameter tree in the ``llama.init_params``
  layout whose leaves are numpy arrays (``jax.device_get`` of the JAX
  tree) -> the same dict of torch tensors, same keys, same stacked shapes.
  int8 trees (int8 payloads, f32 scales) and int8 / fp8-e4m3 arrays
  (quantized KV pools) carry over bit for bit.
- ``config_from_jax``: a JAX ``LlamaConfig`` -> the port's, field by
  field, with ``dtype`` as a torch dtype.
- ``resnet_from_jax`` / ``mnist_from_jax``: the JAX ResNet's (params,
  batch stats) and the JAX MNIST CNN's params, as numpy trees -> the
  port's trees: every 4-D leaf (a convolution, HWIO) transposed to the
  port's OIHW, every other leaf as it is, stage lists kept as lists.
- ``darts_weights0`` / ``mpmd_mlp_from_jax``: the initial weights of
  the JAX ``darts_search`` and the arrays of the JAX MPMD harness, as
  numpy -> what the port's ``hpo.nas.darts_search`` and
  ``parallel.mpmd.MLPSpec`` take in place of their own seeded draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models.llama import LlamaConfig

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int8": torch.int8,
                 "float8_e4m3fn": torch.float8_e4m3fn}


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
    if arr.dtype.name == "float8_e4m3fn":
        # numpy has no fp8 of its own: carry the bytes, then reinterpret
        return torch.tensor(arr.view(np.uint8), device=device).view(
            torch.float8_e4m3fn)
    if arr.dtype.name == "bfloat16":
        # nor bfloat16: widen exactly, then cast back
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    elif arr.dtype.kind != "f":
        dtype = None     # integer payloads (int8 weights) keep their type
    return torch.tensor(arr, device=device, dtype=dtype)


def params_from_jax(tree, device: DeviceLike = None, dtype=None):
    """Nested dict of numpy arrays -> nested dict of torch tensors on
    ``device`` (``device.resolve_device``: CUDA unless ``"cpu"`` is asked
    for); float leaves are cast to ``dtype`` when given, every other
    leaf keeps its type."""
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


def _conv_tree(tree, device):
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        arr = np.asarray(node)
        if arr.ndim == 4:                         # HWIO -> OIHW
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        return _leaf(arr, device, None)

    return convert(tree)


def resnet_from_jax(params, stats, device: DeviceLike = None):
    """The JAX ResNet's ``(params, batch_stats)`` -> the port's, on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    device = resolve_device(device)
    return _conv_tree(params, device), _conv_tree(stats, device)


def mnist_from_jax(params, device: DeviceLike = None):
    """The JAX MNIST CNN's params -> the port's, on ``device``."""
    return _conv_tree(params, resolve_device(device))


def darts_weights0(search, retrain) -> dict:
    """The JAX ``darts_search``'s two draws of initial weights (numpy
    ``{"w_in", "w_out"}``: the search's, from ``seed``, and the
    retrain's, from ``seed + 1``) -> the port's ``weights0``."""
    def f32(tree):
        return {k: np.asarray(tree[k], np.float32) for k in ("w_in", "w_out")}

    return {"search": f32(search), "retrain": f32(retrain)}


def mpmd_mlp_from_jax(chunk_params, head_params, batches) -> dict:
    """The JAX MPMD harness's arrays as numpy (``init_stage_params`` of
    every global chunk, ``init_head_params``, ``step_batch`` of every
    step) -> the keyword arguments of the port's ``parallel.mpmd.MLPSpec``
    (``chunks``, ``head``, ``batches``), float32 CPU tensors that the
    spec moves to each runtime's device."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    return {"chunks": [{"w": t(c["w"]), "b": t(c["b"])}
                       for c in chunk_params],
            "head": {"w": t(head_params["w"])},
            "batches": [(t(x), t(y)) for x, y in batches]}

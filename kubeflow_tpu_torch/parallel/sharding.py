"""Logical-axis sharding rules of the PyTorch port (counterpart of
``kubeflow_tpu.parallel.sharding``).

Model code names each parameter dim with a *logical* axis ("heads",
"vocab", ...) and one rule table maps logical names to mesh axes, as in
the JAX package. There XLA places a sharded array; here each rank holds
its own shard as a plain tensor. Two cuts exist:

- ``tensor`` (serving, ``parallel.mesh.TensorMesh``): ``shard_tree`` cuts
  a full tree into one rank's shard; a rule naming another axis leaves
  the dim whole.
- ``fsdp`` (training, ``parallel.mesh.WorldMesh``): ZeRO-3, each
  parameter cut on the dim its rule puts on ``fsdp`` (``embed`` under
  ``DEFAULT_RULES``) into equal contiguous parts in rank order
  (``fsdp_dim``, ``fsdp_shard``); ``fsdp_unshard`` puts the parts back
  together. ``data`` holds no parameter dim: the state is whole on each
  of its ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# The JAX package's table (kubeflow_tpu/parallel/sharding.py:25-42).
DEFAULT_RULES: dict[str, object] = {
    # activations
    "batch": ("data", "fsdp"),
    "seq": "context",
    "act_embed": None,
    "act_heads": "tensor",
    "act_mlp": "tensor",
    # params
    "embed": "fsdp",
    "vocab": "tensor",
    "mlp": "tensor",
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "layers": None,
    "pipe_stage": "pipeline",
    "expert": "expert",
}


def pspec(names: Sequence[Optional[str]], rules=None) -> tuple:
    """Logical axis names -> the mesh axes of each dim under ``rules``
    (default ``DEFAULT_RULES``; a tuple standing in for
    ``PartitionSpec``)."""
    rules = rules if rules is not None else DEFAULT_RULES
    out = []
    for name in names:
        if name is None:
            out.append(None)
        else:
            if name not in rules:
                raise KeyError(f"no sharding rule for logical axis {name!r}")
            out.append(rules[name])
    return tuple(out)


def _mesh_axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _walk(logical, other, path=""):
    """(path, logical names, leaf of ``other``) over two nested dicts of
    the same keys; the paths read as ``jax.tree_util.keystr``'s."""
    if isinstance(logical, dict):
        for key, sub in logical.items():
            yield from _walk(sub, other[key], f"{path}['{key}']")
    else:
        yield path, logical, other


def validate_divisibility(mesh, logical_tree, shapes_tree,
                          rules=None) -> None:
    """Every sharded dim divides evenly over the mesh axes it maps to;
    raises with the JAX package's message otherwise. ``mesh.shape`` gives
    the axis sizes (absent axes count 1)."""
    sizes = dict(mesh.shape)
    for path, names, shape in _walk(logical_tree, shapes_tree):
        for dim, part in zip(tuple(shape), pspec(names, rules)):
            axes = _mesh_axes(part)
            total = 1
            for a in axes:
                total *= sizes.get(a, 1)
            if axes and dim % total != 0:
                raise ValueError(
                    f"param {path}: dim {dim} not divisible by mesh axes "
                    f"{axes} (product {total})")


def shard_slices(names: Sequence[Optional[str]], shape: Sequence[int],
                 rank: int, tp: int) -> list[slice]:
    """Rank ``rank``'s slice of each dim: the ``rank``-th of ``tp`` equal
    contiguous parts of every dim whose rule names ``tensor``, the whole
    dim otherwise."""
    out = []
    for dim, part in zip(tuple(shape), pspec(names)):
        if "tensor" in _mesh_axes(part) and tp > 1:
            if dim % tp:
                raise ValueError(f"dim {dim} not divisible by tensor={tp}")
            n = dim // tp
            out.append(slice(rank * n, (rank + 1) * n))
        else:
            out.append(slice(None))
    return out


def shard_tensor(x: torch.Tensor, names, rank: int,
                 tp: int) -> torch.Tensor:
    """One rank's shard of ``x`` as a contiguous tensor of its own (a
    copy: it never keeps the full tensor's storage alive)."""
    part = x[tuple(shard_slices(names, x.shape, rank, tp))]
    return part.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, axes, rank: int, tp: int):
    """One rank's shard of a full parameter tree: ``axes`` is the tree of
    logical-axis tuples (``llama.param_logical_axes``, or the int8 tree's
    ``serving.quant.quant_logical_axes``) with the same keys."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, axes[k], rank, tp)
                for k, v in tree.items()}
    return shard_tensor(tree, axes, rank, tp)


def placed_on(names: Sequence[Optional[str]], axis: str,
              rules=None) -> list[int]:
    """The dims of a parameter with logical axes ``names`` that ``rules``
    put on mesh axis ``axis``."""
    return [i for i, part in enumerate(pspec(names, rules))
            if axis in _mesh_axes(part)]


def fsdp_dim(names: Sequence[Optional[str]], rules=None) -> Optional[int]:
    """The dim of a parameter with logical axes ``names`` that ``rules``
    put on ``fsdp``, or None. Raises when two dims are."""
    dims = placed_on(names, "fsdp", rules)
    if len(dims) > 1:
        raise ValueError(f"logical axes {tuple(names)}: dims {dims} are all "
                         "on fsdp; a parameter is cut on one")
    return dims[0] if dims else None


def fsdp_shard(x: torch.Tensor, dim: int, index: int,
               n: int) -> torch.Tensor:
    """Part ``index`` of ``n`` equal contiguous parts of ``x`` along
    ``dim``, as a contiguous tensor of its own."""
    if x.shape[dim] % n:
        raise ValueError(f"dim {x.shape[dim]} not divisible by fsdp={n}")
    part = x.narrow(dim, index * (x.shape[dim] // n), x.shape[dim] // n)
    return part.clone(memory_format=torch.contiguous_format)


def fsdp_unshard(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The full tensor of its ``fsdp_shard`` parts, in rank order."""
    return torch.cat(list(parts), dim=dim)

"""Logical-axis sharding rules of the PyTorch port (counterpart of
``kubeflow_tpu.parallel.sharding``).

Model code names each parameter dim with a *logical* axis ("heads",
"vocab", ...) and one rule table maps logical names to mesh axes, as in
the JAX package. There XLA places a sharded array; here each rank holds
its own shard as a plain tensor. Two cuts exist:

- serving (``parallel.mesh.TensorMesh``, ``expert`` x ``tensor``):
  ``shard_tree`` cuts a full tree into one rank's shard, each dim whose
  rule names ``tensor`` by the rank's tensor index and each whose rule
  names ``expert`` (an MoE layer's experts) by its expert index, as
  JAX's ``tree_shardings`` places the tree on ``build_mesh(MeshConfig(
  expert=, tensor=))``; a rule naming another axis leaves the dim
  whole.
- training (``parallel.mesh.WorldMesh``): each parameter cut on the dim
  its rule puts on an axis (``axis_dim``) into equal contiguous parts in
  rank order (``axis_shard``). Under ``expert`` a rank keeps its share
  of every MoE layer's experts (the ``expert`` dim) and under ``tensor``
  its slice of every ``heads`` / ``kv_heads`` / ``mlp`` / ``vocab`` dim
  (``axis_part``, by the rules the trainer is given: under
  ``DEFAULT_RULES`` the tensor slices are those ``shard_tree`` cuts);
  under ``fsdp`` (ZeRO-3) each parameter, or each rank's expert and
  tensor slice of it, is cut on its ``embed`` dim (``axis_dim``,
  ``axis_shard`` over ``fsdp``); ``fsdp_unshard`` puts the parts back
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
    the same keys, in ``jax.tree_util``'s order (sorted keys); the paths
    read as ``jax.tree_util.keystr``'s."""
    if isinstance(logical, dict):
        for key in sorted(logical):
            yield from _walk(logical[key], other[key], f"{path}['{key}']")
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
                 rank: int, tp: int, expert: int = 1) -> list[slice]:
    """Rank ``rank``'s slice of each dim on a mesh of ``expert`` x ``tp``
    ranks (rank = expert index x tp + tensor index): the tensor index's
    of ``tp`` equal contiguous parts of every dim whose rule names
    ``tensor``, the expert index's of ``expert`` parts of every dim whose
    rule names ``expert``, the whole dim otherwise."""
    cuts = {"tensor": (rank % tp, tp), "expert": (rank // tp, expert)}
    out = []
    for dim, part in zip(tuple(shape), pspec(names)):
        sl = slice(None)
        for axis in _mesh_axes(part):
            index, n = cuts.get(axis, (0, 1))
            if n > 1:
                if dim % n:
                    raise ValueError(f"dim {dim} not divisible by "
                                     f"{axis}={n}")
                sl = slice(index * (dim // n), (index + 1) * (dim // n))
        out.append(sl)
    return out


def shard_tensor(x: torch.Tensor, names, rank: int, tp: int,
                 expert: int = 1) -> torch.Tensor:
    """One rank's shard of ``x`` as a contiguous tensor of its own (a
    copy: it never keeps the full tensor's storage alive)."""
    part = x[tuple(shard_slices(names, x.shape, rank, tp, expert))]
    return part.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, axes, rank: int, tp: int, expert: int = 1):
    """One rank's shard of a full parameter tree: ``axes`` is the tree of
    logical-axis tuples (``llama.param_logical_axes``, or the int8 tree's
    ``serving.quant.quant_logical_axes``) with the same keys."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, axes[k], rank, tp, expert)
                for k, v in tree.items()}
    return shard_tensor(tree, axes, rank, tp, expert)


def placed_on(names: Sequence[Optional[str]], axis: str,
              rules=None) -> list[int]:
    """The dims of a parameter with logical axes ``names`` that ``rules``
    put on mesh axis ``axis``."""
    return [i for i, part in enumerate(pspec(names, rules))
            if axis in _mesh_axes(part)]


def axis_dim(names: Sequence[Optional[str]], axis: str,
             rules=None) -> Optional[int]:
    """The dim of a parameter with logical axes ``names`` that ``rules``
    put on mesh axis ``axis``, or None. Raises when two dims are."""
    dims = placed_on(names, axis, rules)
    if len(dims) > 1:
        raise ValueError(f"logical axes {tuple(names)}: dims {dims} are all "
                         f"on {axis}; a parameter is cut on one")
    return dims[0] if dims else None


def axis_shard(x: torch.Tensor, dim: int, index: int, n: int,
               axis: str = "fsdp") -> torch.Tensor:
    """Part ``index`` of ``n`` equal contiguous parts of ``x`` along
    ``dim``, as a contiguous tensor of its own."""
    if x.shape[dim] % n:
        raise ValueError(f"dim {x.shape[dim]} not divisible by {axis}={n}")
    part = x.narrow(dim, index * (x.shape[dim] // n), x.shape[dim] // n)
    return part.clone(memory_format=torch.contiguous_format)


def fsdp_unshard(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The full tensor of its ``axis_shard`` parts, in rank order."""
    return torch.cat(list(parts), dim=dim)


def axis_part(tree, axes, axis: str, index: int, n: int, rules=None):
    """A new tree of rank ``index``'s slices over ``axis`` of ``tree``'s
    leaves (of ``n``; ``axes``: the logical-axis tree), each a tensor of
    its own; a leaf with no dim on ``axis`` is kept as it is."""
    if isinstance(tree, dict):
        return {k: axis_part(v, axes[k], axis, index, n, rules)
                for k, v in tree.items()}
    dim = axis_dim(axes, axis, rules)
    return tree if dim is None else axis_shard(tree, dim, index, n, axis)

"""ZeRO-3 under ``fsdp`` (the JAX package's ``embed`` -> ``fsdp`` rule,
"ZeRO-3 style parameter sharding"): a rank keeps only its part of every
parameter and of every gradient accumulator, and gathers each layer's
whole weights just before the layer runs.

Every parameter is cut on its ``fsdp`` dim (``sharding.axis_dim``) into
``n`` equal contiguous parts in rank order, as ``sharding.axis_shard``
cuts it. The parameters fall into units: one a layer (layer ``i``'s slice
of every leaf under ``params["layers"]``, whose first logical axis is
``layers``, or under a pipeline rank's ``params["stages"]``, whose
leaves ``[1, L/S, ...]`` lead with ``pipe_stage`` and then ``layers``:
the rank's stage, ``parallel/pipeline_llama.py``) and one of the rest
(the embedding, the final norm, an untied head). A rank's parts of a
unit lie back to back in one flat buffer, so a unit costs one all-gather
forward and one reduce-scatter backward, not one a leaf.
``FsdpParams.flat`` holds every unit's parts (the layers in order, then
the rest) and ``FsdpParams.grad`` the gradient parts in the same layout;
``parts`` and ``grads`` are trees of views of them with the parameters'
structure, a stacked leaf viewed across the layer units with
the unit's length as its layer stride. The optimizer updates ``parts``
(``training.optim.Shards`` makes its whole-leaf reductions sum over the
group).

``FsdpParams.gather(unit)`` (a layer index, or None for the rest) returns
the unit's whole weights through ``_Gather``, an autograd Function: its
forward all-gathers the unit's part into ``[n, part]`` rows and copies
each leaf out of them into its whole shape (one strided copy a leaf: a
leaf whose cut dim is not its leading one, such as ``wo`` and ``w_down``
with ``embed`` last, interleaves the ranks' rows); its backward packs the
whole gradients back into rows, reduce-scatters them over the group and
adds the rank's part into ``grad`` in place. It returns no gradient to
autograd: the flat buffer is a leaf only so that the gathers it feeds
record their backward, and never gets a ``.grad``. Called inside a
checkpointed block (``models/llama.forward`` under remat "full" or
"dots"), the gather runs again when the backward recomputes the block,
so the whole weights are not kept between the passes.

Over a world with ``expert`` or ``tensor`` axes the tree a rank's
``FsdpParams`` is built from is its expert and tensor slice
(``sharding.axis_part``): each slice is cut on ``embed`` over the rank's
``fsdp`` group (the ranks of its expert and tensor indices), so a
gathered unit is the rank's slice of a layer, and ``world`` names the
world for the model's collectives (``parallel/tensor.py``,
``parallel/moe.py``). ``gather_to_host`` rebuilds whole leaves across
the three axes.

``PlainGroup`` stands in for the group on one process, for the tests: its
all-gather concatenates the ranks' parts (``torch.cat``) and its
reduce-scatter cuts the rank's part out of the sum of the ranks'
gradients (one rank's: the others hold no rows).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import torch

from kubeflow_tpu_torch.parallel import sharding
from kubeflow_tpu_torch.parallel.pipeline import STAGES


def _items(tree, prefix: str = ""):
    """(path, leaf) over nested dicts, in insertion order (the order of
    ``training.optim.tree_leaves``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _like(tree, leaves):
    """``tree``'s nested dicts with its leaves taken from the iterator
    ``leaves`` in order."""
    if isinstance(tree, dict):
        return {k: _like(v, leaves) for k, v in tree.items()}
    return next(leaves)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One leaf of a unit: its key in the unit's dict, its whole shape in
    the unit (a layer leaf without its ``layers`` dim), the dim cut there,
    and where its part starts in the unit's part. With ``pre``/``post``
    the products of the dims before and after the cut one and ``k`` the
    part's length on it, the part is ``[pre, k, post]``."""
    key: str
    shape: tuple
    dim: int
    offset: int
    n: int

    @property
    def pre(self) -> int:
        return math.prod(self.shape[:self.dim])

    @property
    def k(self) -> int:
        return self.shape[self.dim] // self.n

    @property
    def post(self) -> int:
        return math.prod(self.shape[self.dim + 1:])

    @property
    def size(self) -> int:
        return self.pre * self.k * self.post

    @property
    def part_shape(self) -> tuple:
        return self.shape[:self.dim] + (self.k,) + self.shape[self.dim + 1:]

    def rows(self, buf: torch.Tensor, numel: int) -> torch.Tensor:
        """This leaf's ``[n, pre, k, post]`` in a gathered unit ``buf``
        (``n`` rank parts of ``numel`` elements, in rank order)."""
        rows = buf.view(self.n, numel)
        return rows[:, self.offset:self.offset + self.size].view(
            self.n, self.pre, self.k, self.post)


def _unit(leaves: list, n: int) -> tuple:
    """[(key, whole shape, cut dim)] -> (the unit's ``_Leaf``s, its part's
    numel)."""
    out, off = [], 0
    for key, shape, dim in leaves:
        leaf = _Leaf(key, tuple(shape), dim, off, n)
        out.append(leaf)
        off += leaf.size
    return tuple(out), off


class _Gather(torch.autograd.Function):
    """A unit's part -> its whole leaves; backward: the reduce-scatter of
    their gradients into the owner's gradient part (module docstring)."""

    @staticmethod
    def forward(ctx, part, owner: "FsdpParams", unit: Optional[int]):
        ctx.owner, ctx.unit = owner, unit
        return tuple(owner._unpack(unit, part))

    @staticmethod
    def backward(ctx, *grads):
        ctx.owner._scatter(ctx.unit, grads)
        return None, None, None


class FsdpParams:
    """A rank's ZeRO-3 parts of a parameter tree over the ``fsdp`` axis of
    ``group`` (a ``parallel.mesh.WorldMesh``, or ``PlainGroup``): built
    from the whole tree ``params`` (copied, so the caller may drop it),
    its logical axes ``axes`` and the sharding ``rules``
    (module docstring). Every leaf must be cut on some dim, a layer leaf
    on a dim other than its ``layers`` one.

    ``world`` is ``group`` when it is a training world (``params`` is
    then the rank's expert and tensor slice of the tree), else None.

    ``timings`` counts the gathers and reduce-scatters (``gathers`` /
    ``scatters``), the bytes of the whole units they move (``*_bytes``)
    and their host seconds (``*_s``: the whole collective where it is
    staged through the host, the enqueue under NCCL; nothing while a
    CUDA graph replays)."""

    def __init__(self, params: dict, axes: dict, rules, group):
        self.group = group
        self.n, self.index = group.fsdp, group.fsdp_index
        self.world = group if getattr(group, "size", 1) > 1 else None
        named = dict(_items(params))
        names = dict(_items(axes))
        first = next(iter(named.values()))
        self.dtype, self.device = first.dtype, first.device
        layers, rest, dims = [], [], {}
        self.n_layers = None
        # the layer leaves' key and the dims before their layers dim
        # (``pipe_stage``, one stage a rank), one for every layer leaf
        self._stack: Optional[tuple] = None
        for path, t in named.items():
            dim = sharding.axis_dim(names[path], "fsdp", rules)
            dims[path] = dim
            if dim is None:
                continue
            top, _, key = path.partition("/")
            lead = _layers_dim(names[path]) if key else None
            if lead is not None and top in ("layers", STAGES):
                if dim <= lead or self.n_layers not in (None, t.shape[lead]) \
                        or self._stack not in (None, (top, lead)) \
                        or any(d != 1 for d in t.shape[:lead]):
                    raise ValueError(
                        f"{path} {tuple(t.shape)}: a layer leaf is cut on "
                        "a dim after its layers dim, leads with one stage, "
                        "and every layer leaf has the same number of "
                        "layers")
                self.n_layers, self._stack = t.shape[lead], (top, lead)
                layers.append((key, t.shape[lead + 1:], dim - lead - 1))
            else:
                rest.append((path, t.shape, dim))
        whole = [p for p, d in dims.items() if d is None]
        if whole:
            raise ValueError(f"under fsdp every parameter is cut on its "
                             f"fsdp dim; {whole} have none")
        self.n_layers = self.n_layers or 0
        self._layer, self._layer_numel = _unit(layers, self.n)
        self._rest, self._rest_numel = _unit(rest, self.n)
        numel = self.n_layers * self._layer_numel + self._rest_numel
        self.flat = torch.empty((numel,), dtype=self.dtype, device=self.device)
        self.grad = torch.zeros_like(self.flat)
        self.dims = _like(params, iter(dims.values()))
        self.shapes = _like(params, (tuple(t.shape) for t in named.values()))
        self.parts = self._views(self.flat.detach(), params)
        self.grads = self._views(self.grad, params)
        with torch.no_grad():
            for (path, t), part in zip(named.items(),
                                       dict(_items(self.parts)).values()):
                part.copy_(sharding.axis_shard(t, dims[path], self.index,
                                               self.n))
        self.flat.requires_grad_(True)
        self.timings = {"gathers": 0, "gather_bytes": 0, "gather_s": 0.0,
                        "scatters": 0, "scatter_bytes": 0, "scatter_s": 0.0}

    def _views(self, buf: torch.Tensor, like: dict) -> dict:
        """A tree like ``like`` of the parts in ``buf`` (``flat``'s layout):
        a stacked leaf strided over the layer units."""
        L, U = self.n_layers, self._layer_numel
        base = L * U
        top, lead = self._stack or ("layers", 0)
        views = {}
        for leaf in self._layer:
            shape = (1,) * lead + (L,) + leaf.part_shape
            inner = torch.empty(leaf.part_shape, device="meta").stride()
            views[f"{top}/{leaf.key}"] = buf.as_strided(
                shape, (L * U,) * lead + (U,) + inner,
                buf.storage_offset() + leaf.offset)
        for leaf in self._rest:
            views[leaf.key] = buf[base + leaf.offset:
                                  base + leaf.offset + leaf.size] \
                .view(leaf.part_shape)
        return _like(like, (views[p] for p, _ in _items(like)))

    def _span(self, unit: Optional[int]) -> tuple:
        """(offset in ``flat``, leaves, part numel) of a unit."""
        if unit is None:
            return (self.n_layers * self._layer_numel, self._rest,
                    self._rest_numel)
        if not 0 <= unit < self.n_layers:
            raise IndexError(f"layer {unit} of {self.n_layers}")
        return unit * self._layer_numel, self._layer, self._layer_numel

    @property
    def rest_grad(self) -> torch.Tensor:
        """The gradient parts of the rest unit (a view of ``grad``)."""
        return self.grad[self.n_layers * self._layer_numel:]

    def gather(self, unit: Optional[int] = None) -> dict:
        """The whole weights of layer ``unit`` (its leaves' keys under
        ``params["layers"]``), or with None of the rest (their paths),
        recording the reduce-scatter of their gradients for the
        backward."""
        off, leaves, numel = self._span(unit)
        whole = _Gather.apply(self.flat[off:off + numel], self, unit)
        return {leaf.key: w for leaf, w in zip(leaves, whole)}

    def _timed(self, kind: str, nbytes: int, call) -> None:
        if getattr(self.group, "via_host", False):
            torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        call()
        self.timings[kind + "_s"] += time.perf_counter() - t0
        self.timings[kind + "s"] += 1
        self.timings[kind + "_bytes"] += nbytes

    def _unpack(self, unit: Optional[int], part: torch.Tensor) -> list:
        """The all-gather of a unit's part, copied out leaf by leaf."""
        _, leaves, numel = self._span(unit)
        rows = torch.empty((self.n * numel,), dtype=self.dtype,
                           device=self.device)
        self._timed("gather", rows.numel() * rows.itemsize,
                    lambda: self.group.all_gather(rows, part.detach(),
                                                  "fsdp"))
        out = []
        for leaf in leaves:
            w = torch.empty(leaf.shape, dtype=self.dtype, device=self.device)
            w.view(leaf.pre, self.n, leaf.k, leaf.post).copy_(
                leaf.rows(rows, numel).transpose(0, 1))
            out.append(w)
        return out

    def _scatter(self, unit: Optional[int], grads: Sequence) -> None:
        """The whole gradients of a unit packed into rank rows,
        reduce-scattered, and the rank's part added into ``grad``."""
        off, leaves, numel = self._span(unit)
        rows = torch.empty((self.n * numel,), dtype=self.dtype,
                           device=self.device)
        for leaf, g in zip(leaves, grads):
            leaf.rows(rows, numel).copy_(
                g.reshape(leaf.pre, self.n, leaf.k, leaf.post)
                .transpose(0, 1))
        out = torch.empty((numel,), dtype=self.dtype, device=self.device)
        self._timed("scatter", rows.numel() * rows.itemsize,
                    lambda: self.group.reduce_scatter(out, rows, "fsdp"))
        self.grad[off:off + numel].add_(out)


def _layers_dim(names) -> Optional[int]:
    """The index of the ``layers`` axis of a stacked layer leaf's logical
    axes (``("layers", ...)``, or ``("pipe_stage", "layers", ...)``), or
    None."""
    names = tuple(names)
    for lead, want in enumerate((("layers",), ("pipe_stage", "layers"))):
        if names[:lead + 1] == want:
            return lead
    return None


def gather_to_host(part: torch.Tensor, dims, group,
                   piece_bytes: int = 1 << 28) -> torch.Tensor:
    """The whole tensor of which this rank holds ``part``, gathered over
    ``group`` into host memory. ``dims``: ``{axis: the dim cut over it}``
    for ``pipeline``, ``fsdp``, ``expert`` and ``tensor`` (None or
    empty: the rank holds it whole, and gets a copy). A leaf cut on
    several axes is gathered over the group of those axes, whose ranks'
    parts come in ``(pipeline, fsdp, expert, tensor)`` order. Cut on dims
    after the leading one, it is gathered in pieces of leading rows whose
    whole takes at most ``piece_bytes`` (a row at least), so the device
    holds one piece at a time; cut on the leading dim, at once."""
    sizes = {a: getattr(group, a, 1)
             for a in ("pipeline", "fsdp", "expert", "tensor")}
    cut = {a: d for a, d in (dims or {}).items() if sizes[a] > 1}
    if not cut:
        return part.detach().to("cpu", copy=True)
    axes = tuple(a for a in sizes if a in cut)
    n = math.prod(sizes[a] for a in axes)
    shape = list(part.shape)
    for a, d in cut.items():
        shape[d] *= sizes[a]
    out = torch.empty(shape, dtype=part.dtype, device="cpu")
    lead = 0 in cut.values()
    rows = part.shape[0] if lead else max(
        1, piece_bytes // max(part[0].numel() * part.itemsize * n, 1))
    for a in range(0, part.shape[0], rows):
        piece = part.detach()[a:a + rows].contiguous()
        got = torch.empty((n * piece.numel(),), dtype=part.dtype,
                          device=part.device)
        group.all_gather(got, piece.view(-1), axes)
        parts = list(got.view(n, *piece.shape).unbind(0))
        # the innermost axis first: its parts lie next to each other
        for ax in reversed(axes):
            k = sizes[ax]
            parts = [sharding.fsdp_unshard(parts[i:i + k], cut[ax])
                     for i in range(0, len(parts), k)]
        (out if lead else out[a:a + rows]).copy_(parts[0])
    return out


class PlainGroup:
    """The ``fsdp`` axis of ``n`` ranks standing in one process, in plain
    PyTorch, for the tests. ``ranks`` (filled by the caller) holds every
    rank's ``FsdpParams``; ``index`` is the rank this group serves.
    ``all_gather`` concatenates the ranks' parts at the offset the given
    part has in this rank's flat buffer (``torch.cat``);
    ``reduce_scatter`` cuts this rank's part out of the sum of the ranks'
    gradient rows, which is this rank's rows: the others hold no rows of
    the batch."""

    def __init__(self, n: int, index: int, ranks: list):
        self.fsdp, self.fsdp_index, self.ranks = n, index, ranks

    def all_gather(self, out: torch.Tensor, x: torch.Tensor,
                   axis: str = "fsdp") -> torch.Tensor:
        a, k = x.storage_offset(), x.numel()
        return out.copy_(torch.cat([r.flat.detach()[a:a + k]
                                    for r in self.ranks]))

    def reduce_scatter(self, out: torch.Tensor, x: torch.Tensor,
                       axis: str = "fsdp") -> torch.Tensor:
        return out.copy_(x.view(self.fsdp, -1)[self.fsdp_index])

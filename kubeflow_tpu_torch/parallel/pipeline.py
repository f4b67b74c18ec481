"""Pipeline parallelism in training (counterpart of
``kubeflow_tpu.parallel.pipeline``): GPipe fill-drain over the
``pipeline`` axis of a training world (``parallel.mesh.WorldMesh``).

The JAX package runs every stage in one SPMD program: the stage
parameters are stacked on a leading stage dim sharded over ``pipeline``,
and the micro batches' activations pass from stage to stage by
``ppermute`` inside ``shard_map``. Here each rank is one process holding
its stage: ``pipeline_apply`` runs JAX's tick loop on it, and the
activations go round the ring of the axis's ranks through
``WorldMesh.ring_shift``.

Schedule (JAX's): for S stages and M micro batches every rank ticks M +
S - 1 times. At tick t stage 0 takes micro batch t (zeros once the
input is used up), every other stage the output its predecessor passed
at tick t - 1; stage s holds micro batch t - s while s <= t < s + M and
is idle (a bubble) otherwise; the last stage keeps its output of micro
batch t - (S - 1). After the ticks the last stage's outputs are
broadcast to every pipeline rank, so each computes the loss on them.

The backward is autograd's, over the same ticks in reverse:

- ``_Shift`` (one step round the ring, to ``p + 1`` from ``p - 1``):
  its backward is the reverse step, each stage's input gradient sent
  back to the stage it came from. Every rank posts the shifts of ticks
  0 .. M + S - 3 forward and their reverses backward, in the same
  order, whatever it computes: a tick's input depends on the last
  shift on every rank (stage 0 keeps the ring's buffer on the graph,
  ``_Take``, as JAX's ``where`` does), and a bubble tick's output on
  its input (``_Bubble``), so autograd walks the ticks in reverse on
  every rank and no shift waits for a peer that never posts it. A
  0-d ``anchor`` that records gradients enters every shift, so each
  one has a backward node even where its input does not. The last
  tick's output is passed to no stage that reads it (JAX's "last->0
  ignored"): that shift is not made.
- ``_FromLast`` (the broadcast): the last stage sends its outputs, the
  others receive them. Every pipeline rank computes the same loss from
  them, so the last stage's own cotangent is the whole one: its
  backward hands the last stage its own cotangent and the others zeros
  (an all-reduce, as a backward, would count the loss S times). Every
  rank's last tick output enters it too (zero cotangent), so the chain
  of shifts is on every rank's graph whatever the last stage keeps.
- The bubble ticks run no stage (JAX runs them on zeros and masks their
  aux): their outputs reach no valid tick and no kept output, so only
  their time differs.

With ``stage_aux`` a stage returns ``(y, aux)``: the aux of the valid
ticks is summed over the ticks and over the stages (``tensor.reduce``
over ``pipeline``: every rank adds the same total to its loss, so each
stage's own aux gets the one cotangent) and divided by M.

JAX's ``partial_manual`` has no counterpart: a rank is one process, so
every other axis of the world is always the rank's own, and a stage's
collectives over them (``tensor``, ``fsdp``, ``expert``) run as they do
without a pipeline.

A pipelined parameter tree holds its layers under ``STAGES``
(``[S, L/S, ...]`` leaves, ``pipeline_llama.to_pipeline_params``);
``stage_count`` finds it, and ``from_pipeline_state`` /
``to_pipeline_state`` move a train state between it and the plain
``layers`` stack ``[L, ...]`` that checkpoints hold.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from kubeflow_tpu_torch.parallel import tensor


# the key of a pipelined tree's stacked stages (the plain tree's "layers")
STAGES = "stages"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stage_count(params) -> Any:
    """The number of stages of a pipelined parameter tree (the leading
    dim of its ``STAGES`` leaves), or None for any other tree."""
    stages = params.get(STAGES) if isinstance(params, dict) else None
    if not stages:
        return None
    while isinstance(stages, dict):
        stages = next(iter(stages.values()))
    return stages.shape[0]


def _restack(tree, old: str, new: str, fn):
    """``tree`` (nested dicts, tuples, lists of tensors: a parameter tree
    or an optimizer state) with every dict's ``old`` entry moved to
    ``new`` and each tensor under it through ``fn``."""
    if isinstance(tree, dict):
        return {(new if k == old else k):
                (_tree_map(fn, v) if k == old else _restack(v, old, new, fn))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_restack(v, old, new, fn) for v in tree)
    return tree


def from_pipeline_state(state) -> Any:
    """A train state (parameters and optimizer state) over stages in the
    plain layout: every ``STAGES`` entry ``[S, L/S, ...]`` as
    ``"layers"`` ``[L, ...]`` (the tree the JAX package's pods write)."""
    return _restack(state, STAGES, "layers", lambda a: a.reshape(
        (a.shape[0] * a.shape[1],) + tuple(a.shape[2:])))


def to_pipeline_state(state, n_stages: int) -> Any:
    """``from_pipeline_state``'s inverse over ``n_stages`` stages."""
    return _restack(state, "layers", STAGES, lambda a: a.reshape(
        (n_stages, a.shape[0] // n_stages) + tuple(a.shape[1:])))


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack per-stage parameter trees (nested dicts of tensors) on a
    leading stage dim: a tree of the same structure, one stacked tensor
    a leaf."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(list(per_stage_params), dim=0)


class _Shift(torch.autograd.Function):
    """One step round the ring of ``axis``; backward, the step back."""

    @staticmethod
    def forward(ctx, y, anchor, world, axis):
        ctx.world, ctx.axis = world, axis
        return world.ring_shift(y.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return ctx.world.ring_shift(g, ctx.axis, reverse=True), None, None, \
            None


class _Take(torch.autograd.Function):
    """Stage 0's tick input: the injected micro batch, with the ring's
    buffer (whose value stage 0 never reads) kept on the graph."""

    @staticmethod
    def forward(ctx, inject, buf):
        return inject.view_as(inject)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


class _Bubble(torch.autograd.Function):
    """A bubble tick's output: zeros, depending on the tick's input."""

    @staticmethod
    def forward(ctx, x):
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


class _FromLast(torch.autograd.Function):
    """The last stage's ``kept`` (of ``shape`` and ``dtype``; None on the
    other ranks) on every rank of ``axis``, with ``tail`` (a tensor of
    the rank's pipeline graph) kept on the graph; backward, the last
    stage's own cotangent there, and zeros for ``tail``."""

    @staticmethod
    def forward(ctx, kept, tail, world, axis, shape, dtype):
        n = world.axis_size(axis)
        ctx.last = world.axis_index(axis) == n - 1
        ctx.tail = (tail.shape, tail.dtype)
        if ctx.last:
            world.broadcast(kept.contiguous(), axis, n - 1)
            return kept.view_as(kept)
        return world.broadcast(tail.new_empty(shape, dtype=dtype), axis,
                               n - 1)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.tail
        return ((g if ctx.last else None),
                torch.zeros(shape, dtype=dtype, device=g.device), None,
                None, None, None)


def from_last(kept, tail: torch.Tensor, world, axis: str = "pipeline"):
    """The last pipeline stage's ``kept`` on every rank of ``axis``
    (``_FromLast``): ``kept`` is a tensor on the last stage and a
    ``(shape, dtype)`` pair on the others; ``tail`` keeps the rank's
    pipeline on the graph of what it returns."""
    if isinstance(kept, torch.Tensor):
        return _FromLast.apply(kept, tail, world, axis, kept.shape,
                               kept.dtype)
    return _FromLast.apply(None, tail, world, axis, *kept)


def pipeline_apply(stage_fn: Callable, world, *, axis: str = "pipeline",
                   microbatches: int, stage_aux: bool = False) -> Callable:
    """Build ``fn(stage_params, x) -> y`` running ``stage_fn`` as a GPipe
    pipeline over ``world``'s ``axis`` (module docstring).

    - ``stage_fn(stage_params, x) -> y``: this rank's stage; x and y
      have the same shape and dtype (the activations passed between
      stages). With ``stage_aux`` it returns ``(y, aux)``, aux a 0-d
      tensor, and ``fn`` returns ``(y, aux_total)``: the valid ticks'
      aux summed over every stage and averaged over the micro batches.
    - ``stage_params``: this rank's stage parameters (anything
      ``stage_fn`` takes).
    - ``x``: this rank's rows ``[B, ...]``, the same on every pipeline
      rank (only stage 0 reads them), cut into ``microbatches`` equal
      micro batches along dim 0; ValueError when B does not divide.
    - ``world``: a ``WorldMesh``, or None for one process (one stage).

    ``y`` is the last stage's output of every micro batch, ``[B, ...]``,
    on every pipeline rank."""
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches}")

    def fn(stage_params, x):
        n = world.axis_size(axis) if world is not None else 1
        stage = world.axis_index(axis) if world is not None else 0
        m = microbatches
        if x.shape[0] % m:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into microbatches={m}")
        mb = x.reshape(m, x.shape[0] // m, *x.shape[1:]).unbind(0)
        anchor = (x.new_zeros((), requires_grad=True)
                  if n > 1 and torch.is_grad_enabled() else None)
        buf = torch.zeros_like(mb[0])
        outs, auxes = [], []
        y = None
        for t in range(m + n - 1):
            if stage == 0:
                inject = mb[t] if t < m else torch.zeros_like(mb[0])
                state = _Take.apply(inject, buf) if n > 1 else inject
            else:
                state = buf
            if stage <= t < stage + m:
                y = stage_fn(stage_params, state)
                if stage_aux:
                    y, aux = y
                    auxes.append(torch.as_tensor(aux, dtype=torch.float32,
                                                 device=x.device))
            else:
                y = _Bubble.apply(state)
            if stage == n - 1 and t >= n - 1:
                outs.append(y)
            if n > 1 and t < m + n - 2:
                buf = _Shift.apply(y, anchor, world, axis)
        if n > 1:
            out = from_last(torch.stack(outs) if stage == n - 1
                            else ((m, *mb[0].shape), x.dtype), y, world, axis)
        else:
            out = torch.stack(outs)
        out = out.reshape(x.shape[0], *out.shape[2:])
        if not stage_aux:
            return out
        total = (torch.stack(auxes).sum() if auxes
                 else torch.zeros((), dtype=torch.float32, device=x.device))
        return out, tensor.reduce(total, world, axis) / m

    return fn


def pipeline_loss_fn(stage_fn: Callable, loss_head: Callable, world, *,
                     axis: str = "pipeline", microbatches: int) -> Callable:
    """``pipeline_apply`` composed with a loss head: ``loss(stage_params,
    head_params, x, targets) -> loss_head(head_params, y, targets)``, on
    every pipeline rank."""
    fwd = pipeline_apply(stage_fn, world, axis=axis,
                         microbatches=microbatches)

    def loss(stage_params, head_params, x, targets):
        return loss_head(head_params, fwd(stage_params, x), targets)

    return loss

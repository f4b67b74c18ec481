"""Megatron's tensor parallelism in training: the collectives that join
the ranks of a training world's ``tensor`` axis
(``parallel.mesh.WorldMesh``), each an ``autograd.Function`` so that the
backward carries its counterpart.

Tensor peers feed the same rows, and each holds its slice of every
``heads`` / ``kv_heads`` / ``mlp`` / ``vocab`` dim (``sharding.
axis_part``). In a block (``models/llama._block``) the normed input
enters the column-parallel products (``wq``/``wk``/``wv``,
``w_gate``/``w_up``) through ``copy`` and the row-parallel ones (``wo``,
``w_down``) leave through ``reduce``:

- ``copy``: identity forward; backward, the sum over the axis of the
  peers' partial input gradients (each rank's columns give a part).
- ``reduce``: forward, the sum over the axis of the peers' partial
  products, into a new tensor (the input, which remat "dots" may have
  saved, is never written); backward, identity (every peer computes the
  same loss from the sum, so each already holds its gradient).
- ``vocab_lookup``: the rank's vocab rows of the embedding, looked up
  with tokens outside them masked to zero rows, then ``reduce``: exact,
  since each token has one nonzero row (serving's ``llama.
  embed_tokens(mesh=)`` masks the same way, ``local_tokens``).
- ``gather_vocab``: the rank's vocab columns of the logits, all-gathered
  along vocab in rank order; backward, the rank's own columns of the
  gradient. The logits are whole on every rank before the loss, as the
  JAX model constrains them (``("batch", "seq", None)``), so the loss
  code is unchanged.

Each takes the world (``mesh``; None, or a group of one rank, returns
the input: the one-card and batch-axes-only paths) and runs over its
``tensor`` group, whose calls, bytes and host seconds
``WorldMesh.timings`` counts (``tensor_*``). ``copy`` and ``reduce`` also
take another group (``axis``): the MoE layer (``parallel/moe.py``)
joins its expert and tensor peers through them over ``rows``. ``psum``
is the sum over a group whose every rank goes on to use it, the MoE
router's statistics over ``tokens``: every rank's loss then depends on
every rank's rows, so its backward all-reduces too (each rank's
gradient of the sum is the total of the ranks' ``w_r * d aux / d sum``,
where ``reduce``'s identity would keep only its own share).
``TensorParams`` is what the trainer hands the loss function over a
world without ``fsdp``: the rank's slices and the world they are cut
over (under ``fsdp`` the rank's ``parallel.fsdp.FsdpParams`` carries
it).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class TensorParams:
    """A rank's ``tensor`` slices of a parameter tree (``tree``) and the
    world whose ``tensor`` axis cuts them (``mesh``)."""
    tree: dict
    mesh: Any


def local_tokens(tokens: torch.Tensor, index: int, n: int) -> tuple:
    """(token ids in the vocab rows ``[index * n, (index + 1) * n)`` made
    local, 0 elsewhere; the mask of those inside)."""
    local = tokens.long() - index * n
    hit = (local >= 0) & (local < n)
    return torch.where(hit, local, 0), hit


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, kind):
        ctx.mesh, ctx.axis, ctx.kind = mesh, axis, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(g, ctx.axis, ctx.kind), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, kind):
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               axis, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, kind):
        ctx.mesh, ctx.axis, ctx.kind = mesh, axis, kind
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               axis, kind)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(g, ctx.axis, ctx.kind), None, None, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        n, k = mesh.axis_size("tensor"), x.shape[-1]
        ctx.mesh, ctx.k = mesh, k
        x = x.contiguous()
        rows = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
        mesh.all_gather(rows, x.view(-1), "tensor")
        return rows.view(n, -1, k).transpose(0, 1).reshape(*x.shape[:-1],
                                                            n * k)

    @staticmethod
    def backward(ctx, g):
        a = ctx.mesh.axis_index("tensor") * ctx.k
        return g[..., a:a + ctx.k].contiguous(), None


def on(mesh, axis="tensor") -> bool:
    """Whether ``mesh`` (a world, or None) cuts anything over ``axis``."""
    return mesh is not None and mesh.axis_size(axis) > 1


def copy(x: torch.Tensor, mesh, axis="tensor", kind=None) -> torch.Tensor:
    """Enter products whose peers over ``axis`` each give a part of the
    input's gradient (module docstring); ``kind``: the
    ``WorldMesh.timings`` readings its backward counts in."""
    return _Copy.apply(x, mesh, axis, kind) if on(mesh, axis) else x


def reduce(x: torch.Tensor, mesh, axis="tensor", kind=None) -> torch.Tensor:
    """Leave products whose peers over ``axis`` each hold a part of the
    sum (module docstring)."""
    return _Reduce.apply(x, mesh, axis, kind) if on(mesh, axis) else x


def psum(x: torch.Tensor, mesh, axis="batch", kind=None) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, whose every rank goes on to use it
    (module docstring): forward and backward all-reduce."""
    return _Sum.apply(x, mesh, axis, kind) if on(mesh, axis) else x


def gather_vocab(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' vocab columns of ``logits``, whole (module
    docstring)."""
    return _GatherVocab.apply(logits, mesh) if on(mesh) else logits


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor, mesh,
                 dtype) -> torch.Tensor:
    """Rows of the rank's vocab slice ``table`` [V / tensor, D] for
    ``tokens`` in ``dtype``, summed over the axis (module docstring)."""
    local, hit = local_tokens(tokens, mesh.axis_index("tensor"),
                              table.shape[0])
    rows = table.to(dtype)[local]
    return reduce(torch.where(hit[..., None], rows, 0), mesh)

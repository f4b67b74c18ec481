"""The optax pieces the JAX ``training.trainer.make_optimizer`` uses,
ported by hand as plain functions over nested dicts of tensors
(counterpart of optax 0.2.6's ``schedules``, ``clipping``, ``alias.adamw``
and ``alias.adafactor``).

A transformation is an ``(init, update)`` pair as in optax: ``init(params)``
returns its state, ``update(updates, state, params)`` returns the new
updates and the state. Unlike optax, ``update`` writes the new state INTO
the tensors of the state it was given and returns that same state, and
``apply_updates`` adds the updates to the parameters IN PLACE (the JAX
version returns new arrays): a training step captured as a CUDA graph
(``training/step_graph.py``) reads and writes the same tensors at every
replay. Step counts are 0-d int32 tensors on the parameters' device, and
the learning rate, the bias corrections and the decay are computed from
them on the device in float32 (as optax's ``jnp`` arithmetic does), so
no update reads the host and a replay never sees a frozen count.

Under ``fsdp``, ``expert``, ``tensor`` and ``pipeline``
(``training/trainer.py`` with a ``parallel.mesh.WorldMesh``) each rank
updates its own part of every parameter, and ``Shards`` says how the
parts were cut: a leaf may be cut on one dim over ``fsdp``, another over
``expert``, a third over ``tensor`` and a fourth over ``pipeline`` (a
stage leaf's stage dim). A transformation
given one reduces over the ranks that hold the other parts of the
reduced dims wherever optax reduces over a whole leaf (the global norm
and the block rms of the update and of the parameter: over every axis
that cuts the leaf; the factored second moments' mean along a dim: over
the axis that cuts that dim), so every rank applies its part of the
unsharded update. A leaf no axis cuts (the norms under ``tensor``, the
router and the attention under ``expert``) is whole, and alike, on
every rank that holds it, and counts once. Without ``Shards`` nothing
changes.

``torch.optim`` is not used: ``torch.optim.Adafactor`` has no
``min_dim_size_to_factor`` and no ``multiply_by_parameter_scale``, and
``torch.optim.AdamW`` takes its learning rate from a scheduler object
rather than from the step count; the hand ports below follow optax's
formulas step for step, so the tests can hold them to the JAX trainer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]
DeviceSchedule = Callable[[torch.Tensor], torch.Tensor]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def named_leaves(tree, prefix: str = "") -> dict:
    """{path: leaf} over nested dicts, tuples and lists (an optimizer
    state); empty tuples (stateless transformations) give nothing."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out: dict = {}
    for k, v in items:
        out.update(named_leaves(v, f"{prefix}{k}/"))
    return out


def _count(params) -> torch.Tensor:
    """A step count: a 0-d int32 zero on the parameters' device."""
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], tuple[dict, Any]]


@dataclasses.dataclass(frozen=True)
class LeafCut:
    """One parameter held as a rank's part: the whole parameter's shape,
    the dim cut over ``fsdp`` (the group's one axis, where a group has
    one), the dim cut over ``tensor``, the dim cut over ``expert`` and
    the dim cut over ``pipeline`` (a stage leaf's ``pipe_stage`` dim;
    None: not cut over it)."""
    full_shape: tuple
    dim: Optional[int] = None
    tensor_dim: Optional[int] = None
    expert_dim: Optional[int] = None
    pipeline_dim: Optional[int] = None

    def _dims(self) -> tuple:
        return (("pipeline", self.pipeline_dim), ("fsdp", self.dim),
                ("expert", self.expert_dim), ("tensor", self.tensor_dim))

    @property
    def axes(self) -> tuple:
        """The axes that cut the leaf, in ``(pipeline, fsdp, expert,
        tensor)`` order."""
        return tuple(a for a, d in self._dims() if d is not None)

    def axis_of(self, dim: int) -> Optional[str]:
        """The axis that cuts ``dim``, or None."""
        for axis, d in self._dims():
            if d is not None and d == dim:
                return axis
        return None


@dataclasses.dataclass(frozen=True)
class Shards:
    """How the parameters an optimizer sees are cut over groups of ranks:
    ``cuts`` is a tree of ``LeafCut`` with the parameters' keys, and
    ``psum(t, axes)`` sums ``t`` in place over the ranks that differ on
    ``axes`` (a tuple of ``pipeline``, ``fsdp``, ``expert`` and
    ``tensor``) and returns
    it (every rank gets the same bytes)."""
    cuts: Any
    psum: Callable[[torch.Tensor, tuple], torch.Tensor]


def _cuts(shards: Optional[Shards], tree):
    """``shards``' cuts, or a tree of None (nothing cut) like ``tree``."""
    return shards.cuts if shards is not None \
        else tree_map(lambda _: None, tree)


def _cut_axes(cut: Optional[LeafCut]) -> tuple:
    return cut.axes if cut is not None else ()


def _leaf_mean(x: torch.Tensor, cut: Optional[LeafCut],
               shards: Optional[Shards]) -> torch.Tensor:
    """The mean of every element of the whole leaf that ``x`` is part of."""
    if not _cut_axes(cut):
        return torch.mean(x)
    return shards.psum(torch.sum(x), cut.axes) / math.prod(cut.full_shape)


def _dim_mean(x: torch.Tensor, dim: int, axis: Optional[str], full: int,
              shards: Optional[Shards], keepdim: bool = False
              ) -> torch.Tensor:
    """``x.mean(dim)`` of the whole leaf, when ``dim`` of ``full``
    elements is cut over ``axis``: summed over that axis first."""
    if axis is None:
        return x.mean(dim, keepdim=keepdim)
    return shards.psum(x.sum(dim, keepdim=keepdim), (axis,)) / full


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def _linear_schedule(init_value: float, end_value: float,
                     transition_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _cosine_decay_schedule(init_value: float, decay_steps: int,
                           alpha: float = 0.0,
                           exponent: float = 1.0) -> Schedule:
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = _linear_schedule(init_value, peak_value, warmup_steps)
    decay = _cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha, exponent)

    def schedule(count: int) -> float:
        return warmup(count) if count < warmup_steps \
            else decay(count - warmup_steps)
    return schedule


def device_warmup_cosine_decay_schedule(
        init_value: float, peak_value: float, warmup_steps: int,
        decay_steps: int, end_value: float = 0.0,
        exponent: float = 1.0) -> DeviceSchedule:
    """``warmup_cosine_decay_schedule`` on the device: the value at a 0-d
    integer count tensor as a 0-d float32 tensor, by optax's float32
    arithmetic in optax's order (``join_schedules`` of
    ``linear_schedule`` and ``cosine_decay_schedule``), with no host
    read."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    decay_len = decay_steps - warmup_steps
    if decay_len <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_len}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        if warmup_steps > 0:
            frac = 1.0 - torch.clamp(c, 0, warmup_steps) / warmup_steps
            warm = (init_value - peak_value) * frac + peak_value
        else:
            warm = torch.full_like(c, init_value)
        k = torch.clamp_max(c - warmup_steps, decay_len)
        cosine = 0.5 * (1 + torch.cos(math.pi * k / decay_len))
        decayed = peak_value * ((1 - alpha) * cosine ** exponent + alpha)
        return torch.where(c < warmup_steps, warm, decayed)
    return schedule


# ---------------------------------------------------------------------------
# Transformations
# ---------------------------------------------------------------------------

def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params):
        for tx, s in zip(txs, state):
            updates, _ = tx.update(updates, s, params)
        return updates, state

    return GradientTransformation(init, update)


def global_norm(tree, shards: Optional[Shards] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (a 0-d tensor); with
    ``shards``, of the whole leaves that ``tree`` holds parts of (the cut
    leaves' squares summed over the group, the whole ones once)."""
    if shards is None:
        return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(tree)))
    squares = [(torch.sum(x * x), _cut_axes(c)) for x, c in
               zip(tree_leaves(tree), tree_leaves(shards.cuts))]
    cuts = sorted({axes for _, axes in squares if axes})
    total = sum(shards.psum(sum(q for q, a in squares if a == axes), axes)
                for axes in cuts)
    return torch.sqrt(total + sum(q for q, axes in squares if not axes))


def clip_by_global_norm(max_norm: float,
                        shards: Optional[Shards] = None
                        ) -> GradientTransformation:
    """optax's form: ``where(norm < max, g, g / norm * max)`` (no epsilon,
    unlike ``torch.nn.utils.clip_grad_norm_``)."""
    def update(updates, state, params=None):
        norm = global_norm(updates, shards)
        keep = norm < max_norm
        return tree_map(lambda t: torch.where(keep, t, t / norm * max_norm),
                        updates), state

    return GradientTransformation(lambda params: (), update)


def _scale_by_schedule(schedule: DeviceSchedule, sign: float):
    """Multiply by ``sign * schedule(count)``; the count (a 0-d int32
    tensor) starts at 0 and is incremented in place."""
    def update(updates, count, params=None):
        lr = sign * schedule(count)
        count.add_(1)
        return tree_map(lambda u: u * lr, updates), count

    return GradientTransformation(_count, update)


def bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - decay ** count`` in float32, for a 0-d integer count
    tensor (the count after the increment)."""
    return 1 - torch.pow(decay, count.to(torch.float32))


def adamw(learning_rate: DeviceSchedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: bias-corrected Adam moments, decoupled weight decay on
    every leaf (optax masks nothing by default), then ``-lr(count)``. The
    moments and the count are updated in place."""
    def init(params):
        zeros = lambda p: torch.zeros_like(p)
        return {"count": _count(params), "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def update(updates, state, params):
        count = state["count"].add_(1)
        c1, c2 = bias_correction(b1, count), bias_correction(b2, count)
        tree_map(lambda m, g: m.mul_(b1).add_((1 - b1) * g), state["mu"],
                 updates)
        tree_map(lambda v, g: v.mul_(b2).add_((1 - b2) * g * g),
                 state["nu"], updates)
        out = tree_map(
            lambda m, v, p: (m / c1) / (torch.sqrt(v / c2) + eps)
            + weight_decay * p, state["mu"], state["nu"], params)
        return out, state

    return chain(GradientTransformation(init, update),
                 _scale_by_schedule(learning_rate, -1.0))


def _factored_dims(shape, min_dim_size_to_factor: int):
    """The two largest dims (second largest, largest) when the second
    largest is at least ``min_dim_size_to_factor``; optax's rule, with its
    numpy argsort for ties."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def adafactor_decay(count: torch.Tensor,
                    decay_rate: float = 0.8) -> torch.Tensor:
    """optax's second-moment decay ``1 - t ** -decay_rate`` with
    ``t = count + 1`` in float32, for a 0-d integer count tensor (the
    count before the increment)."""
    return 1.0 - torch.pow((count + 1).to(torch.float32), -decay_rate)


def _scale_by_factored_rms(min_dim_size_to_factor: int, decay_rate: float,
                           eps: float, shards: Optional[Shards] = None
                           ) -> GradientTransformation:
    """The factored second moments. Which dims factor is decided on the
    whole leaf's shape; a rank's moments are those of its part, and a
    mean along the cut dim is summed over the group (so a moment that
    lost the cut dim is whole, and equal, on every rank)."""
    def shape_of(p, cut):
        return tuple(cut.full_shape) if cut is not None else tuple(p.shape)

    def init(params):
        def leaf(p, cut):
            dims = _factored_dims(shape_of(p, cut), min_dim_size_to_factor)
            if dims is None:
                return {"v": torch.zeros_like(p)}
            d1, d0 = dims
            return {"v_row": p.new_zeros(p.shape[:d0] + p.shape[d0 + 1:]),
                    "v_col": p.new_zeros(p.shape[:d1] + p.shape[d1 + 1:])}
        return {"count": _count(params),
                "v": tree_map(leaf, params, _cuts(shards, params))}

    def update(updates, state, params):
        decay = adafactor_decay(state["count"], decay_rate)

        def leaf(g, v, cut):
            g_sqr = g * g + eps
            full = shape_of(g, cut)
            dims = _factored_dims(full, min_dim_size_to_factor)
            if dims is None:
                new_v = v["v"].copy_(decay * v["v"] + (1.0 - decay) * g_sqr)
                return g * new_v.rsqrt()
            d1, d0 = dims
            ax = cut.axis_of if cut is not None else (lambda d: None)
            v_row = v["v_row"].copy_(
                decay * v["v_row"] + (1.0 - decay)
                * _dim_mean(g_sqr, d0, ax(d0), full[d0], shards))
            v_col = v["v_col"].copy_(
                decay * v["v_col"] + (1.0 - decay)
                * _dim_mean(g_sqr, d1, ax(d1), full[d1], shards))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = _dim_mean(v_row, reduced_d1, ax(d1), full[d1],
                                     shards, keepdim=True)
            row_factor = (v_row / row_col_mean).rsqrt()
            col_factor = v_col.rsqrt()
            return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)

        out = tree_map(leaf, updates, state["v"], _cuts(shards, updates))
        state["count"].add_(1)
        return out, state

    return GradientTransformation(init, update)


def _clip_by_block_rms(threshold: float, shards: Optional[Shards] = None
                       ) -> GradientTransformation:
    def update(updates, state, params=None):
        def clip(u, cut):
            rms = torch.sqrt(_leaf_mean(u * u, cut, shards))
            return u / torch.clamp_min(rms / threshold, 1.0)
        return tree_map(clip, updates, _cuts(shards, updates)), state

    return GradientTransformation(lambda params: (), update)


def _scale_by_param_block_rms(min_scale: float = 1e-3,
                              shards: Optional[Shards] = None):
    def update(updates, state, params):
        def scale(u, p, cut):
            rms = torch.sqrt(_leaf_mean(p * p, cut, shards))
            return u * torch.where(rms <= min_scale,
                                   torch.full_like(rms, min_scale), rms)
        return tree_map(scale, updates, params,
                        _cuts(shards, updates)), state

    return GradientTransformation(lambda params: (), update)


def adafactor(learning_rate: DeviceSchedule,
              min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, clipping_threshold: float = 1.0,
              multiply_by_parameter_scale: bool = True,
              eps: float = 1e-30,
              shards: Optional[Shards] = None) -> GradientTransformation:
    """optax.adafactor with its defaults: factored second moments over
    each leaf's two largest dims (when the smaller of them is at least
    ``min_dim_size_to_factor``), update clipping by block rms,
    ``lr(count)``, scaling by the parameter's rms (at least 1e-3), then a
    sign flip. No momentum and no weight decay, as optax's defaults.
    ``shards``: the parameters are parts cut over a group (module
    docstring)."""
    txs = [_scale_by_factored_rms(min_dim_size_to_factor, decay_rate, eps,
                                  shards)]
    if clipping_threshold is not None:
        txs.append(_clip_by_block_rms(clipping_threshold, shards))
    txs.append(_scale_by_schedule(learning_rate, 1.0))
    if multiply_by_parameter_scale:
        txs.append(_scale_by_param_block_rms(shards=shards))
    txs.append(GradientTransformation(
        lambda params: (),
        lambda updates, state, params=None: (
            tree_map(lambda u: -u, updates), state)))
    return chain(*txs)


def apply_updates(params, updates) -> None:
    """params += updates, leaf by leaf, IN PLACE (no autograd record)."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)

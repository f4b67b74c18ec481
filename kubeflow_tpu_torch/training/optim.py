"""The optax pieces the JAX ``training.trainer.make_optimizer`` uses,
ported by hand as plain functions over nested dicts of tensors
(counterpart of optax 0.2.6's ``schedules``, ``clipping``, ``alias.adamw``
and ``alias.adafactor``).

A transformation is an ``(init, update)`` pair as in optax: ``init(params)``
returns its state, ``update(updates, state, params)`` returns the new
updates and state; ``chain`` composes them and ``apply_updates`` adds the
result to the parameters IN PLACE (the JAX version returns new arrays;
here the float32 parameters are updated where they lie, which saves a
copy of the model). Step counts are host integers, so no update waits on
the device.

``torch.optim`` is not used: ``torch.optim.Adafactor`` has no
``min_dim_size_to_factor`` and no ``multiply_by_parameter_scale``, and
``torch.optim.AdamW`` takes its learning rate from a scheduler object
rather than from the step count; the hand ports below follow optax's
formulas step for step, so the tests can hold them to the JAX trainer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

Schedule = Callable[[int], float]


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


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], tuple[dict, Any]]


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


# ---------------------------------------------------------------------------
# Transformations
# ---------------------------------------------------------------------------

def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(tree)))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's form: ``where(norm < max, g, g / norm * max)`` (no epsilon,
    unlike ``torch.nn.utils.clip_grad_norm_``)."""
    def update(updates, state, params=None):
        norm = global_norm(updates)
        keep = norm < max_norm
        return tree_map(lambda t: torch.where(keep, t, t / norm * max_norm),
                        updates), state

    return GradientTransformation(lambda params: (), update)


def _scale_by_schedule(schedule: Schedule, sign: float):
    """Multiply by ``sign * schedule(count)``; the count starts at 0."""
    def update(updates, count, params=None):
        lr = sign * schedule(count)
        return tree_map(lambda u: u * lr, updates), count + 1

    return GradientTransformation(lambda params: 0, update)


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: bias-corrected Adam moments, decoupled weight decay on
    every leaf (optax masks nothing by default), then ``-lr(count)``."""
    def init(params):
        zeros = lambda p: torch.zeros_like(p)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def update(updates, state, params):
        count = state["count"] + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"],
                      updates)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"],
                      updates)
        out = tree_map(
            lambda m, v, p: (m / c1) / (torch.sqrt(v / c2) + eps)
            + weight_decay * p, mu, nu, params)
        return out, {"count": count, "mu": mu, "nu": nu}

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


def _scale_by_factored_rms(min_dim_size_to_factor: int, decay_rate: float,
                           eps: float) -> GradientTransformation:
    def init(params):
        def leaf(p):
            dims = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if dims is None:
                return {"v": torch.zeros_like(p)}
            d1, d0 = dims
            return {"v_row": p.new_zeros(p.shape[:d0] + p.shape[d0 + 1:]),
                    "v_col": p.new_zeros(p.shape[:d1] + p.shape[d1 + 1:])}
        return {"count": 0, "v": tree_map(leaf, params)}

    def update(updates, state, params):
        t = float(np.float32(state["count"] + 1))
        decay = 1.0 - t ** (-decay_rate)

        def leaf(g, v):
            g_sqr = g * g + eps
            dims = _factored_dims(tuple(g.shape), min_dim_size_to_factor)
            if dims is None:
                new_v = decay * v["v"] + (1.0 - decay) * g_sqr
                return g * new_v.rsqrt(), {"v": new_v}
            d1, d0 = dims
            v_row = decay * v["v_row"] + (1.0 - decay) * g_sqr.mean(d0)
            v_col = decay * v["v_col"] + (1.0 - decay) * g_sqr.mean(d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean).rsqrt()
            col_factor = v_col.rsqrt()
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            return u, {"v_row": v_row, "v_col": v_col}

        pairs = tree_map(lambda g, v: leaf(g, v), updates, state["v"])
        out = tree_map(lambda pair: pair[0], pairs)
        new_v = tree_map(lambda pair: pair[1], pairs)
        return out, {"count": state["count"] + 1, "v": new_v}

    return GradientTransformation(init, update)


def _clip_by_block_rms(threshold: float) -> GradientTransformation:
    def update(updates, state, params=None):
        def clip(u):
            rms = torch.sqrt(torch.mean(u * u))
            return u / torch.clamp_min(rms / threshold, 1.0)
        return tree_map(clip, updates), state

    return GradientTransformation(lambda params: (), update)


def _scale_by_param_block_rms(min_scale: float = 1e-3):
    def update(updates, state, params):
        def scale(u, p):
            rms = torch.sqrt(torch.mean(p * p))
            return u * torch.where(rms <= min_scale,
                                   torch.full_like(rms, min_scale), rms)
        return tree_map(scale, updates, params), state

    return GradientTransformation(lambda params: (), update)


def adafactor(learning_rate: Schedule, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, clipping_threshold: float = 1.0,
              multiply_by_parameter_scale: bool = True,
              eps: float = 1e-30) -> GradientTransformation:
    """optax.adafactor with its defaults: factored second moments over
    each leaf's two largest dims (when the smaller of them is at least
    ``min_dim_size_to_factor``), update clipping by block rms,
    ``lr(count)``, scaling by the parameter's rms (at least 1e-3), then a
    sign flip. No momentum and no weight decay, as optax's defaults."""
    txs = [_scale_by_factored_rms(min_dim_size_to_factor, decay_rate, eps)]
    if clipping_threshold is not None:
        txs.append(_clip_by_block_rms(clipping_threshold))
    txs.append(_scale_by_schedule(learning_rate, 1.0))
    if multiply_by_parameter_scale:
        txs.append(_scale_by_param_block_rms())
    txs.append(GradientTransformation(
        lambda params: (),
        lambda updates, state, params=None: (
            tree_map(lambda u: -u, updates), state)))
    return chain(*txs)


def apply_updates(params, updates) -> None:
    """params += updates, leaf by leaf, IN PLACE (no autograd record)."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)

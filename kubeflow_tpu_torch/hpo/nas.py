"""DARTS, the one-shot differentiable architecture search, in the PyTorch
port (counterpart of ``kubeflow_tpu.hpo.nas.darts_search``).

A supernet of mixed ops (a continuous relaxation over architecture
weights alpha), bilevel-optimized with the reference's first-order
alternation (weights on the train split, alphas on the validation
split), discretized by argmax, then retrained from fresh weights. The
reference's procedure step by step: targets standardized in numpy
(``std`` over ``ddof=0`` plus 1e-6), ``width = max(d_in, d_out, 8)``,
alphas frozen for ``warmup = steps // 4`` steps, ties of the argmax to
the first maximum (as ``jnp.argmax``), the retrain's weights drawn with
``seed + 1``.

The initial weights come from a ``torch.Generator`` seeded with ``seed``
(and ``seed + 1`` for the retrain), drawn on the CPU so that every
device starts from the same values. JAX's threefry draws cannot be
reproduced in torch; ``weights0`` hands the search given initial weights
instead (``interop.darts_weights0`` turns JAX's draws into them).

``ENASSearch``, the REINFORCE controller, is numpy control-plane code
and stays the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device

# parameter-free candidate ops on [B, D] activations; "zero" lets DARTS
# prune a node away entirely (the DARTS none-op)
CANDIDATE_OPS: dict[str, Callable] = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "square": lambda x: x * x,
    "zero": torch.zeros_like,
}


@dataclasses.dataclass
class DartsRun:
    """What one search leaves: the selected op names per node, the val
    loss of the discrete architecture with retrained weights, and the
    tensors behind them (alphas ``[n_nodes, len(ops)]``, the searched
    weights and the retrained weights, each ``{"w_in", "w_out"}``)."""
    selected: list
    val: float
    alphas: torch.Tensor
    weights: dict
    retrained: dict


def _draw(seed: int, d_in: int, d_out: int, width: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"w_in": torch.randn((d_in, width), generator=g)
            / math.sqrt(d_in),
            "w_out": torch.randn((width, d_out), generator=g)
            / math.sqrt(width)}


def darts_run(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: np.ndarray,
    y_val: np.ndarray,
    *,
    ops: Sequence[str] = ("identity", "relu", "tanh", "sigmoid", "square"),
    n_nodes: int = 2,
    steps: int = 800,
    warmup: Optional[int] = None,
    lr_w: float = 0.05,
    lr_alpha: float = 0.05,
    seed: int = 0,
    device: DeviceLike = None,
    weights0: Optional[dict] = None,
) -> DartsRun:
    """``darts_search`` with everything it computed (``DartsRun``)."""
    dev = resolve_device(device)
    op_fns = [CANDIDATE_OPS[o] for o in ops]
    mu, sd = y_train.mean(0), y_train.std(0) + 1e-6
    y_train = (y_train - mu) / sd
    y_val = (y_val - mu) / sd
    if warmup is None:
        warmup = steps // 4
    d_in = x_train.shape[1]
    d_out = y_train.shape[1]
    width = int(max(d_in, d_out, 8))
    if weights0 is None:
        init = _draw(seed, d_in, d_out, width)
        fresh = _draw(seed + 1, d_in, d_out, width)
    else:
        init = {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in weights0["search"].items()}
        fresh = {k: torch.from_numpy(np.array(v, np.float32))
                 for k, v in weights0["retrain"].items()}
    for tree in (init, fresh):
        if (tuple(tree["w_in"].shape), tuple(tree["w_out"].shape)) != (
                (d_in, width), (width, d_out)):
            raise ValueError(
                f"weights0 must be w_in [{d_in}, {width}] and w_out "
                f"[{width}, {d_out}], got {tree['w_in'].shape} and "
                f"{tree['w_out'].shape}")
    weights = {k: v.to(dev) for k, v in init.items()}
    alphas = torch.zeros((n_nodes, len(op_fns)), device=dev)

    def forward(weights, alphas, x, hard_idx=None):
        h = x @ weights["w_in"]
        for i in range(n_nodes):
            if hard_idx is not None:
                outs = torch.stack([f(h) for f in op_fns])
                h = outs[hard_idx[i]]
            else:
                mix = torch.softmax(alphas[i], dim=0)
                h = sum(m * f(h) for m, f in zip(mix, op_fns))
        return h @ weights["w_out"]

    def loss(weights, alphas, x, y, hard_idx=None):
        pred = forward(weights, alphas, x, hard_idx)
        return torch.mean((pred - y) ** 2)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    xt, yt = f32(x_train), f32(y_train)
    xv, yv = f32(x_val), f32(y_val)

    def w_step(weights, alphas, hard_idx=None):
        leaves = {k: w.detach().requires_grad_(True)
                  for k, w in weights.items()}
        with torch.enable_grad():
            g = torch.autograd.grad(
                loss(leaves, alphas, xt, yt, hard_idx),
                list(leaves.values()))
        return {k: w - lr_w * gk
                for (k, w), gk in zip(weights.items(), g)}

    def a_step(weights, alphas):
        leaf = alphas.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss(weights, leaf, xv, yv), [leaf])
        return alphas - lr_alpha * g

    with torch.no_grad():
        for i in range(steps):
            weights = w_step(weights, alphas)
            if i >= warmup:
                alphas = a_step(weights, alphas)

        # ties go to the first maximum, as jnp.argmax's
        idx = [int(i) for i in np.argmax(alphas.cpu().numpy(), axis=1)]
        selected = [ops[i] for i in idx]

        # retrain the weights of the DISCRETE architecture from scratch
        # (the standard DARTS evaluation protocol, miniaturized)
        retrained = {k: v.to(dev) for k, v in fresh.items()}
        for _ in range(steps):
            retrained = w_step(retrained, alphas, idx)
        val = float(loss(retrained, alphas, xv, yv, idx))
    return DartsRun(selected, val, alphas, weights, retrained)


def darts_search(x_train, y_train, x_val, y_val, *,
                 ops: Sequence[str] = ("identity", "relu", "tanh",
                                       "sigmoid", "square"),
                 n_nodes: int = 2, steps: int = 800,
                 warmup: Optional[int] = None, lr_w: float = 0.05,
                 lr_alpha: float = 0.05, seed: int = 0,
                 device: DeviceLike = None,
                 weights0: Optional[dict] = None) -> tuple[list[str], float]:
    """One-shot DARTS over a sequential cell of ``n_nodes`` mixed ops
    (the reference's contract, module docstring).

    Supernet: h_0 = x W_in; h_i = sum_o softmax(alpha_i)_o op_o(h_{i-1});
    y_hat = h_n W_out. ``weights0``: ``{"search": {"w_in", "w_out"},
    "retrain": {"w_in", "w_out"}}`` of numpy float32 arrays, the initial
    weights in place of the seeded draws. Returns (selected op names per
    node, val loss of the DISCRETE architecture with retrained weights,
    in standardized-target units: a constant predictor scores ~1.0)."""
    run = darts_run(x_train, y_train, x_val, y_val, ops=ops,
                    n_nodes=n_nodes, steps=steps, warmup=warmup, lr_w=lr_w,
                    lr_alpha=lr_alpha, seed=seed, device=device,
                    weights0=weights0)
    return run.selected, run.val

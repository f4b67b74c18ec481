"""One-device training step (counterpart of
``kubeflow_tpu.training.trainer``): train state, token-weighted gradient
accumulation over micro batches, global-norm clipping and adamw or
adafactor.

The JAX trainer jits one sharded step over a mesh. The port runs on one
card eagerly: ``loss.backward()`` per micro batch accumulates into the
float32 parameters' ``.grad``, and the optimizer (``training.optim``)
updates the parameters in place. ``TrainerConfig.rules`` (logical axis ->
mesh rules) is kept for the same fields and ignored: one card has no
mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.ops.losses import softmax_cross_entropy
from kubeflow_tpu_torch.training import optim
from kubeflow_tpu_torch.training.data import to_device

MOE_SLICE = ("MoE losses (n_experts > 0) are a later slice of the PyTorch "
             "port (ROADMAP queue 1: MoE)")
DEPOT_SLICE = ("ahead-of-time lowering and capture of the training step (a "
               "CUDA graph of the micro batch, its backward and the "
               "optimizer) are a later slice of the PyTorch port (ROADMAP "
               "queue 1 item 6.1)")


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    grad_accum: int = 1
    # "adamw": full f32 m/v (2x params of state). "adafactor": factored
    # second moment (state ~ O(rows+cols)).
    optimizer: str = "adamw"
    rules: Mapping[str, object] | None = None   # kept; one card, no mesh
    # the metric holding each micro batch's loss weight (its token count)
    # and the metrics summed, not averaged, over micro batches
    weight_metric: str = "tokens"
    count_metrics: tuple = ("tokens",)


def make_optimizer(cfg: TrainerConfig) -> optim.GradientTransformation:
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_steps,
        max(cfg.total_steps, cfg.warmup_steps + 1),
        end_value=cfg.learning_rate * 0.1)
    if cfg.optimizer == "adafactor":
        # no weight decay: optax.adafactor would apply it after the lr
        # scaling, as a raw fraction per step (the JAX trainer's choice)
        return optim.chain(optim.clip_by_global_norm(cfg.grad_clip),
                           optim.adafactor(schedule))
    if cfg.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return optim.chain(
        optim.clip_by_global_norm(cfg.grad_clip),
        optim.adamw(schedule, b1=cfg.b1, b2=cfg.b2,
                    weight_decay=cfg.weight_decay))


class Trainer:
    """Owns the train state (float32 parameters and optimizer state on one
    device) and the step.

    ``init_params_fn(generator) -> params`` builds a nested dict of
    tensors; ``loss_fn(params, batch) -> (loss, metrics)`` with the loss a
    0-d tensor and ``metrics[config.weight_metric]`` its weight. The
    device is ``device.resolve_device(device)``: CUDA unless ``"cpu"`` is
    asked for.
    """

    def __init__(self, init_params_fn: Callable[[torch.Generator], Any],
                 loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
                 config: TrainerConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.init_params_fn = init_params_fn
        self.loss_fn = loss_fn
        self.config = config
        self.optimizer = make_optimizer(config)
        self.params = None
        self.opt_state = None
        self.step = 0

    def init_state(self, generator: Optional[torch.Generator] = None):
        """Parameters from ``init_params_fn(generator)`` (a generator on
        the trainer's device seeded 0 when none is given), placed on the
        device as float32 leaves that record gradients; fresh optimizer
        state."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = self.init_params_fn(generator)
        self.params = optim.tree_map(
            lambda p: p.detach().to(self.device).requires_grad_(True),
            params)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0
        return self.params

    def _grads(self, batch):
        """(loss, metrics, grads) of one batch, token-weighted over
        ``grad_accum`` micro batches: sum loss*w, grads*w and w over the
        micro batches and divide once, so the result is the global
        token-weighted mean however mask density varies between them.
        Count metrics are summed, the others averaged."""
        params = self.params
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.grad = None
        accum = self.config.grad_accum
        if accum <= 1:
            loss, metrics = self.loss_fn(params, batch)
            loss.backward()
            grads = optim.tree_map(lambda p: p.grad, params)
            return loss.detach(), _detached(metrics), grads
        n = next(iter(batch.values())).shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} rows does not split into "
                             f"grad_accum={accum} micro batches")
        micro = {k: v.reshape(accum, n // accum, *v.shape[1:])
                 for k, v in batch.items()}
        weight_key = self.config.weight_metric
        loss_sum = w_sum = 0.0
        m_sum: dict = {}
        for i in range(accum):
            loss, metrics = self.loss_fn(params, {k: v[i]
                                                  for k, v in micro.items()})
            w = torch.as_tensor(metrics.get(weight_key, 1.0),
                                dtype=torch.float32,
                                device=self.device).detach()
            (loss * w).backward()
            loss_sum = loss_sum + loss.detach() * w
            w_sum = w_sum + w
            for k, v in _detached(metrics).items():
                m_sum[k] = m_sum[k] + v if k in m_sum else v
        denom = torch.clamp_min(w_sum, 1e-8)
        grads = optim.tree_map(lambda p: p.grad / denom, params)
        counts = set(self.config.count_metrics)
        metrics = {k: v if k in counts else v / accum
                   for k, v in m_sum.items()}
        return loss_sum / denom, metrics, grads

    def train_step(self, batch) -> dict:
        """One optimizer step on ``batch`` (a dict of host arrays or
        tensors, placed on the trainer's device). Returns the metrics as
        0-d tensors: the loss function's, plus ``loss`` and ``grad_norm``
        (the global norm of the averaged gradients, before clipping)."""
        if self.params is None:
            raise ValueError("train_step needs init_state() first")
        batch = to_device(batch, self.device)
        loss, metrics, grads = self._grads(batch)
        with torch.no_grad():
            gnorm = optim.global_norm(grads)
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.params)
            optim.apply_updates(self.params, updates)
        for p in optim.tree_leaves(self.params):
            p.grad = None
        self.step += 1
        return dict(metrics, loss=loss, grad_norm=gnorm)

    def precompile(self, *args, **kwargs):
        raise NotImplementedError(DEPOT_SLICE)

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(DEPOT_SLICE)


def _detached(metrics: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def lm_loss_fn(forward, cfg):
    """Next-token LM loss for a model ``forward(params, tokens, cfg)``.

    Batch: {"tokens": [B, S+1] integer, "mask": optional [B, S+1]}.
    """
    if getattr(cfg, "n_experts", 0):
        raise NotImplementedError(MOE_SLICE)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits = forward(params, inputs, cfg)
        mask = batch.get("mask")
        mask = mask[:, 1:] if mask is not None else None
        loss, aux = softmax_cross_entropy(
            logits, targets, mask, z_loss=getattr(cfg, "z_loss", 0.0))
        return loss, {"tokens": aux["total_weight"]}

    return loss_fn

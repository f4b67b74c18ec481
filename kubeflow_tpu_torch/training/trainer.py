"""One-device training step (counterpart of
``kubeflow_tpu.training.trainer``): train state, token-weighted gradient
accumulation over micro batches, global-norm clipping and adamw or
adafactor.

The JAX trainer jits one sharded step over a mesh. The port runs on one
card, and its step is two bodies over static tensors: the micro body
runs one micro batch's forward and ``backward``, which accumulates into
the float32 parameters' ``.grad`` (allocated once, at ``init_state``),
and the finish body averages, runs the optimizer (``training.optim``)
and updates the parameters in place. ``train_step`` runs them eagerly;
after ``precompile`` it replays them as CUDA graphs
(``training/step_graph.py``), the same code on the same tensors.
``TrainerConfig.rules`` (logical axis -> mesh rules) is kept for the same
fields and ignored: one card has no mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.ops import flash_attention
from kubeflow_tpu_torch.ops.losses import softmax_cross_entropy
from kubeflow_tpu_torch.parallel.depot import local_capture
from kubeflow_tpu_torch.training import optim
from kubeflow_tpu_torch.training.data import BatchBuffers
from kubeflow_tpu_torch.training.step_graph import StepGraph

AOT_SLICE = ("lowering the training step without arrays, for the "
             "shape-level memory and FLOP accounting of parallel/aot.py, "
             "is a later slice of the PyTorch port (ROADMAP queue 1 item "
             "8.11)")
# the kernel wrappers whose launches a replayed step adds to
_COUNTERS = (flash_attention.flash_attention_fwd,
             flash_attention.flash_attention_dq,
             flash_attention.flash_attention_dkv)


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
    schedule = optim.device_warmup_cosine_decay_schedule(
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
    """Owns the train state (float32 parameters, their gradient
    accumulators and the optimizer state on one device) and the step.

    ``init_params_fn(generator) -> params`` builds a nested dict of
    tensors; ``loss_fn(params, batch) -> (loss, metrics)`` with the loss a
    0-d tensor and ``metrics[config.weight_metric]`` its weight. The
    device is ``device.resolve_device(device)``: CUDA unless ``"cpu"`` is
    asked for.

    Every state tensor is written in place, step after step: the
    parameters and their ``.grad``, the optimizer state (its counts are
    0-d device tensors), the sums over micro batches, the staged batch
    (``data.BatchBuffers``) and the outputs. So the step a CUDA graph
    captured (``precompile``) reads and writes them at every replay.
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
        self.step_graph: Optional[StepGraph] = None
        self.depot_outcome: Optional[str] = None

    def init_state(self, generator: Optional[torch.Generator] = None):
        """Parameters from ``init_params_fn(generator)`` (a generator on
        the trainer's device seeded 0 when none is given), placed on the
        device as float32 leaves that record gradients, each with a zero
        ``.grad`` (the gradient accumulator); fresh optimizer state."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = self.init_params_fn(generator)
        self.params = optim.tree_map(
            lambda p: p.detach().to(self.device).requires_grad_(True),
            params)
        for p in optim.tree_leaves(self.params):
            p.grad = torch.zeros_like(p)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0
        zero = lambda: torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        # loss * w and w summed over the micro batches, and each metric
        # (added at its first micro batch)
        self._sums = {"loss": zero(), "weight": zero()}
        self._metric_sums: dict = {}
        # the micro batch the micro body reads next, on the device
        self._micro = torch.zeros((1,), dtype=torch.long, device=self.device)
        self._outputs: dict = {}
        self._batch: Optional[BatchBuffers] = None
        self.step_graph = None
        return self.params

    def _stage(self, batch) -> None:
        """Copy ``batch`` into the static batch, made for its key set,
        shapes and dtypes at the first step (and again when they change,
        unless a captured step pins them)."""
        n = len(next(iter(batch.values())))
        accum = self.config.grad_accum
        if n % accum:
            raise ValueError(f"batch of {n} rows does not split into "
                             f"grad_accum={accum} micro batches")
        if self._batch is None or not self._batch.matches(batch):
            if self.step_graph is not None:
                raise ValueError(
                    "precompile captured the step for batches of "
                    f"{self._batch.spec}; this batch differs in its keys, "
                    "shapes or dtypes")
            self._batch = BatchBuffers(batch, self.device)
        self._batch.stage(batch)

    def _micro_body(self) -> None:
        """Step body (a), one micro batch: micro batch ``_micro`` of the
        staged batch through ``loss_fn`` and backward, accumulating the
        gradients (times the weight ``metrics[weight_metric]`` when
        ``grad_accum`` > 1) into ``.grad``, and loss * w, w and the
        metrics into the sums."""
        accum = self.config.grad_accum
        micro = {k: v.view(accum, -1, *v.shape[1:]).index_select(
                     0, self._micro)[0]
                 for k, v in self._batch.tensors.items()}
        loss, metrics = self.loss_fn(self.params, micro)
        w = metrics.get(self.config.weight_metric) if accum > 1 else None
        if w is None:
            loss.backward()
        else:
            w = torch.as_tensor(w, dtype=torch.float32,
                                device=self.device).detach()
            (loss * w).backward()
        with torch.no_grad():
            sums = self._sums
            sums["loss"].add_(loss if w is None else loss * w)
            sums["weight"].add_(1.0 if w is None else w)
            for k, v in metrics.items():
                if k not in self._metric_sums:
                    self._metric_sums[k] = torch.zeros_like(
                        torch.as_tensor(v, device=self.device))
                self._metric_sums[k].add_(v)
            self._micro.add_(1)

    def _finish_body(self) -> None:
        """Step body (b): divide the sums by max(sum w, 1e-8), so the
        result is the global token-weighted mean however mask density
        varies between micro batches; the global norm of the averaged
        gradients (before clipping); the optimizer, applied in place;
        the outputs (the loss function's metrics, count metrics summed
        and the others averaged, plus ``loss`` and ``grad_norm``) written
        into the static outputs; the accumulators zeroed."""
        accum = self.config.grad_accum
        counts = set(self.config.count_metrics)
        with torch.no_grad():
            sums = self._sums
            denom = torch.clamp_min(sums["weight"], 1e-8)
            grads = optim.tree_map(lambda p: p.grad.div_(denom), self.params)
            gnorm = optim.global_norm(grads)
            updates, _ = self.optimizer.update(grads, self.opt_state,
                                               self.params)
            optim.apply_updates(self.params, updates)
            out = {k: v if k in counts else v / accum
                   for k, v in self._metric_sums.items()}
            out.update(loss=sums["loss"] / denom, grad_norm=gnorm)
            for k, v in out.items():
                if k not in self._outputs:
                    self._outputs[k] = torch.zeros_like(v)
                self._outputs[k].copy_(v)
            for g in optim.tree_leaves(grads):
                g.zero_()
            for v in (*sums.values(), *self._metric_sums.values()):
                v.zero_()
            self._micro.zero_()

    def _state_tensors(self) -> dict:
        """Every tensor the step bodies keep across steps, by name."""
        out = {f"param/{k}": p
               for k, p in optim.named_leaves(self.params).items()}
        out.update({f"grad/{k}": p.grad
                    for k, p in optim.named_leaves(self.params).items()})
        out.update({f"opt/{k}": t
                    for k, t in optim.named_leaves(self.opt_state).items()})
        out.update({f"sum/{k}": t for k, t in self._sums.items()})
        out.update({f"metric/{k}": t for k, t in self._metric_sums.items()})
        out.update({f"out/{k}": t for k, t in self._outputs.items()})
        out["micro"] = self._micro
        if self._batch is not None:
            out.update({f"batch/{k}": t
                        for k, t in self._batch.tensors.items()})
        return out

    def train_step(self, batch) -> dict:
        """One optimizer step on ``batch`` (a dict of host arrays or
        tensors, staged on the trainer's device). Returns the metrics as
        0-d tensors: the loss function's, plus ``loss`` and ``grad_norm``
        (the global norm of the averaged gradients, before clipping).
        After ``precompile`` the step replays the captured graphs, and a
        batch of another key set, shape or dtype raises ValueError."""
        if self.params is None:
            raise ValueError("train_step needs init_state() first")
        self._stage(batch)
        if self.step_graph is not None:
            self.step_graph.replay()
        else:
            for _ in range(self.config.grad_accum):
                self._micro_body()
            self._finish_body()
        self.step += 1
        # the outputs are static: the next step overwrites them
        return {k: v.clone() for k, v in self._outputs.items()}

    def precompile(self, batch, depot=None, stats=None,
                   wait_s: float = 0.0) -> str:
        """Capture the step for ``batch``'s keys, shapes and dtypes as
        CUDA graphs (``training/step_graph.StepGraph``), the counterpart
        of the JAX trainer's ``precompile`` (which AOT-compiles the step
        for those shapes). From then on ``train_step`` replays them, and
        refuses a batch of other shapes. The warm-up trains, and is
        undone: the state is left bitwise as it was. Returns "no_depot"
        (JAX's outcome without a depot) or, with a ``depot``, "compiled"
        with ``stats`` counting the capture and its serialize failure
        (``parallel/depot.local_capture``: the graphs never leave this
        process), also kept as ``self.depot_outcome``; ``wait_s`` is
        unused (no publish to wait for). The capture's seconds, pool
        bytes and replays are on
        ``self.step_graph``. No autograd graph that reaches the
        parameters may be alive when it runs (a tensor computed from them
        with gradients recorded, such as a kept loss): it holds their
        gradient accumulator nodes on the stream they were made on, and
        the capture cannot depend on that stream.

        Raises ValueError before ``init_state`` (JAX's check) and on a
        CPU trainer (there is no graph and no stand-in)."""
        if self.params is None:
            raise ValueError("precompile needs init_state() first")
        if self.device.type != "cuda":
            raise ValueError(f"precompile captures the training step as "
                             f"CUDA graphs; this trainer runs on "
                             f"{self.device}")
        self.step_graph = None
        self._stage(batch)
        self.step_graph = StepGraph(
            self._micro_body, self._finish_body, self._state_tensors,
            self.config.grad_accum, _COUNTERS, self.device)
        self.depot_outcome = local_capture(depot, stats)
        return self.depot_outcome

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(AOT_SLICE)


def lm_loss_fn(forward, cfg):
    """Next-token LM loss for a model ``forward(params, tokens, cfg)``.
    MoE configs (``n_experts > 0``) call ``forward(..., return_aux=True)``,
    add the summed MoE penalties to the loss and report them as the
    ``moe_aux`` metric.

    Batch: {"tokens": [B, S+1] integer, "mask": optional [B, S+1]}.
    """
    moe = bool(getattr(cfg, "n_experts", 0))

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        if moe:
            logits, fwd_aux = forward(params, inputs, cfg, return_aux=True)
        else:
            logits = forward(params, inputs, cfg)
        mask = batch.get("mask")
        mask = mask[:, 1:] if mask is not None else None
        loss, aux = softmax_cross_entropy(
            logits, targets, mask, z_loss=getattr(cfg, "z_loss", 0.0))
        metrics = {"tokens": aux["total_weight"]}
        if moe:
            loss = loss + fwd_aux["moe_aux"]
            metrics["moe_aux"] = fwd_aux["moe_aux"].detach()
        return loss, metrics

    return loss_fn

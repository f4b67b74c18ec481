"""The training step (counterpart of ``kubeflow_tpu.training.trainer``):
train state, token-weighted gradient accumulation over micro batches,
global-norm clipping and adamw or adafactor, on one card or over a world
of processes.

The JAX trainer jits one sharded step over a mesh. The port's step is
two bodies over static tensors: the micro body runs one micro batch's
forward and ``backward``, which accumulates into the float32 parameters'
``.grad`` (allocated once, at ``init_state``), and the finish body
averages, runs the optimizer (``training.optim``) and updates the
parameters in place. ``train_step`` runs them eagerly; after
``precompile`` it replays them as CUDA graphs
(``training/step_graph.py``), the same code on the same tensors.

Over a world (``mesh=parallel.mesh.WorldMesh``, one process a rank, the
JAX batch sharding ``("data", "fsdp")``) each rank feeds its own rows
and runs its micro bodies on them, weighting every micro batch's loss
and gradients by its token count. The finish body sums the weighted
gradients, losses and weights over the world before it divides, so the
loss and the gradients are the global batch's token means however the
masks differ between ranks, as the JAX step's are. Under ``data`` every
rank keeps the whole state, the gradients are all-reduced and every rank
runs the whole optimizer. Under ``fsdp`` (the JAX package's ``embed`` ->
``fsdp`` rule, ZeRO-3) a rank keeps, from step to step, only its part of
every parameter, of every gradient accumulator and of the optimizer
state (``parallel.fsdp.FsdpParams``): ``self.params`` is the rank's
``FsdpParams``, which the loss function's model gathers layer by layer
inside the micro body (``models/llama.forward``), each layer's gradients
reduce-scattered into the rank's gradient part as the backward leaves
it. The finish body all-reduces the gradient parts over ``data`` and
runs the optimizer on the parts (``optim.Shards``: every reduction over
a whole leaf is summed over the group). Under ``tensor`` (Megatron's
column and row cuts) the ranks of the axis feed the SAME rows, and each
keeps its slice of every ``heads`` / ``kv_heads`` / ``mlp`` / ``vocab``
leaf (``sharding.axis_part``), which the model joins through the
collectives of ``parallel/tensor.py``; its loss is the whole loss of
those rows, so the sums are reduced over the ranks that hold different
rows (the ``batch`` group, ``data`` x ``fsdp``), the gradients are
never summed over ``tensor``, and the optimizer's whole-leaf reductions
are summed over the axes that cut each leaf. Under ``expert`` (an MoE
model's expert parallelism) the ranks of the axis feed the same rows
too, and each keeps its share of every MoE layer's experts and the whole
rest; the MoE layer dispatches to the rank's experts and joins the
peers' outputs (``parallel/moe.py``), and the router, the attention and
the norms get equal gradients on every expert peer, never summed over
it. Under ``fsdp`` x ``expert`` x ``tensor`` a rank's ``FsdpParams``
holds its expert and tensor slice cut on ``embed``. An MoE layer over a
world takes its router statistics, capacity and slots over the global
micro batch, as the JAX layer does (``parallel.moe.moe_layer``). Under
``context`` (the JAX ``seq`` -> ``context`` rule) the ranks of the axis
feed the same rows, each its chunk ``c`` of n of their tokens: the
trainer stages ``[:, c * Sl : (c + 1) * Sl + 1]`` of every row (Sl = S /
n; one token of overlap, so the loss function shifts its inputs and
targets as it does on one card), and the model's attention joins the
chunks (``parallel/ring_attention.py``, ``attn_impl`` "ring" or
"ulysses"). Context peers hold the same state, so every sum over tokens
(the loss, the weights, the metrics) runs over ``data`` x ``fsdp`` x
``context`` (the ``tokens`` group) and the gradients are all-reduced
over ``data`` x ``context``, while the optimizer's whole-leaf
reductions never sum over it. An MoE layer under ``context`` takes
its statistics, capacity and slots over the ``tokens`` group, in the
JAX layer's row-major order of the global micro batch
(``parallel/moe.py``); its aux penalty, the same on every rank, enters
each rank's loss weighted by the rank's tokens, so the gradient
all-reduce carries it once. Under ``pipeline`` (the JAX
``pipe_stage`` -> ``pipeline`` rule, a tree of
``parallel.pipeline_llama.to_pipeline_params``' stages and a loss
function that runs them as a pipeline, ``pipeline_lm_loss_fn``) the
ranks of the axis feed the same rows, each keeps its stage of the layers
and the whole rest, and the model passes the activations between them
(``parallel/pipeline.py``). Every pipeline rank ends with the same loss,
so the sums never run over the axis; a stage leaf's gradients are its
stage's alone, and the whole-leaf reductions sum them over the axis
once; a leaf outside the stages (the embedding, the final norm, the
head) gets its lookup's gradient on stage 0 and its head's on the last
stage, which the finish body sums over the axis before the gradient
all-reduce, so every pipeline rank updates the same bytes. A
checkpoint holds the layers in the plain ``[L, ...]`` stack
(``parallel.pipeline.from_pipeline_state``), the one-process tree.
``TrainerConfig.rules`` (logical axis -> mesh axes) places the
parameters over a world; on one card there is nothing to place.

The world's micro batches: with ``grad_accum`` = n, micro batch ``m`` of
a step is every batch rank's ``m``-th micro batch (its rows ``[m * b /
n, (m + 1) * b / n)`` of the ``b`` it is fed), in batch order. The JAX
trainer's micro batch ``m`` is the global batch's rows ``[m * B / n,
(m + 1) * B / n)``. For a dense model the step does not depend on how
rows group into micro batches; an MoE layer's capacity and slots do, so
the JAX step equals the world's when its global batch holds, micro batch
by micro batch, the ranks' micro batches in batch order (the same rows
as the ranks' batches concatenated when n = 1).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Mapping, Optional

import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.ops import flash_attention
from kubeflow_tpu_torch.ops.losses import softmax_cross_entropy
from kubeflow_tpu_torch.parallel import sharding
from kubeflow_tpu_torch.parallel.depot import local_capture
from kubeflow_tpu_torch.parallel.fsdp import FsdpParams, gather_to_host
from kubeflow_tpu_torch.parallel.pipeline import (
    from_pipeline_state, stage_count, to_pipeline_state,
)
from kubeflow_tpu_torch.parallel.tensor import TensorParams
from kubeflow_tpu_torch.training import optim
from kubeflow_tpu_torch.training.data import BatchBuffers
from kubeflow_tpu_torch.training.step_graph import StepGraph

logger = logging.getLogger(__name__)

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
    # logical axis -> mesh axes over a world (default
    # parallel.sharding.DEFAULT_RULES); one card has nothing to place
    rules: Mapping[str, object] | None = None
    # the metric holding each micro batch's loss weight (its token count)
    # and the metrics summed, not averaged, over micro batches
    weight_metric: str = "tokens"
    count_metrics: tuple = ("tokens",)


def make_optimizer(cfg: TrainerConfig, shards: Optional[optim.Shards] = None
                   ) -> optim.GradientTransformation:
    """The JAX trainer's optimizer; ``shards``: it updates parts of the
    parameters cut over a group (``optim.Shards``)."""
    schedule = optim.device_warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_steps,
        max(cfg.total_steps, cfg.warmup_steps + 1),
        end_value=cfg.learning_rate * 0.1)
    if cfg.optimizer == "adafactor":
        # no weight decay: optax.adafactor would apply it after the lr
        # scaling, as a raw fraction per step (the JAX trainer's choice)
        return optim.chain(optim.clip_by_global_norm(cfg.grad_clip, shards),
                           optim.adafactor(schedule, shards=shards))
    if cfg.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return optim.chain(
        optim.clip_by_global_norm(cfg.grad_clip, shards),
        optim.adamw(schedule, b1=cfg.b1, b2=cfg.b2,
                    weight_decay=cfg.weight_decay))


def _state_cut_dims(config: TrainerConfig, parts, cuts, opt_state,
                    sizes: dict) -> dict:
    """{optimizer state leaf: {axis: the dim it is cut on over it}}: each
    leaf's shape against the same leaf of the state the optimizer makes
    for the whole parameters, for their slices over the ``pipeline``
    ranks, for those over the ``expert`` ranks too, and for those over
    the ``tensor`` ranks too (``sizes``: the three axes' sizes; on the
    meta device: no memory; all decide what factors on the whole shapes,
    as the rank's optimizer does), which differ on the cut dims alone;
    what differs last is ``fsdp``'s."""
    def meta(axes):
        def leaf(p, c):
            shape = list(c.full_shape)
            for axis, d in (("pipeline", c.pipeline_dim),
                            ("expert", c.expert_dim),
                            ("tensor", c.tensor_dim)):
                if axis in axes and d is not None:
                    shape[d] //= sizes[axis]
            return torch.empty(shape, dtype=p.dtype, device="meta")
        return optim.tree_map(leaf, parts, cuts)

    tx = make_optimizer(config, optim.Shards(cuts, lambda *a: None))
    steps = [optim.named_leaves(tx.init(meta(axes)))
             for axes in ((), ("pipeline",), ("pipeline", "expert"),
                          ("pipeline", "expert", "tensor"))]
    out = {}
    for name, t in optim.named_leaves(opt_state).items():
        dims = {}
        shapes = [s[name].shape for s in steps] + [t.shape]
        for axis, a, b in zip(("pipeline", "expert", "tensor", "fsdp"),
                              shapes, shapes[1:]):
            diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            if diff:
                dims[axis] = diff[0]
        out[name] = dims
    return out


class Trainer:
    """Owns the train state (float32 parameters, their gradient
    accumulators and the optimizer state on one device) and the step.

    ``init_params_fn(generator) -> params`` builds a nested dict of
    tensors; ``loss_fn(params, batch) -> (loss, metrics)`` with the loss a
    0-d tensor and ``metrics[config.weight_metric]`` its weight. The
    device is ``device.resolve_device(device)``: CUDA unless ``"cpu"`` is
    asked for.

    ``mesh``: a ``parallel.mesh.WorldMesh`` of more than one rank trains
    over the world (module docstring); ``param_axes`` is then the
    parameters' logical axes (``llama.param_logical_axes``), placed by
    ``config.rules``. Each rank calls every method the others call, in
    the same order, and feeds ``train_step`` its own rows of the global
    batch (``config.grad_accum`` micro batches of them, grouped over the
    world as the module docstring says; expert and tensor peers the same
    rows: those of their place in the batch axes,
    ``mesh.axis_index("batch")``). Under ``fsdp`` the loss function is
    given the rank's ``parallel.fsdp.FsdpParams`` and gathers the
    weights it uses (``models/llama.forward`` does); otherwise a
    ``parallel.tensor.TensorParams`` of the rank's slices and the world
    (the whole tree under ``data`` alone).

    Every state tensor is written in place, step after step: the
    parameters and their gradient accumulators (``.grad``; under
    ``fsdp`` the rank's parts), the optimizer state (its counts are
    0-d device tensors), the sums over micro batches, the staged batch
    (``data.BatchBuffers``) and the outputs. So the step a CUDA graph
    captured (``precompile``) reads and writes them at every replay.
    """

    def __init__(self, init_params_fn: Callable[[torch.Generator], Any],
                 loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
                 config: TrainerConfig, device: DeviceLike = None,
                 mesh=None, param_axes=None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        # the context axis's size (the JAX mesh shape's, 1 where absent)
        self._context = (1 if self.mesh is None
                         else self.mesh.shape.get("context", 1))
        if self.mesh is not None:
            if self.mesh.device != self.device:
                raise ValueError(f"the mesh's rank computes on "
                                 f"{self.mesh.device}, the trainer on "
                                 f"{self.device}")
            if param_axes is None:
                raise ValueError("a trainer over a world needs param_axes, "
                                 "the parameters' logical axes")
        self.param_axes = param_axes
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
        ``.grad`` (the gradient accumulator); fresh optimizer state.
        Over a world every rank draws the same parameters; their dims
        must divide over the mesh axes they are placed on
        (``sharding.validate_divisibility``, the JAX message). Under
        ``expert`` and ``tensor`` each rank keeps its slices of them;
        under ``fsdp`` its parts of them (of its slices), of their
        gradients and of the optimizer state (``FsdpParams``). The whole
        tree drawn is freed before the optimizer state is made."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = self.init_params_fn(generator)
        self._shards = None
        self._opt_cut_dims: dict = {}
        self._loss_params = None
        # the number of stages of a pipelined tree, else None; whether
        # the world's pipeline axis cuts them
        self._n_stages = stage_count(params)
        self._staged = False
        cuts = None
        if self.mesh is not None:
            shapes = optim.tree_map(lambda p: tuple(p.shape), params)
            sharding.validate_divisibility(self.mesh, self.param_axes,
                                           shapes, self.config.rules)
            self._check_world(params)
            cuts = self._leaf_cuts(shapes)
            self._staged = any(c.pipeline_dim is not None
                               for c in optim.tree_leaves(cuts))
            for axis in ("pipeline", "expert", "tensor"):
                if getattr(self.mesh, axis) > 1:
                    params = sharding.axis_part(
                        params, self.param_axes, axis,
                        self.mesh.axis_index(axis), getattr(self.mesh, axis),
                        self.config.rules)
        if self.mesh is not None and self.mesh.fsdp > 1:
            self.params = FsdpParams(
                optim.tree_map(lambda p: p.detach().to(self.device), params),
                self.param_axes, self.config.rules, self.mesh)
            del params          # the whole tree, before the optimizer state
            self._flat_grad = self.params.grad
            self._whole_grad = self.params.rest_grad
        else:
            self.params = optim.tree_map(
                lambda p: p.detach().to(self.device).requires_grad_(True),
                params)
            del params
            if self.mesh is None:
                for p in optim.tree_leaves(self.params):
                    p.grad = torch.zeros_like(p)
            else:
                self._init_data(cuts)
                self._loss_params = TensorParams(self.params, self.mesh)
        if self.mesh is not None and self.mesh.size // (
                self.mesh.data * self._context) > 1:
            self._init_shards(cuts)
        self.opt_state = self.optimizer.init(self.local_params)
        if self._shards is not None:
            self._opt_cut_dims = _state_cut_dims(
                self.config, self.local_params, self._shards.cuts,
                self.opt_state, {"pipeline": self.mesh.pipeline,
                                 "expert": self.mesh.expert,
                                 "tensor": self.mesh.tensor})
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

    def _check_world(self, params) -> None:
        """What a world needs of the parameters: one dtype, and no dim
        placed on ``data`` when that axis is over 1."""
        dtypes = {p.dtype for p in optim.tree_leaves(params)}
        if len(dtypes) != 1:
            raise ValueError(f"a trainer over a world needs one parameter "
                             f"dtype, got {sorted(map(str, dtypes))}")
        for names in _axes_leaves(self.param_axes):
            if self.mesh.data > 1 and sharding.placed_on(
                    names, "data", self.config.rules):
                raise NotImplementedError(
                    f"logical axes {tuple(names)}: a parameter cut over "
                    "data is not ported")

    def _leaf_cuts(self, shapes):
        """A tree of ``optim.LeafCut``: each parameter's whole shape and
        the dims the world's ``fsdp``, ``tensor``, ``expert`` and
        ``pipeline`` axes (those over 1) cut, by ``config.rules``."""
        rules = self.config.rules

        def cut(shape, names):
            dims = [sharding.axis_dim(names, a, rules)
                    if getattr(self.mesh, a) > 1 else None
                    for a in ("fsdp", "tensor", "expert", "pipeline")]
            placed = [d for d in dims if d is not None]
            if len(set(placed)) < len(placed):
                raise NotImplementedError(
                    f"logical axes {tuple(names)}: one dim is on two of "
                    "fsdp, tensor, expert and pipeline; a dim is cut over "
                    "one axis")
            return optim.LeafCut(tuple(shape), *dims)

        return optim.tree_map(cut, shapes, self.param_axes)

    def _init_data(self, cuts) -> None:
        """Without ``fsdp``: the gradient accumulators as views of one
        flat buffer (one all-reduce a step over ``data``), the leaves no
        ``pipeline`` dim cuts first (``_whole_grad``: their part of it,
        which a pipelined tree sums over the axis)."""
        leaves = optim.tree_leaves(self.params)
        staged = [c.pipeline_dim is not None
                  for c in optim.tree_leaves(cuts)]
        self._flat_grad = torch.zeros((sum(p.numel() for p in leaves),),
                                      dtype=leaves[0].dtype,
                                      device=self.device)
        off = 0
        for p in ([p for p, s in zip(leaves, staged) if not s]
                  + [p for p, s in zip(leaves, staged) if s]):
            p.grad = self._flat_grad[off:off + p.numel()].view(p.shape)
            off += p.numel()
        self._whole_grad = self._flat_grad[:sum(
            p.numel() for p, s in zip(leaves, staged) if not s)]

    def _init_shards(self, cuts) -> None:
        """Under ``fsdp``, ``expert`` or ``tensor``, once ``self.params``
        holds the rank's parts: the optimizer that updates the parts,
        summing its whole-leaf reductions over the axes that cut each
        leaf."""
        self._shards = optim.Shards(cuts, self.mesh.all_reduce)
        self.optimizer = make_optimizer(self.config, self._shards)

    @property
    def local_params(self):
        """The parameters as this rank keeps them: the whole tree, or
        under ``fsdp`` the tree of its parts (views of
        ``FsdpParams.flat``); the tree the optimizer updates."""
        if isinstance(self.params, FsdpParams):
            return self.params.parts
        return self.params

    def _grads(self):
        """The gradient accumulators, a tree like ``local_params``."""
        if isinstance(self.params, FsdpParams):
            return self.params.grads
        return optim.tree_map(lambda p: p.grad, self.params)

    def _stage(self, batch) -> None:
        """Copy ``batch`` into the static batch, made for its key set,
        shapes and dtypes at the first step (and again when they change,
        unless a captured step pins them); under ``context``, the rank's
        chunk of it (``_context_chunk``)."""
        if self._context > 1:
            batch = self._context_chunk(batch)
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

    def _context_chunk(self, batch) -> dict:
        """This rank's tokens of every row of ``batch`` (each value [B,
        S + 1], as ``lm_loss_fn`` takes it): ``[:, c * Sl : (c + 1) * Sl
        + 1]`` with c its ``context`` index and Sl = S / context. Raises
        ValueError when ``context`` does not divide S."""
        n, c = self._context, self.mesh.axis_index("context")
        out = {}
        for k, v in batch.items():
            s = v.shape[1] - 1
            if s % n:
                raise ValueError(
                    f"batch {k!r} of {s} + 1 tokens a row: a sequence of "
                    f"{s} does not split into context={n} chunks")
            sl = s // n
            out[k] = v[:, c * sl:(c + 1) * sl + 1]
        return out

    def _micro_body(self) -> None:
        """Step body (a), one micro batch: micro batch ``_micro`` of the
        staged batch through ``loss_fn`` and backward, accumulating the
        gradients (times the weight ``metrics[weight_metric]`` when
        ``grad_accum`` > 1 or over a world) into ``.grad``, and loss * w,
        w and the metrics into the sums."""
        accum = self.config.grad_accum
        micro = {k: v.view(accum, -1, *v.shape[1:]).index_select(
                     0, self._micro)[0]
                 for k, v in self._batch.tensors.items()}
        loss, metrics = self.loss_fn(
            self.params if self._loss_params is None else self._loss_params,
            micro)
        weighted = accum > 1 or self.mesh is not None
        w = metrics.get(self.config.weight_metric) if weighted else None
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
        varies between micro batches (and, over a world, between ranks:
        the sums are summed over it first); the global norm of the
        averaged gradients (before clipping); the optimizer, applied in
        place; the outputs (the loss function's metrics, count metrics
        summed and the others averaged, plus ``loss`` and ``grad_norm``)
        written into the static outputs; the accumulators zeroed."""
        accum = self.config.grad_accum
        counts = set(self.config.count_metrics)
        with torch.no_grad():
            sums = self._sums
            if self.mesh is None:
                loss_sum, metric_sums = sums["loss"], self._metric_sums
                denom = torch.clamp_min(sums["weight"], 1e-8)
            else:
                loss_sum, denom, metric_sums = self._reduce_sums()
                accum *= self.mesh.axis_size("tokens")
            if self._staged:
                # the lookup's gradient (stage 0) and the head's (the last
                # stage) of the leaves outside the stages
                self.mesh.all_reduce(self._whole_grad, "pipeline")
            if self.mesh is not None:
                self.mesh.all_reduce(self._flat_grad, "data_context")
            params = self.local_params
            grads = optim.tree_map(lambda g: g.div_(denom), self._grads())
            gnorm = optim.global_norm(grads, self._shards)
            updates, _ = self.optimizer.update(grads, self.opt_state,
                                               params)
            optim.apply_updates(params, updates)
            out = {k: v if k in counts else v / accum
                   for k, v in metric_sums.items()}
            out.update(loss=loss_sum / denom, grad_norm=gnorm)
            for k, v in out.items():
                if k not in self._outputs:
                    self._outputs[k] = torch.zeros_like(v)
                self._outputs[k].copy_(v)
            for g in optim.tree_leaves(grads):
                g.zero_()
            for v in (*sums.values(), *self._metric_sums.values()):
                v.zero_()
            self._micro.zero_()

    def _reduce_sums(self):
        """The step's sums over the ranks that hold different tokens (the
        ``tokens`` group: tensor and expert peers hold the same rows and
        the same sums, context peers other chunks of the same rows), in
        one all-reduce: (loss sum, max(sum w, 1e-8), the metric sums)."""
        sums = self._sums
        keys = list(self._metric_sums)
        vec = torch.stack([sums["loss"], sums["weight"],
                           *(self._metric_sums[k].float() for k in keys)])
        self.mesh.all_reduce(vec, "tokens")
        metric_sums = {k: vec[2 + i].to(self._metric_sums[k].dtype)
                       for i, k in enumerate(keys)}
        return vec[0], torch.clamp_min(vec[1], 1e-8), metric_sums

    def _state_tensors(self) -> dict:
        """Every tensor the step bodies keep across steps, by name: over a
        world the flat gradient buffer (whose views the accumulators
        are) and under ``fsdp`` the flat parameter part buffer, in place
        of their views."""
        if isinstance(self.params, FsdpParams):
            out = {"param/flat": self.params.flat.detach()}
        else:
            out = {f"param/{k}": p
                   for k, p in optim.named_leaves(self.params).items()}
        if self.mesh is None:
            out.update({f"grad/{k}": g
                        for k, g in optim.named_leaves(self._grads()).items()})
        else:
            out["grad/flat"] = self._flat_grad
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

    def state_bytes(self) -> dict:
        """Bytes of every tensor this rank keeps from step to step
        (``_state_tensors``, each storage counted once), by kind:
        ``params``, ``grads`` and ``opt_state`` (whole on one card and
        under ``data``; under ``fsdp=n`` the rank's parts, 1/n of the
        parameters and gradients, and of every optimizer leaf that has
        the cut dim; under ``tensor=n`` its slices, the same share of
        every leaf but the norms; under ``expert=n`` 1/n of every expert
        leaf and the whole rest) and ``other`` (the
        staged batch with its host buffers where they lie on the trainer's
        device, the sums and the outputs); ``total``, their sum."""
        kinds = {"param": "params", "grad": "grads", "opt": "opt_state"}
        out = dict.fromkeys(("params", "grads", "opt_state", "other"), 0)
        tensors = list(self._state_tensors().items())
        if self._batch is not None:
            tensors += [("staging", t) for t in self._batch.buffers()
                        if t.device == self.device]
        seen = set()
        for name, t in tensors:
            storage = t.untyped_storage()
            if storage.data_ptr() in seen:
                continue
            seen.add(storage.data_ptr())
            out[kinds.get(name.split("/")[0], "other")] += storage.nbytes()
        out["total"] = sum(out.values())
        return out

    # ------------------------------------------------------- checkpoints

    def checkpoint_state(self) -> dict:
        """The whole train state ``{"params", "opt_state"}`` as one
        process holds it, which ``training.checkpoint`` saves. Under
        ``fsdp``, ``expert`` or ``tensor`` every rank calls this: each
        leaf's parts
        are gathered into host memory, one leaf (and for a stacked leaf,
        one piece of layers) at a time, so the device never holds the
        whole state (``parallel.fsdp.gather_to_host``). A pipelined tree's
        stages come back as the plain ``"layers"`` stack
        (``parallel.pipeline.from_pipeline_state``)."""
        if self._shards is None:
            state = {"params": self.params, "opt_state": self.opt_state}
        else:
            dims = self._cut_dims()
            live = self._live()
            it = iter(gather_to_host(t, dims.get(k), self.mesh)
                      for k, t in live.items())
            state = _rebuild({"params": self.local_params,
                              "opt_state": self.opt_state}, it)
        return state if self._n_stages is None else from_pipeline_state(state)

    def _live(self) -> dict:
        """The state ``checkpoint_state`` saves as this rank holds it,
        by ``optim.named_leaves`` name."""
        return optim.named_leaves({"params": self.local_params,
                                   "opt_state": self.opt_state})

    def _cut_dims(self) -> dict:
        """{``_live`` name: {axis: the dim its leaf is cut on over it}}
        (empty: held whole)."""
        dims = {f"opt_state/{k}": d for k, d in self._opt_cut_dims.items()}
        if self._shards is not None:
            dims.update({f"params/{k}": {a: d for a, d in (
                ("pipeline", c.pipeline_dim), ("fsdp", c.dim),
                ("expert", c.expert_dim), ("tensor", c.tensor_dim))
                if d is not None}
                for k, c in optim.named_leaves(self._shards.cuts).items()})
        return dims

    def load_state(self, state: dict, step: int) -> None:
        """COPY ``state`` (a whole train state, as ``checkpoint_state``
        gives it, on any device) into this trainer's tensors, each rank
        its own part, and set the step. Every leaf is checked before any
        is copied. The tensors keep their addresses: a captured step
        trains the loaded state at its next replay. A pipelined trainer
        takes the plain ``"layers"`` stack, re-stacked into its stages."""
        if self._n_stages is not None:
            state = to_pipeline_state(state, self._n_stages)
        saved = optim.named_leaves(state)
        live = self._live()
        if saved.keys() != live.keys():
            raise ValueError(
                f"checkpoint step {step} holds leaves "
                f"{sorted(saved.keys() ^ live.keys())} the trainer does "
                "not, or the other way round")
        dims = self._cut_dims()
        for name, dst in live.items():
            cut = dims.get(name) or {}
            shape = list(saved[name].shape)
            for axis, d in cut.items():
                shape[d] //= self.mesh.axis_size(axis)
            if tuple(shape) != tuple(dst.shape) \
                    or saved[name].dtype != dst.dtype:
                raise ValueError(
                    f"checkpoint step {step}: {name} is "
                    f"{tuple(saved[name].shape)} {saved[name].dtype}, the "
                    f"trainer's {tuple(dst.shape)} {dst.dtype}"
                    + (f" (a part over {sorted(cut)})" if cut else ""))
        with torch.no_grad():
            for name, dst in live.items():
                src = saved[name]
                for axis, d in (dims.get(name) or {}).items():
                    src = sharding.axis_shard(
                        src, d, self.mesh.axis_index(axis),
                        self.mesh.axis_size(axis), axis)
                dst.copy_(src)
        self.step = step

    # ------------------------------------------------------------- steps

    def train_step(self, batch) -> dict:
        """One optimizer step on ``batch`` (a dict of host arrays or
        tensors, staged on the trainer's device; over a world, this
        rank's rows). Returns the metrics as 0-d tensors: the loss
        function's, plus ``loss`` and ``grad_norm`` (the global norm of
        the averaged gradients, before clipping), those of the global
        batch over a world. After ``precompile`` the step replays the
        captured graphs, and a batch of another key set, shape or dtype
        raises ValueError."""
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

        Over a world a body is captured with its collectives when they
        run over NCCL. gloo's cannot be captured: the finish body then
        runs eagerly after the replays (``step_graph.finish_mode``), and
        under ``fsdp``, whose micro body gathers and reduce-scatters each
        layer, under ``tensor``, whose micro body all-reduces the
        products of every block, under ``context``, whose attention
        passes K/V round the ring (or swaps the sequence cut for a head
        cut) in every block, under ``pipeline``, whose pipeline passes
        the activations between the stages at every tick, and for an MoE
        model under ``expert`` or over several ``tokens`` ranks, whose
        MoE layers gather their routing counts and all-reduce their
        statistics and outputs, so does the micro body
        (``step_graph.micro_mode``; with neither captured, the step runs
        as it runs without ``precompile``). The log says what was
        captured, and why a body was not.

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
        nccl = self.mesh is None or self.mesh.backend.name == "nccl"
        moe = _moe(self.param_axes or {})
        micro_collectives = self.mesh is not None and (
            self.mesh.fsdp > 1 or self.mesh.tensor > 1
            or self.mesh.expert > 1 or self._context > 1
            or self._staged
            or (moe and self.mesh.axis_size("tokens") > 1))
        self.step_graph = StepGraph(
            self._micro_body, self._finish_body, self._state_tensors,
            self.config.grad_accum, _COUNTERS, self.device,
            capture_micro=nccl or not micro_collectives,
            capture_finish=nccl)
        graph = self.step_graph
        logger.info("precompile: micro body %s, finish body %s%s",
                    graph.micro_mode, graph.finish_mode,
                    "" if self.mesh is None else
                    f" ({self.mesh.backend.name}, "
                    f"pipeline={self.mesh.pipeline}, data={self.mesh.data}, "
                    f"fsdp={self.mesh.fsdp}, expert={self.mesh.expert}, "
                    f"context={self._context}, "
                    f"tensor={self.mesh.tensor}"
                    + ("" if nccl else
                       "; a gloo collective runs on the host, which no "
                       "CUDA graph can hold, so the bodies holding one "
                       "run eagerly") + ")")
        self.depot_outcome = local_capture(depot, stats)
        return self.depot_outcome

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(AOT_SLICE)


def _moe(param_axes) -> bool:
    """Whether parameters of these logical axes hold MoE experts."""
    return any("expert" in names for names in _axes_leaves(param_axes))


def _axes_leaves(axes) -> list:
    """The logical-axis tuples of a tree of them (nested dicts)."""
    if isinstance(axes, dict):
        return [x for v in axes.values() for x in _axes_leaves(v)]
    return [axes]


def _rebuild(tree, leaves):
    """``tree``'s structure (dicts, tuples, lists) with its leaves taken
    from the iterator ``leaves`` in ``optim.named_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def lm_loss_fn(forward, cfg):
    """Next-token LM loss for a model ``forward(params, tokens, cfg)``.
    MoE configs (``n_experts > 0``) call ``forward(..., return_aux=True)``,
    add the summed MoE penalties to the loss and report them as the
    ``moe_aux`` metric.

    Batch: {"tokens": [B, S+1] integer, "mask": optional [B, S+1]}.

    The ``tokens`` metric, the micro batch's weight, is the mask's sum
    clamped at 1 (``softmax_cross_entropy``'s total weight, as the JAX
    loss reports it) on one card; over a world (``params`` a rank's
    ``parallel.tensor.TensorParams`` or ``parallel.fsdp.FsdpParams``)
    the rank's sum unclamped: the JAX step clamps the GLOBAL micro
    batch's count, which no rank sees, and a rank's rows (under
    ``context`` its chunk of them) may hold no token of the mask.
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
        world = getattr(params, "world", getattr(params, "mesh", None))
        metrics = {"tokens": aux["total_weight"] if world is None
                   or mask is None else mask.float().sum()}
        if moe:
            loss = loss + fwd_aux["moe_aux"]
            metrics["moe_aux"] = fwd_aux["moe_aux"].detach()
        return loss, metrics

    return loss_fn

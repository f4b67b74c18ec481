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
masks differ between ranks, as the JAX step's are. Under ``data`` the
gradients are all-reduced and every rank runs the whole optimizer.
Under ``fsdp`` (the JAX package's ``embed`` -> ``fsdp`` rule) the
gradients are reduce-scattered into each rank's part, the optimizer
updates the part and keeps only its part of the optimizer state
(``optim.Shards``: every reduction over a whole leaf is summed over the
group), and the parts are all-gathered back into the whole parameters.
The whole parameters and their gradient accumulators stay on every rank
from step to step, as under ``data``: the micro bodies, captured as
CUDA graphs, read and write them at fixed addresses. So ``fsdp`` keeps
1/fsdp of the optimizer state a rank (ZeRO-2's memory, not ZeRO-3's);
the cut parameters and gradients are buffers of the finish body alone.
``TrainerConfig.rules`` (logical axis -> mesh axes) places the
parameters over a world; on one card there is nothing to place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional

import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.ops import flash_attention
from kubeflow_tpu_torch.ops.losses import softmax_cross_entropy
from kubeflow_tpu_torch.parallel import sharding
from kubeflow_tpu_torch.parallel.depot import local_capture
from kubeflow_tpu_torch.parallel.moe import MOE_WORLD
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


class _FsdpParts:
    """The ``fsdp`` cut of the parameters (module docstring): where each
    rank's part of every leaf lies in the finish body's flat buffers.

    Every parameter is cut on its ``fsdp`` dim ``s`` into ``n`` parts;
    with ``pre`` and ``post`` the products of the dims before and after
    ``s`` and ``k`` the part's length on it, a rank's part of a leaf is
    ``[pre, k, post]``. A part buffer (``numel`` elements) holds a rank's
    parts of every leaf back to back, in leaf order; a gathered buffer
    (``n * numel``) holds every rank's part buffer in rank order, which
    is the layout a reduce-scatter reads and an all-gather writes.
    ``pack`` writes whole tensors into a gathered buffer and ``unpack``
    reads them out of one: one strided copy a leaf."""

    def __init__(self, params, cuts, n: int, index: int):
        self.n, self.index = n, index
        self.leaves = []
        off = 0
        for p, cut in zip(optim.tree_leaves(params),
                          optim.tree_leaves(cuts)):
            s, shape = cut.dim, tuple(p.shape)
            k = shape[s] // n
            pre, post = math.prod(shape[:s]), math.prod(shape[s + 1:])
            self.leaves.append((off, pre, k, post,
                                shape[:s] + (k,) + shape[s + 1:]))
            off += pre * k * post
        self.numel = off

    def views(self, flat, like):
        """A tree like ``like`` of the parts in the part buffer ``flat``."""
        it = iter([flat[o:o + pre * k * post].view(shape)
                   for o, pre, k, post, shape in self.leaves])
        return optim.tree_map(lambda _: next(it), like)

    def take(self, flat, whole: list) -> None:
        """``flat`` <- this rank's part of the whole tensors ``whole``."""
        for (o, pre, k, post, _), t in zip(self.leaves, whole):
            flat[o:o + pre * k * post].view(pre, k, post).copy_(
                t.view(pre, self.n, k, post)[:, self.index])

    def _rows(self, gathered, leaf):
        o, pre, k, post, _ = leaf
        return gathered.view(self.n, self.numel)[
            :, o:o + pre * k * post].view(self.n, pre, k, post)

    def pack(self, gathered, whole: list) -> None:
        """``gathered`` <- the whole tensors ``whole`` (leaf order), cut."""
        for leaf, t in zip(self.leaves, whole):
            _, pre, k, post, _ = leaf
            self._rows(gathered, leaf).copy_(
                t.view(pre, self.n, k, post).transpose(0, 1))

    def unpack(self, gathered, whole: list) -> None:
        """The whole tensors ``whole`` (leaf order) <- ``gathered``."""
        for leaf, t in zip(self.leaves, whole):
            _, pre, k, post, _ = leaf
            t.view(pre, self.n, k, post).copy_(
                self._rows(gathered, leaf).transpose(0, 1))


def _state_cut_dims(config: TrainerConfig, parts, cuts, opt_state) -> dict:
    """{optimizer state leaf: the dim it is cut on over fsdp, or None}:
    each leaf's shape against the same leaf of the state the unsharded
    optimizer makes for the whole parameters (on the meta device: no
    memory), which differs on the cut dim alone."""
    whole = optim.tree_map(
        lambda p, c: torch.empty(c.full_shape, dtype=p.dtype, device="meta"),
        parts, cuts)
    full = optim.named_leaves(make_optimizer(config).init(whole))
    out = {}
    for name, t in optim.named_leaves(opt_state).items():
        diff = [i for i, (a, b) in enumerate(zip(full[name].shape, t.shape))
                if a != b]
        out[name] = diff[0] if diff else None
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
    batch (``config.grad_accum`` micro batches of them). MoE parameters
    (an ``expert`` axis) raise ``parallel.moe.MOE_WORLD``.

    Every state tensor is written in place, step after step: the
    parameters and their ``.grad``, the optimizer state (its counts are
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
        if self.mesh is not None:
            if self.mesh.device != self.device:
                raise ValueError(f"the mesh's rank computes on "
                                 f"{self.mesh.device}, the trainer on "
                                 f"{self.device}")
            if param_axes is None:
                raise ValueError("a trainer over a world needs param_axes, "
                                 "the parameters' logical axes")
            if any("expert" in names for names in _axes_leaves(param_axes)):
                raise NotImplementedError(MOE_WORLD)
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
        self._fsdp: Optional[_FsdpParts] = None

    def init_state(self, generator: Optional[torch.Generator] = None):
        """Parameters from ``init_params_fn(generator)`` (a generator on
        the trainer's device seeded 0 when none is given), placed on the
        device as float32 leaves that record gradients, each with a zero
        ``.grad`` (the gradient accumulator); fresh optimizer state.
        Over a world every rank draws the same parameters; their dims
        must divide over the mesh axes they are placed on
        (``sharding.validate_divisibility``, the JAX message), and under
        ``fsdp`` each rank keeps its part of the optimizer state."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = self.init_params_fn(generator)
        if self.mesh is not None:
            sharding.validate_divisibility(
                self.mesh, self.param_axes,
                optim.tree_map(lambda p: tuple(p.shape), params),
                self.config.rules)
        self.params = optim.tree_map(
            lambda p: p.detach().to(self.device).requires_grad_(True),
            params)
        self._fsdp = self._shards = None
        if self.mesh is None:
            for p in optim.tree_leaves(self.params):
                p.grad = torch.zeros_like(p)
        else:
            self._init_world()
        self._opt_cut_dims: dict = {}
        if self._fsdp is None:
            self.opt_state = self.optimizer.init(self.params)
        else:
            # the optimizer's state is made for this rank's parts
            dtype = optim.tree_leaves(self.params)[0].dtype
            parts = self._fsdp.views(
                torch.zeros((self._fsdp.numel,), dtype=dtype,
                            device=self.device), self.params)
            self.opt_state = self.optimizer.init(parts)
            self._opt_cut_dims = _state_cut_dims(
                self.config, parts, self._shards.cuts, self.opt_state)
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

    def _init_world(self) -> None:
        """The gradient accumulators as views of one flat buffer (one
        collective a step), and under ``fsdp`` the cut of the parameters
        and the optimizer that updates a rank's parts."""
        leaves = optim.tree_leaves(self.params)
        dtypes = {p.dtype for p in leaves}
        if len(dtypes) != 1:
            raise ValueError(f"a trainer over a world needs one parameter "
                             f"dtype, got {sorted(map(str, dtypes))}")
        self._flat_grad = torch.zeros((sum(p.numel() for p in leaves),),
                                      dtype=leaves[0].dtype,
                                      device=self.device)
        off = 0
        for p in leaves:
            p.grad = self._flat_grad[off:off + p.numel()].view(p.shape)
            off += p.numel()
        rules = self.config.rules

        def check(p, names):
            if self.mesh.data > 1 and sharding.placed_on(names, "data",
                                                         rules):
                raise NotImplementedError(
                    f"logical axes {tuple(names)}: a parameter cut over "
                    "data is not ported")
            return sharding.fsdp_dim(names, rules)

        dims = optim.tree_map(check, self.params, self.param_axes)
        if self.mesh.fsdp == 1:
            return
        whole = [n for n, d in optim.named_leaves(dims).items() if d is None]
        if whole:
            raise ValueError(f"under fsdp every parameter is cut on its "
                             f"fsdp dim; {whole} have none")
        cuts = optim.tree_map(lambda p, d: optim.LeafCut(tuple(p.shape), d),
                              self.params, dims)
        self._fsdp = _FsdpParts(self.params, cuts, self.mesh.fsdp,
                                self.mesh.fsdp_index)
        self._shards = optim.Shards(
            cuts, lambda t: self.mesh.all_reduce(t, "fsdp"))
        self.optimizer = make_optimizer(self.config, self._shards)

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
        ``grad_accum`` > 1 or over a world) into ``.grad``, and loss * w,
        w and the metrics into the sums."""
        accum = self.config.grad_accum
        micro = {k: v.view(accum, -1, *v.shape[1:]).index_select(
                     0, self._micro)[0]
                 for k, v in self._batch.tensors.items()}
        loss, metrics = self.loss_fn(self.params, micro)
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
                accum *= self.mesh.size
            if self._fsdp is not None:
                gnorm = self._fsdp_update(denom)
            else:
                if self.mesh is not None:
                    self.mesh.all_reduce(self._flat_grad, "data")
                grads = optim.tree_map(lambda p: p.grad.div_(denom),
                                       self.params)
                gnorm = optim.global_norm(grads)
                updates, _ = self.optimizer.update(grads, self.opt_state,
                                                   self.params)
                optim.apply_updates(self.params, updates)
            out = {k: v if k in counts else v / accum
                   for k, v in metric_sums.items()}
            out.update(loss=loss_sum / denom, grad_norm=gnorm)
            for k, v in out.items():
                if k not in self._outputs:
                    self._outputs[k] = torch.zeros_like(v)
                self._outputs[k].copy_(v)
            for p in optim.tree_leaves(self.params):
                p.grad.zero_()
            for v in (*sums.values(), *self._metric_sums.values()):
                v.zero_()
            self._micro.zero_()

    def _reduce_sums(self):
        """The step's sums over the world, in one all-reduce: (loss sum,
        max(sum w, 1e-8), the metric sums)."""
        sums = self._sums
        keys = list(self._metric_sums)
        vec = torch.stack([sums["loss"], sums["weight"],
                           *(self._metric_sums[k].float() for k in keys)])
        self.mesh.all_reduce(vec, "world")
        metric_sums = {k: vec[2 + i].to(self._metric_sums[k].dtype)
                       for i, k in enumerate(keys)}
        return vec[0], torch.clamp_min(vec[1], 1e-8), metric_sums

    def _fsdp_update(self, denom: torch.Tensor) -> torch.Tensor:
        """The optimizer under ``fsdp``: the whole gradients packed and
        reduce-scattered into this rank's part, summed over ``data`` and
        divided by ``denom``; their global norm (returned); this rank's
        part of the parameters updated; the parts all-gathered back into
        the whole parameters. The three flat buffers live in this call
        alone (in the graph's pool when it is captured)."""
        fs, mesh = self._fsdp, self.mesh
        leaves = optim.tree_leaves(self.params)
        gathered = torch.empty((fs.n * fs.numel,), dtype=leaves[0].dtype,
                               device=self.device)
        fs.pack(gathered, [p.grad for p in leaves])
        grad_flat = torch.empty((fs.numel,), dtype=leaves[0].dtype,
                                device=self.device)
        mesh.reduce_scatter(grad_flat, gathered, "fsdp")
        mesh.all_reduce(grad_flat, "data")
        grads = fs.views(grad_flat.div_(denom), self.params)
        gnorm = optim.global_norm(grads, self._shards)
        flat = torch.empty_like(grad_flat)
        fs.take(flat, leaves)
        parts = fs.views(flat, self.params)
        updates, _ = self.optimizer.update(grads, self.opt_state, parts)
        optim.apply_updates(parts, updates)
        mesh.all_gather(gathered, flat, "fsdp")
        fs.unpack(gathered, leaves)
        return gnorm

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
        if self.mesh is not None:
            out["flat_grad"] = self._flat_grad
        if self._batch is not None:
            out.update({f"batch/{k}": t
                        for k, t in self._batch.tensors.items()})
        return out

    def state_bytes(self) -> dict:
        """Bytes of every tensor this rank keeps from step to step
        (``_state_tensors``, each storage counted once), by kind:
        ``params`` and ``grads`` (the whole parameters and their
        accumulators, on every rank under ``data`` and ``fsdp`` alike),
        ``opt_state`` (a rank's part under ``fsdp``) and ``other`` (the
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
        process holds it, which ``training.checkpoint`` saves: over a
        world under ``fsdp`` the optimizer state's parts are gathered
        (every rank calls this; the whole parameters are on each
        rank)."""
        if self._fsdp is None:
            return {"params": self.params, "opt_state": self.opt_state}
        named = optim.named_leaves(self.opt_state)
        whole = {}
        for name, t in named.items():
            dim = self._opt_cut_dims[name]
            if dim is None:
                whole[name] = t
                continue
            n = self.mesh.fsdp
            parts = torch.empty((n * t.numel(),), dtype=t.dtype,
                                device=t.device)
            self.mesh.all_gather(parts, t.contiguous().view(-1), "fsdp")
            whole[name] = sharding.fsdp_unshard(
                parts.view(n, *t.shape).unbind(0), dim)
        it = iter(whole[name] for name in named)
        return {"params": self.params,
                "opt_state": _rebuild(self.opt_state, it)}

    def load_state(self, state: dict, step: int) -> None:
        """COPY ``state`` (a whole train state, as ``checkpoint_state``
        gives it, on any device) into this trainer's tensors, each rank
        its own part, and set the step. The tensors keep their addresses:
        a captured step trains the loaded state at its next replay."""
        saved = optim.named_leaves(state)
        live = optim.named_leaves({"params": self.params,
                                   "opt_state": self.opt_state})
        if saved.keys() != live.keys():
            raise ValueError(
                f"checkpoint step {step} holds leaves "
                f"{sorted(saved.keys() ^ live.keys())} the trainer does "
                "not, or the other way round")
        parts = {}
        for name, dst in live.items():
            src = saved[name]
            dim = self._opt_cut_dims.get(name[len("opt_state/"):]) \
                if name.startswith("opt_state/") else None
            if dim is not None:
                src = sharding.fsdp_shard(src, dim, self.mesh.fsdp_index,
                                          self.mesh.fsdp)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"checkpoint step {step}: {name} is "
                    f"{tuple(src.shape)} {src.dtype}, the trainer's "
                    f"{tuple(dst.shape)} {dst.dtype}")
            parts[name] = src
        with torch.no_grad():
            for name, dst in live.items():
                dst.copy_(parts[name])
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

        Over a world the micro body is captured on every rank, and the
        finish body with its collectives when they run over NCCL; gloo's
        cannot be captured, and the finish body then runs eagerly after
        the replays (``step_graph.finish_mode``).

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
            self.config.grad_accum, _COUNTERS, self.device,
            capture_finish=(self.mesh is None
                            or self.mesh.backend.name == "nccl"))
        self.depot_outcome = local_capture(depot, stats)
        return self.depot_outcome

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(AOT_SLICE)


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

"""Train a seeded llama over a world of spawned processes
(``parallel.mesh.WorldMesh``), rank by rank, and bring back what each
rank saw: the per-step metrics of the global batch, the step's wall
time, its host-staged collectives and its ``tensor`` collectives
(``WorldMesh.timings``), under ``fsdp`` its per-layer gathers and
reduce-scatters, memory, the state each rank keeps
(``Trainer.state_bytes``, checked against the bytes of the tensors the
trainer reaches, ``reachable_tensors``) and, where
asked, the whole parameters.

    from kubeflow_tpu_torch.tools import world_train
    results = world_train.run(world_train.Job(cfg, {...}, local_batch=2,
                              seq=16, steps=3), data=2, fsdp=1,
                              devices=["cpu"] * 2, rundir=tmp)
    # data=1, fsdp=2, tensor=2: four ranks, tensor peers r and r + 1
    world_train.run(..., 1, 2, ["cpu"] * 4, tmp, tensor=2)
    # data=2, expert=2 (an MoE config): expert peers r and r + 1
    world_train.run(..., 2, 1, ["cpu"] * 4, tmp, expert=2)
    # data=2, context=2 (attn_impl "ring" or "ulysses"): context peers
    # r and r + 1, each training its chunk of the same rows' tokens
    world_train.run(..., 2, 1, ["cpu"] * 4, tmp, context=2)
    # pipeline=2, data=2: stage 0 on ranks 0 and 1, stage 1 on 2 and 3,
    # pipeline peers r and r + 2 training their stages on the same rows
    world_train.run(..., 2, 1, ["cpu"] * 4, tmp, pipeline=2)

``run`` spawns one process a rank (the ``spawn`` start method), each
joining a gloo default group through a file in ``rundir``
(``rendezvous.bootstrap.join_world``, which chooses the backend of the
model's collectives from where the ranks run), and calls one of the rank
bodies below with the job. A rank's result is written to
``rundir/rank{r}.pt`` and returned in rank order; a rank that raises
makes ``run`` raise.

Each rank feeds the rows of its place in the batch axes
(``mesh.axis_index("batch")``, ``data`` x ``fsdp``; pipeline, expert,
context and tensor peers share it, and under ``context`` the trainer
stages the rank's chunk of each row): ``batch_for(job, step, index)``, the
synthetic token stream's draw (``training.data.synthetic_lm_batches``,
seeded by ``[data_seed, step, index]``) and, with ``mask``, a loss mask drawn
after it whose density varies by row and by index, so the token counts
differ between the places. ``global_batch(job, n, step)`` is the concatenation of the rows
of the ``n`` places, the batch a one-process trainer (or the JAX
trainer) takes for the same step; with ``grad_accum``, micro batch by
micro batch (the world's grouping, ``training/trainer.py``).

The rank bodies: ``train_rank`` (``Job.runs`` one after another, each
with a fresh trainer from the same parameters: "eager" steps, or
"replayed" steps after ``precompile``; with both, the replayed run's
losses, grad norms and parameters must be bitwise the eager run's on
every rank), ``fit_rank`` (``fit`` with checkpoints: uninterrupted, and
stopped at ``resume_at`` then resumed by a fresh trainer),
``restore_rank`` (a checkpoint restored into this world's layout),
``optimizer_rank`` (the optimizer on fsdp (and tensor) parts against
the unsharded update of the whole tree), ``moe_layer_rank`` (one MoE
layer of whole inputs over the world: the rank's rows, its chunk of
their tokens, its experts and slices, forward and backward),
``attention_layer_rank`` (one attention layer of whole inputs over the
``context`` axis, forward and backward),
``pipeline_rank`` (``pipeline_apply`` over the ``pipeline`` axis on
seeded MLP stages, forward and backward, and its aux masking),
``pipeline_forward_rank`` (the pipelined llama's logits of the rank's
rows) and ``plans_rank`` (several of them, each
on its own layout of the same processes).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.parallel import ring_attention as ra
from kubeflow_tpu_torch.parallel.mesh import WorldMesh
from kubeflow_tpu_torch.training import optim


@dataclasses.dataclass(frozen=True)
class Job:
    """What every rank of a world trains. ``config`` is the model;
    ``trainer`` the ``TrainerConfig`` fields; ``params`` a nested dict of
    numpy arrays to start from (default: ``llama.init_params`` from a
    generator on the rank's device seeded ``param_seed``); ``runs`` the
    runs of ``train_rank``, in order; ``profile``: on a card, each run's
    last step is traced (``torch.profiler``) for its device time;
    ``merge_places``: place ``i`` of the batch axes feeds the rows of
    places ``i * k .. i * k + k - 1`` of the stream, concatenated (``k``
    the field), so a world with ``k`` times fewer places trains on the
    same global batch; with ``interleave``, micro batch by micro batch
    (``global_batch``'s grouping), so it trains on the same global micro
    batches too (an MoE layer's capacity and slots depend on them);
    ``microbatches``: over a world with a ``pipeline`` axis, the
    pipeline's micro batches of each trainer micro batch
    (``make_trainer``); ``watch``: parameters (``optim.named_leaves``
    names) whose bytes, as the rank keeps them, each step's result
    keeps; ``router_scale``: for an MoE config, factors (one an expert)
    each layer's router columns are multiplied by after the draw, so
    that the wider columns win more tokens, as a trained router's
    imbalance does, and the capacity binds."""
    config: llama.LlamaConfig
    trainer: dict
    local_batch: int
    seq: int
    steps: int
    mask: bool = False
    data_seed: int = 0
    param_seed: int = 0
    params: Optional[dict] = None
    runs: tuple = ("eager",)
    keep_params: bool = False
    profile: bool = False
    # each place in the batch axes feeds the rows of this many places of
    # the stream (``rows_for``), one after another or micro batch by
    # micro batch
    merge_places: int = 1
    interleave: bool = False
    microbatches: int = 1
    watch: tuple = ()
    router_scale: tuple = ()


def batch_for(job: Job, step: int, rank: int) -> dict:
    """The rows of step ``step`` at place ``rank`` of the batch axes
    (module docstring)."""
    rng = np.random.default_rng([job.data_seed, step, rank])
    out = {"tokens": rng.integers(0, job.config.vocab_size,
                                  (job.local_batch, job.seq + 1),
                                  dtype=np.int32)}
    if job.mask:
        low = 0.2 + 0.5 * (rank % 2)
        density = np.linspace(low, 1.0, job.local_batch)[:, None]
        out["mask"] = (rng.random((job.local_batch, job.seq + 1))
                       < density).astype(np.int32)
    return out


def _merged(parts: list, grad_accum: int) -> dict:
    """The rows of ``parts`` (dicts of arrays), each part's micro batch
    ``m`` (of ``grad_accum``) in micro batch ``m`` of the result."""
    return {k: np.concatenate([np.split(p[k], grad_accum)[m]
                               for m in range(grad_accum) for p in parts])
            for k in parts[0]}


def rows_for(job: Job, step: int, index: int) -> dict:
    """The rows place ``index`` of the batch axes feeds at step ``step``
    (``Job.merge_places`` draws of ``batch_for``, merged)."""
    k = job.merge_places
    if k == 1:
        return batch_for(job, step, index)
    parts = [batch_for(job, step, index * k + j) for j in range(k)]
    return _merged(parts, job.trainer.get("grad_accum", 1)
                   if job.interleave else 1)


def global_batch(job: Job, world: int, step: int,
                 grad_accum: int = 1) -> dict:
    """The rows of step ``step`` of the ``world`` places of the batch
    axes in their order: each place's micro batch ``m`` (of
    ``grad_accum``) in micro batch ``m`` of the result, so a trainer that
    cuts it into ``grad_accum`` micro batches trains the world's."""
    return _merged([batch_for(job, step, r) for r in range(world)],
                   grad_accum)


def make_trainer(job: Job, device: torch.device, mesh=None):
    """The job's llama trainer on ``device`` (over ``mesh`` when given),
    its state initialised. Over a world with a ``pipeline`` axis the
    tree is re-stacked into its stages and the loss runs them as a
    pipeline of ``job.microbatches`` micro batches
    (``parallel/pipeline_llama.py``)."""
    from kubeflow_tpu_torch import interop
    from kubeflow_tpu_torch.parallel import pipeline_llama as pl
    from kubeflow_tpu_torch.training import Trainer, TrainerConfig, lm_loss_fn

    cfg = job.config
    if job.params is not None:
        init = lambda g: interop.params_from_jax(job.params, device=device)
    else:
        init = lambda g: llama.init_params(g, cfg, device=device)
    if job.router_scale:
        drawn = init

        def init(g):
            params = drawn(g)
            router = params["layers"]["moe_router"]
            router.mul_(torch.tensor(job.router_scale, dtype=router.dtype,
                                     device=router.device))
            return params
    if mesh is not None and mesh.pipeline > 1:
        init, loss, axes = pl.pipeline_training(
            cfg, mesh, init, microbatches=job.microbatches)
    else:
        loss = lm_loss_fn(llama.forward, cfg)
        axes = llama.param_logical_axes(cfg)
    trainer = Trainer(init, loss, TrainerConfig(**job.trainer),
                      device=device, mesh=mesh, param_axes=axes)
    trainer.init_state(torch.Generator(device=device)
                       .manual_seed(job.param_seed))
    return trainer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_tree(tree) -> dict:
    return optim.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _steps(job: Job, trainer, rank: int, mesh) -> dict:
    """``job.steps`` steps on the rows of place ``rank`` of the batch
    axes: per step the metrics, the ``job.watch`` parameters' bytes, the
    wall seconds (ending in a synchronize), the host-staged and
    ``tensor`` collectives' timings (``WorldMesh.timings``, this step's
    share) and, under
    ``fsdp``, the per-layer gathers' and reduce-scatters' counts, bytes
    and seconds (``FsdpParams.timings``, this step's share: none while a
    captured micro body replays); with ``job.profile`` on a card, the
    last step's device readings (``_device_readings``)."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel.fsdp import FsdpParams

    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv)
    for k in kernels:
        k.launches = 0
    out: dict = {"metrics": [], "seconds": [], "collectives": [],
                 "layer_collectives": [], "watched": []}
    layered = trainer.params.timings \
        if isinstance(trainer.params, FsdpParams) else None
    dev = trainer.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for step in range(job.steps):
        batch = rows_for(job, step, rank)
        before = dict(mesh.timings) if mesh is not None else {}
        before_layers = dict(layered or {})
        prof = None
        if job.profile and dev.type == "cuda" and step == job.steps - 1:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        _sync(dev)
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        _sync(dev)
        out["seconds"].append(time.perf_counter() - t0)
        if prof is not None:
            prof.stop()
            out["profile"] = _device_readings(prof, out["seconds"][-1])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if job.watch:
            kept = optim.named_leaves(trainer.local_params)
            out["watched"].append({k: kept[k].detach().to("cpu", copy=True)
                                   for k in job.watch})
        if mesh is not None:
            out["collectives"].append({k: mesh.timings[k] - before[k]
                                       for k in before})
        if layered is not None:
            out["layer_collectives"].append(
                {k: layered[k] - before_layers[k] for k in layered})
    out["launches"] = {k.__name__: k.launches for k in kernels}
    if dev.type == "cuda":
        out["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
        out["peak_reserved"] = torch.cuda.max_memory_reserved(dev)
        out["allocated_after"] = torch.cuda.memory_allocated(dev)
    out["state_bytes"] = trainer.state_bytes()
    held = reachable_tensors(trainer, dev)
    out["held_bytes"] = _storage_bytes(held)
    out["held_shapes"] = sorted({tuple(t.shape) for t in held})
    return out


def _device_readings(prof, wall_s: float) -> dict:
    """A traced step's device time: busy (some kernel running), of it the
    NCCL kernels' busy time (the collectives), the rest's, and the idle
    share of the step's wall time."""
    from kubeflow_tpu_torch.tools.train_profile import busy_us

    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    other = [e for e in kernels if "nccl" not in e.name.lower()]
    busy = busy_us(kernels) / 1e3
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "nccl_busy_ms": busy_us(nccl) / 1e3,
            "other_busy_ms": busy_us(other) / 1e3,
            "nccl_kernels": len(nccl), "kernels": len(kernels),
            "idle_share": 1.0 - busy / (wall_s * 1e3)}


def _storage_bytes(tensors: list) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


def reachable_tensors(root, device: torch.device) -> list:
    """Every tensor on ``device`` reachable from ``root``: through
    containers, instances' attributes, bound methods, closures and each
    tensor's ``.grad`` (not through modules, classes or a function's
    globals). After a step, what a trainer keeps, against which
    ``Trainer.state_bytes`` is checked."""
    import gc
    import types

    seen, found, stack = set(), [], [root]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            if x.device == device:
                found.append(x)
            if x.is_leaf and x.grad is not None:
                stack.append(x.grad)
            continue
        if isinstance(x, (types.ModuleType, type, str, bytes)):
            continue
        if isinstance(x, types.FunctionType):
            stack.extend(c.cell_contents for c in x.__closure__ or ())
            stack.extend(x.__defaults__ or ())
            continue
        stack.extend(gc.get_referents(x))
    return found


def train_rank(mesh: WorldMesh, job: Job) -> dict:
    """``job.runs`` on this rank (module docstring). Returns
    ``{"runs": {name: _steps' result, with "allocated_base", the device
    memory allocated before the run's trainer was made}, "backend",
    "micro_mode", "finish_mode", "capture_seconds", "pool_bytes",
    "differ" (the parameters whose replayed bytes differ from the eager
    run's, compared as this rank keeps them: under ``fsdp`` its parts),
    "params" (with
    ``keep_params``: the whole parameters after the last run, on the
    host, gathered under ``fsdp``)}``."""
    import gc

    out: dict = {"runs": {}, "backend": mesh.describe(), "differ": None}
    eager_params = None
    for name in job.runs:
        # what the process holds before this run's trainer exists
        base = (torch.cuda.memory_allocated(mesh.device)
                if mesh.device.type == "cuda" else 0)
        trainer = make_trainer(job, mesh.device, mesh)
        if name == "replayed":
            trainer.precompile(rows_for(job, 0, mesh.axis_index("batch")))
            out["finish_mode"] = trainer.step_graph.finish_mode
            out["micro_mode"] = trainer.step_graph.micro_mode
            out["capture_seconds"] = trainer.step_graph.capture_seconds
            out["pool_bytes"] = trainer.step_graph.pool_bytes
        elif name != "eager":
            raise ValueError(f"unknown run {name!r}")
        out["runs"][name] = _steps(job, trainer, mesh.axis_index("batch"),
                                   mesh)
        out["runs"][name]["allocated_base"] = base
        if name == "replayed" and trainer.step_graph.replays != job.steps:
            raise RuntimeError("the replayed run did not replay its steps")
        if name == "eager" and "replayed" in job.runs:
            eager_params = _host_tree(trainer.local_params)
        elif name == "replayed" and eager_params is not None:
            out["differ"] = [
                k for k, t in optim.named_leaves(trainer.local_params).items()
                if not torch.equal(t.detach().cpu(),
                                   optim.named_leaves(eager_params)[k])]
        if job.keep_params:
            out["params"] = optim.tree_map(
                lambda t: t.detach().cpu().numpy(),
                trainer.checkpoint_state()["params"])
        del trainer
        gc.collect()
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def fit_rank(mesh: WorldMesh, job: Job, ckpt_root: str,
             resume_at: int, mirror_root: Optional[str] = None) -> dict:
    """``fit`` over the world with a checkpoint every 2 steps: run "a"
    uninterrupted to ``job.steps`` into ``ckpt_root/a``; run "b" to
    ``resume_at`` into ``ckpt_root/b``; run "c", a fresh trainer, on
    ``b``'s directory to ``job.steps``; with ``mirror_root``, each
    directory mirrored to its namesake there. Returns each run's losses
    by step, ``resumed_from`` and last metrics, and "a"'s and "c"'s
    whole final state (``Trainer.checkpoint_state``) on the host."""
    from kubeflow_tpu_torch.training import fit

    out: dict = {}

    def batches(start):
        step = start
        while True:
            yield rows_for(job, step, mesh.axis_index("batch"))
            step += 1

    for run, stop, ckpt in (("a", job.steps, "a"), ("b", resume_at, "b"),
                            ("c", job.steps, "b")):
        trainer = make_trainer(job, mesh.device, mesh)
        losses = {}
        res = fit(trainer, batches, max_steps=stop,
                  checkpoint_dir=os.path.join(ckpt_root, ckpt),
                  checkpoint_every=2,
                  checkpoint_mirror=(os.path.join(mirror_root, ckpt)
                                     if mirror_root else None),
                  on_step=lambda s, m: losses.__setitem__(s, m["loss"]))
        out[run] = {"losses": losses, "resumed_from": res.resumed_from,
                    "last": res.last_metrics}
        if run != "b":
            state = trainer.checkpoint_state()
            out[run]["state"] = {
                k: t.detach().cpu() for k, t in
                optim.named_leaves(state).items()}
    return out


def restore_rank(mesh: WorldMesh, job: Job, ckpt_dir: str) -> dict:
    """A fresh trainer over this world restores the newest checkpoint in
    ``ckpt_dir`` (``restore_latest``); returns its step and the whole
    state it then holds (``Trainer.checkpoint_state``) on the host."""
    from kubeflow_tpu_torch.training import CheckpointManager, restore_latest

    trainer = make_trainer(job, mesh.device, mesh)
    mgr = CheckpointManager(ckpt_dir)
    step = restore_latest(trainer, mgr)
    mgr.close()
    state = optim.named_leaves(trainer.checkpoint_state())
    return {"step": step,
            "state": {k: t.detach().cpu() for k, t in state.items()}}


def optimizer_rank(mesh: WorldMesh, shapes: dict, dims: dict,
                   optimizer: str, steps: int, seed: int = 0,
                   tensor_dims: Optional[dict] = None,
                   pipeline_dims: Optional[dict] = None) -> dict:
    """``steps`` updates of ``optimizer`` (``make_optimizer``'s, warmup
    2) on each rank's parts of a seeded tree (leaf ``k`` of shape
    ``shapes[k]`` cut on ``dims[k]`` over fsdp and, where the world has
    a ``tensor`` or a ``pipeline`` axis, on ``tensor_dims[k]`` or
    ``pipeline_dims[k]`` over it; None: not cut), gradients drawn anew
    each step, against the unsharded update of the whole tree on the
    same rank. Slice ``s`` of a leaf along its ``pipeline_dims`` dim is
    scaled by 2 ** -s, in the parameters and in every gradient, so that
    the stages' statistics differ, as a model's stages' do. Returns per
    leaf the largest absolute difference between the rank's part and
    its slice of the whole result."""
    from kubeflow_tpu_torch.parallel import sharding
    from kubeflow_tpu_torch.training import TrainerConfig, make_optimizer

    cfg = TrainerConfig(optimizer=optimizer, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(seed)
    tensor_dims, pipeline_dims = tensor_dims or {}, pipeline_dims or {}

    def draw(k, s):
        t = torch.tensor(rng.standard_normal(s).astype(np.float32))
        d = pipeline_dims.get(k)
        if d is None:
            return t
        scale = [1] * len(s)
        scale[d] = s[d]
        return t * (0.5 ** torch.arange(s[d], dtype=t.dtype)).reshape(scale)

    whole = {k: draw(k, s) for k, s in shapes.items()}
    cuts = {k: optim.LeafCut(tuple(s), dims.get(k), tensor_dims.get(k),
                             pipeline_dim=pipeline_dims.get(k))
            for k, s in shapes.items()}

    def part(k, t):
        for axis, d in (("pipeline", pipeline_dims.get(k)),
                        ("fsdp", dims.get(k)), ("tensor", tensor_dims.get(k))):
            if d is not None and mesh.axis_size(axis) > 1:
                t = sharding.axis_shard(t, d, mesh.axis_index(axis),
                                        mesh.axis_size(axis), axis)
        return t

    parts = {k: part(k, t) for k, t in whole.items()}
    tx_whole = make_optimizer(cfg)
    tx_parts = make_optimizer(cfg, optim.Shards(cuts, mesh.all_reduce))
    s_whole, s_parts = tx_whole.init(whole), tx_parts.init(parts)
    for _ in range(steps):
        g = {k: draw(k, s) for k, s in shapes.items()}
        up, _ = tx_whole.update(g, s_whole, whole)
        optim.apply_updates(whole, up)
        g_parts = {k: part(k, t) for k, t in g.items()}
        up, _ = tx_parts.update(g_parts, s_parts, parts)
        optim.apply_updates(parts, up)
    return {k: float((parts[k] - part(k, whole[k])).abs().max())
            for k in shapes}


def moe_layer_rank(mesh: Optional[WorldMesh], inputs: dict,
                   cases: Sequence[tuple], device=None) -> dict:
    """``parallel.moe.moe_layer`` over the world on whole inputs, once a
    case. ``inputs`` (numpy arrays or tensors, or a function of no
    argument that makes them in the rank): ``x`` [B, S, D], ``params``
    (``router`` [D, E], ``w_gate`` / ``w_up`` [E, D, M], ``w_down``
    [E, M, D]), ``mask`` [B, S] bool and ``weights`` [B, S, D];
    ``cases``: ``(name,
    capacity factor, top_k, masked)``. The rank takes the rows of its
    place in the batch axes, the experts of its ``expert`` index and the
    ``mlp`` slice of its ``tensor`` index, the tokens of its
    ``context`` index (chunk ``c`` of every row), in the inputs' dtype
    on ``device`` (default the mesh's; without a mesh, the whole inputs:
    the one-process layer), and runs the backward of ``sum(y *
    weights) + aux / n`` (n the ``tokens`` ranks: every one adds the
    global aux, so the world's summed gradients are those of the
    whole-batch loss). Returns the rank's coordinates, per case its part
    of the output, the aux readings and the gradients of x and of the
    rank's weights (on the host), and the world's ``timings``."""
    from kubeflow_tpu_torch.parallel import moe

    device = torch.device(device) if device is not None else mesh.device
    size = (lambda a: mesh.axis_size(a)) if mesh is not None else \
        (lambda a: 1)
    index = (lambda a: mesh.axis_index(a)) if mesh is not None else \
        (lambda a: 0)

    def part(n_all, axis):
        n, i = size(axis), index(axis)
        return slice(i * n_all // n, (i + 1) * n_all // n)

    if callable(inputs):
        inputs = inputs()
    b, s, d = inputs["x"].shape
    e, _, m = inputs["params"]["w_gate"].shape
    rows, toks = part(b, "batch"), part(s, "context")
    experts, cols = part(e, "expert"), part(m, "tensor")

    def tensor(a):
        """A tensor of its own on ``device``."""
        if isinstance(a, np.ndarray):
            return torch.tensor(np.ascontiguousarray(a), device=device)
        return a.to(device, copy=True).contiguous()

    whole = inputs["params"]
    out = []
    mine = lambda a: tensor(a[rows, toks])
    for _, cf, top_k, masked in cases:
        params = {"router": tensor(whole["router"]),
                  "w_gate": tensor(whole["w_gate"][experts, :, cols]),
                  "w_up": tensor(whole["w_up"][experts, :, cols]),
                  "w_down": tensor(whole["w_down"][experts, cols, :])}
        for p in params.values():
            p.requires_grad_(True)
        x = mine(inputs["x"]).requires_grad_(True)
        cfg = moe.MoEConfig(dim=d, mlp_dim=m, n_experts=e, top_k=top_k,
                            capacity_factor=cf, dtype=x.dtype)
        y, aux = moe.moe_layer(params, x, cfg,
                               token_mask=(mine(inputs["mask"])
                                           if masked else None),
                               world=mesh)
        loss = (y * mine(inputs["weights"])).sum() \
            + moe.moe_aux_total(aux) / size("tokens")
        loss.backward()
        out.append({"y": y.detach().cpu(),
                    "aux": {k: float(v.detach()) for k, v in aux.items()},
                    "x": x.grad.cpu(),
                    "grads": {k: p.grad.cpu() for k, p in params.items()}})
    return {"batch": (index("batch"), size("batch")),
            "context": (index("context"), size("context")),
            "expert": (index("expert"), size("expert")),
            "tensor": (index("tensor"), size("tensor")), "cases": out,
            "timings": dict(mesh.timings) if mesh is not None else {}}


# the attention functions ``attention_layer_rank`` runs, by name
ATTENTION_IMPLS = {"ring": ra.ring_attention,
                   "ring_plain": ra.ring_attention_reference,
                   "ulysses": ra.ulysses_attention}


def attention_layer_rank(mesh: Optional[WorldMesh], inputs,
                         impls: Sequence[str], causal: bool = True,
                         device=None) -> dict:
    """One attention layer over the world's ``context`` axis on whole
    inputs, once an impl of ``impls`` (``ATTENTION_IMPLS``: the kernels'
    ring, the ring through the kernels' plain versions, Ulysses).
    ``inputs``: a function of the device that makes the whole q [B, S,
    H, D], k/v [B, S, KV, D] and loss weights ``w`` [B, S, H, D] there
    (every rank makes the same). The rank takes the rows of its place in
    the batch axes and the tokens of its context index, runs the layer
    and the backward of ``sum(o * w)``; without a mesh, the whole inputs
    through ``ops.flash_attention.flash_attention`` (one process).
    Returns where the rank's part lies (``rows``, ``tokens``: (start,
    stop)) and per impl its output and the gradients of its q, k and v
    (float32, on the host), the kernels' launches it made, and the
    world's ``timings``."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    device = torch.device(device) if device is not None else mesh.device
    whole = inputs(device)
    b, s = whole["q"].shape[:2]
    nb, ib = ((mesh.axis_size("batch"), mesh.axis_index("batch"))
              if mesh is not None else (1, 0))
    n, c = ((mesh.axis_size("context"), mesh.axis_index("context"))
            if mesh is not None else (1, 0))
    rows = (ib * b // nb, (ib + 1) * b // nb)
    toks = (c * s // n, (c + 1) * s // n)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv)
    out = {"rows": rows, "tokens": toks, "impls": {}}
    for impl in impls:
        part = {k: x[rows[0]:rows[1], toks[0]:toks[1]].clone()
                for k, x in whole.items()}
        q, k, v = (part[x].requires_grad_(True) for x in "qkv")
        before = [f.launches for f in kernels]
        if mesh is None:
            o = fa.flash_attention(q, k, v, causal=causal)
        else:
            o = ATTENTION_IMPLS[impl](q, k, v, mesh, causal=causal)
        (o.float() * part["w"].float()).sum().backward()
        _sync(device)
        out["impls"][impl] = {
            "o": o.detach().float().cpu(), "q": q.grad.float().cpu(),
            "k": k.grad.float().cpu(), "v": v.grad.float().cpu(),
            "launches": {f.__name__: f.launches - a
                         for f, a in zip(kernels, before)}}
    out["timings"] = dict(mesh.timings) if mesh is not None else {}
    return out


def mlp_stage(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``pipeline_rank``'s stage: ``tanh(x @ w + b)``."""
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_rank(mesh: Optional[WorldMesh], inputs: dict,
                  microbatches: int) -> dict:
    """``parallel.pipeline.pipeline_apply`` of ``mlp_stage`` over the
    world's ``pipeline`` axis (S stages). ``inputs``: numpy arrays, the
    stacked stages ``w`` [S, D, D] and ``b`` [S, D], and ``x`` [B, D].
    The rank takes its stage (float32, on the CPU), runs the forward and
    the backward of ``sum(y ** 2)``; then a stage whose aux is 1 on
    every tick it runs (``x + p`` with ``p`` 0, the JAX package's
    masking case) with ``stage_aux``. Returns its stage index, ``y``,
    its stage's gradients, the masking case's output and aux total, and
    the world's ``timings`` of the first pipeline's forward and
    backward."""
    from kubeflow_tpu_torch.parallel.pipeline import pipeline_apply

    s = mesh.axis_index("pipeline") if mesh is not None else 0
    before = dict(mesh.timings) if mesh is not None else {}
    mine = {k: torch.tensor(inputs[k][s]).requires_grad_(True)
            for k in ("w", "b")}
    x = torch.tensor(inputs["x"])
    y = pipeline_apply(mlp_stage, mesh, microbatches=microbatches)(mine, x)
    (y ** 2).sum().backward()
    timings = {k: v - before[k] for k, v in mesh.timings.items()} \
        if mesh is not None else {}
    masked = pipeline_apply(
        lambda p, x: (x + p, 1.0 + 0.0 * x.sum()), mesh,
        microbatches=microbatches, stage_aux=True)
    with torch.no_grad():
        y_aux, aux = masked(torch.zeros(()), torch.ones_like(x))
    return {"stage": s, "y": y.detach(),
            "grads": {k: t.grad for k, t in mine.items()},
            "y_aux": y_aux, "aux": float(aux), "timings": timings}


def pipeline_forward_rank(mesh: WorldMesh, job: Job, tokens) -> dict:
    """The pipelined llama's logits (``parallel.pipeline_llama.
    pipeline_forward``, ``job.microbatches`` micro batches) of this
    rank's rows of ``tokens`` (numpy [B, S]: the rows of its place in
    the batch axes), its stage cut from ``job.params``, on the host."""
    from kubeflow_tpu_torch import interop
    from kubeflow_tpu_torch.parallel import pipeline_llama as pl
    from kubeflow_tpu_torch.parallel import sharding
    from kubeflow_tpu_torch.parallel.tensor import TensorParams

    n, i = mesh.axis_size("pipeline"), mesh.axis_index("pipeline")
    tree = pl.to_pipeline_params(
        interop.params_from_jax(job.params, device=mesh.device), n)
    tree = sharding.axis_part(tree, pl.pipeline_param_logical_axes(
        job.config), "pipeline", i, n)
    nb, ib = mesh.axis_size("batch"), mesh.axis_index("batch")
    b = tokens.shape[0] // nb
    rows = torch.tensor(tokens[ib * b:(ib + 1) * b], device=mesh.device)
    with torch.no_grad():
        logits, aux = pl.pipeline_forward(
            TensorParams(tree, mesh), rows, job.config,
            microbatches=job.microbatches)
    return {"rows": (ib * b, (ib + 1) * b), "logits": logits.cpu(),
            "moe_aux": float(aux["moe_aux"])}


def plans_rank(mesh: WorldMesh, plans: Sequence[tuple]) -> list:
    """Several bodies over one world, each ``(data, fsdp[, tensor[,
    expert[, context[, pipeline]]]], body, args)`` on a mesh of those
    sizes over the same processes (new groups, the same backend); their
    results in order."""
    out = []
    for *sizes, body, args in plans:
        data, fsdp, tensor, expert, context, pipeline = \
            (*sizes, 1, 1, 1, 1)[:6]
        m = mesh if (data, fsdp, tensor, expert, context, pipeline) == (
            mesh.data, mesh.fsdp, mesh.tensor, mesh.expert,
            mesh.context, mesh.pipeline) else WorldMesh(
            data, fsdp, mesh.rank, mesh.device, mesh.backend, tensor=tensor,
            expert=expert, context=context, pipeline=pipeline)
        out.append(body(m, *args))
    return out


def _rank_main(rank: int, devices: Sequence[str], data: int, fsdp: int,
               rundir: str, body, args: tuple, tensor: int = 1,
               expert: int = 1, context: int = 1,
               pipeline: int = 1) -> None:
    from kubeflow_tpu_torch.rendezvous.bootstrap import join_world

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = join_world("file://" + os.path.join(rundir, "rendezvous"),
                         rank, len(devices), device)
    mesh = WorldMesh(data, fsdp, rank, device, backend, tensor=tensor,
                     expert=expert, context=context, pipeline=pipeline)
    try:
        result = body(mesh, *args)
        torch.save(result, os.path.join(rundir, f"rank{rank}.pt"))
    finally:
        import gc

        gc.collect()        # the step graphs, before their communicators
        torch.distributed.destroy_process_group()


def run(body, args: tuple, data: int, fsdp: int, devices: Sequence[str],
        rundir: str, tensor: int = 1, expert: int = 1,
        context: int = 1, pipeline: int = 1) -> list:
    """Spawn ``pipeline * data * fsdp * expert * context * tensor``
    ranks, rank ``r`` on ``devices[r]``, each running ``body(mesh,
    *args)``; their results in rank order (module docstring). ``rundir``
    must be empty of an earlier world's rendezvous file."""
    import torch.multiprocessing as mp

    n = pipeline * data * fsdp * tensor * expert * context
    if len(devices) != n:
        raise ValueError(f"pipeline={pipeline} x data={data} x fsdp={fsdp} "
                         f"x expert={expert} x context={context} x "
                         f"tensor={tensor} needs {n} devices, got "
                         f"{list(devices)}")
    os.makedirs(rundir, exist_ok=True)
    mp.spawn(_rank_main, args=(list(devices), data, fsdp, rundir, body,
                               args, tensor, expert, context, pipeline),
             nprocs=n, join=True)
    return [torch.load(os.path.join(rundir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]

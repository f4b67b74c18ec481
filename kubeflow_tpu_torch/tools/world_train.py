"""Train a seeded llama over a world of spawned processes
(``parallel.mesh.WorldMesh``), rank by rank, and bring back what each
rank saw: the per-step metrics of the global batch, the step's wall
time and its host-staged collectives, memory, the state each rank keeps
(``Trainer.state_bytes``, checked against ``held_bytes``) and, where
asked, the whole parameters.

    from kubeflow_tpu_torch.tools import world_train
    results = world_train.run(world_train.Job(cfg, {...}, local_batch=2,
                              seq=16, steps=3), data=2, fsdp=1,
                              devices=["cpu"] * 2, rundir=tmp)

``run`` spawns one process a rank (the ``spawn`` start method), each
joining a gloo default group through a file in ``rundir``
(``rendezvous.bootstrap.join_world``, which chooses the backend of the
model's collectives from where the ranks run), and calls one of the rank
bodies below with the job. A rank's result is written to
``rundir/rank{r}.pt`` and returned in rank order; a rank that raises
makes ``run`` raise.

Each rank feeds its own rows: ``batch_for(job, step, rank)``, the
synthetic token stream's draw (``training.data.synthetic_lm_batches``,
seeded by ``[data_seed, step, rank]``) and, with ``mask``, a loss mask
drawn after it whose density varies by row and by rank, so the ranks'
token counts differ. ``global_batch(job, world, step)`` is the
concatenation of every rank's rows, the batch a one-process trainer (or
the JAX trainer) takes for the same step.

The rank bodies: ``train_rank`` (``Job.runs`` one after another, each
with a fresh trainer from the same parameters: "eager" steps, or
"replayed" steps after ``precompile``; with both, the replayed run's
losses, grad norms and parameters must be bitwise the eager run's on
every rank), ``fit_rank`` (``fit`` with checkpoints: uninterrupted, and
stopped at ``resume_at`` then resumed by a fresh trainer),
``optimizer_rank`` (the optimizer on fsdp parts against the unsharded
update of the whole tree) and ``plans_rank`` (several of them, each on
its own layout of the same processes).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.parallel.mesh import WorldMesh
from kubeflow_tpu_torch.training import optim


@dataclasses.dataclass(frozen=True)
class Job:
    """What every rank of a world trains. ``config`` is the model;
    ``trainer`` the ``TrainerConfig`` fields; ``params`` a nested dict of
    numpy arrays to start from (default: ``llama.init_params`` from a
    generator on the rank's device seeded ``param_seed``); ``runs`` the
    runs of ``train_rank``, in order."""
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


def batch_for(job: Job, step: int, rank: int) -> dict:
    """Rank ``rank``'s rows of step ``step`` (module docstring)."""
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


def global_batch(job: Job, world: int, step: int) -> dict:
    """Every rank's rows of step ``step``, concatenated in rank order."""
    parts = [batch_for(job, step, r) for r in range(world)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def make_trainer(job: Job, device: torch.device, mesh=None):
    """The job's llama trainer on ``device`` (over ``mesh`` when given),
    its state initialised."""
    from kubeflow_tpu_torch import interop
    from kubeflow_tpu_torch.training import Trainer, TrainerConfig, lm_loss_fn

    cfg = job.config
    if job.params is not None:
        init = lambda g: interop.params_from_jax(job.params, device=device)
    else:
        init = lambda g: llama.init_params(g, cfg, device=device)
    trainer = Trainer(init, lm_loss_fn(llama.forward, cfg),
                      TrainerConfig(**job.trainer), device=device, mesh=mesh,
                      param_axes=llama.param_logical_axes(cfg))
    trainer.init_state(torch.Generator(device=device)
                       .manual_seed(job.param_seed))
    return trainer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_tree(tree) -> dict:
    return optim.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _steps(job: Job, trainer, rank: int, mesh) -> dict:
    """``job.steps`` steps on the rank's rows: per step the metrics, the
    wall seconds (ending in a synchronize) and the host-staged
    collectives' timings (``WorldMesh.timings``, this step's share)."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv)
    for k in kernels:
        k.launches = 0
    out: dict = {"metrics": [], "seconds": [], "collectives": []}
    dev = trainer.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for step in range(job.steps):
        batch = batch_for(job, step, rank)
        before = dict(mesh.timings) if mesh is not None else {}
        _sync(dev)
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        _sync(dev)
        out["seconds"].append(time.perf_counter() - t0)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            out["collectives"].append({k: mesh.timings[k] - before[k]
                                       for k in before})
    out["launches"] = {k.__name__: k.launches for k in kernels}
    if dev.type == "cuda":
        out["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
        out["peak_reserved"] = torch.cuda.max_memory_reserved(dev)
        out["allocated_after"] = torch.cuda.memory_allocated(dev)
    out["state_bytes"] = trainer.state_bytes()
    out["held_bytes"] = held_bytes(trainer, dev)
    return out


def held_bytes(root, device: torch.device) -> int:
    """Bytes of the distinct storages on ``device`` of every tensor
    reachable from ``root``: through containers, instances' attributes,
    bound methods, closures and each tensor's ``.grad`` (not through
    modules, classes or a function's globals). After a step, what a
    trainer keeps, against which ``Trainer.state_bytes`` is checked."""
    import gc
    import types

    seen, storages, stack = set(), {}, [root]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            if x.device == device:
                s = x.untyped_storage()
                storages[s.data_ptr()] = s.nbytes()
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
    return sum(storages.values())


def train_rank(mesh: WorldMesh, job: Job) -> dict:
    """``job.runs`` on this rank (module docstring). Returns
    ``{"runs": {name: _steps' result, with "allocated_base", the device
    memory allocated before the run's trainer was made}, "backend",
    "finish_mode",
    "capture_seconds", "differ" (the parameters whose replayed bytes
    differ from the eager run's), "params" (with ``keep_params``: the
    whole parameters after the last run, on the host)}``."""
    import gc

    out: dict = {"runs": {}, "backend": mesh.describe(), "differ": None}
    eager_params = None
    for name in job.runs:
        # what the process holds before this run's trainer exists
        base = (torch.cuda.memory_allocated(mesh.device)
                if mesh.device.type == "cuda" else 0)
        trainer = make_trainer(job, mesh.device, mesh)
        if name == "replayed":
            trainer.precompile(batch_for(job, 0, mesh.rank))
            out["finish_mode"] = trainer.step_graph.finish_mode
            out["capture_seconds"] = trainer.step_graph.capture_seconds
        elif name != "eager":
            raise ValueError(f"unknown run {name!r}")
        out["runs"][name] = _steps(job, trainer, mesh.rank, mesh)
        out["runs"][name]["allocated_base"] = base
        if name == "replayed" and trainer.step_graph.replays != job.steps:
            raise RuntimeError("the replayed run did not replay its steps")
        if name == "eager" and "replayed" in job.runs:
            eager_params = _host_tree(trainer.params)
        elif name == "replayed" and eager_params is not None:
            out["differ"] = [
                k for k, t in optim.named_leaves(trainer.params).items()
                if not torch.equal(t.detach().cpu(),
                                   optim.named_leaves(eager_params)[k])]
        if job.keep_params:
            out["params"] = optim.tree_map(
                lambda t: t.detach().cpu().numpy(), trainer.params)
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
            yield batch_for(job, step, mesh.rank)
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


def optimizer_rank(mesh: WorldMesh, shapes: dict, dims: dict,
                   optimizer: str, steps: int, seed: int = 0) -> dict:
    """``steps`` updates of ``optimizer`` (``make_optimizer``'s, warmup
    2) on each rank's fsdp parts of a seeded tree (leaf ``k`` of shape
    ``shapes[k]`` cut on ``dims[k]``, gradients drawn anew each step),
    against the unsharded update of the whole tree on the same rank.
    Returns per leaf the largest absolute difference between the rank's
    part and its slice of the whole result."""
    from kubeflow_tpu_torch.parallel import sharding
    from kubeflow_tpu_torch.training import TrainerConfig, make_optimizer

    cfg = TrainerConfig(optimizer=optimizer, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(seed)
    whole = {k: torch.tensor(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    n, i = mesh.fsdp, mesh.fsdp_index
    parts = {k: sharding.fsdp_shard(t, dims[k], i, n)
             for k, t in whole.items()}
    cuts = {k: optim.LeafCut(tuple(s), dims[k]) for k, s in shapes.items()}
    tx_whole = make_optimizer(cfg)
    tx_parts = make_optimizer(cfg, optim.Shards(
        cuts, lambda t: mesh.all_reduce(t, "fsdp")))
    s_whole, s_parts = tx_whole.init(whole), tx_parts.init(parts)
    for _ in range(steps):
        g = {k: torch.tensor(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
        up, _ = tx_whole.update(g, s_whole, whole)
        optim.apply_updates(whole, up)
        g_parts = {k: sharding.fsdp_shard(t, dims[k], i, n)
                   for k, t in g.items()}
        up, _ = tx_parts.update(g_parts, s_parts, parts)
        optim.apply_updates(parts, up)
    return {k: float((parts[k] - sharding.fsdp_shard(
        whole[k], dims[k], i, n)).abs().max()) for k in shapes}


def plans_rank(mesh: WorldMesh, plans: Sequence[tuple]) -> list:
    """Several bodies over one world, each ``(data, fsdp, body, args)``
    on a mesh of those sizes over the same processes (new groups, the
    same backend); their results in order."""
    out = []
    for data, fsdp, body, args in plans:
        m = mesh if (data, fsdp) == (mesh.data, mesh.fsdp) else WorldMesh(
            data, fsdp, mesh.rank, mesh.device, mesh.backend)
        out.append(body(m, *args))
    return out


def _rank_main(rank: int, devices: Sequence[str], data: int, fsdp: int,
               rundir: str, body, args: tuple) -> None:
    from kubeflow_tpu_torch.rendezvous.bootstrap import join_world

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = join_world("file://" + os.path.join(rundir, "rendezvous"),
                         rank, len(devices), device)
    mesh = WorldMesh(data, fsdp, rank, device, backend)
    try:
        result = body(mesh, *args)
        torch.save(result, os.path.join(rundir, f"rank{rank}.pt"))
    finally:
        import gc

        gc.collect()        # the step graphs, before their communicators
        torch.distributed.destroy_process_group()


def run(body, args: tuple, data: int, fsdp: int, devices: Sequence[str],
        rundir: str) -> list:
    """Spawn ``data * fsdp`` ranks, rank ``r`` on ``devices[r]``, each
    running ``body(mesh, *args)``; their results in rank order
    (module docstring). ``rundir`` must be empty of an earlier world's
    rendezvous file."""
    import torch.multiprocessing as mp

    n = data * fsdp
    if len(devices) != n:
        raise ValueError(f"data={data} x fsdp={fsdp} needs {n} devices, "
                         f"got {list(devices)}")
    os.makedirs(rundir, exist_ok=True)
    mp.spawn(_rank_main, args=(list(devices), data, fsdp, rundir, body,
                               args), nprocs=n, join=True)
    return [torch.load(os.path.join(rundir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]

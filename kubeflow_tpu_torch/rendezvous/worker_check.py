"""The training pod of the PyTorch port (counterpart of
``kubeflow_tpu.rendezvous.worker_check``): rendezvous, a collective across
the world, and optionally real training with checkpoint resume.

Run as ``python -m kubeflow_tpu_torch.rendezvous.worker_check`` inside a
pod of a ``JAXJob`` or ``PyTorchJob`` (``rendezvous/bootstrap.py`` reads
either env contract). Exit 0 = a healthy world. Step for step the
reference's ``main``:

1. stamps ``proc_start``, ``imports_done``, ``rendezvous_done`` (the
   phase report, ``_phase``);
2. the world check: each process contributes a ``[1, 4]`` tensor filled
   with its process id, all-reduced over the world; the total must be
   ``4 * sum(range(N))``; ``KFT_METRICS_PATH`` gets ``world_ok=1.0``;
3. with ``KFT_TRAIN_STEPS``: the reference's ``llama_tiny`` float32
   trainer (adamw, lr 1e-3, warmup 2) over synthetic batches of
   ``max(2 * N, 4)`` x 16 tokens: ``init_state``, then the restore from
   ``KFT_CHECKPOINT_DIR`` (or its ``KFT_CHECKPOINT_MIRROR``), then
   ``precompile(first batch, depot=...)`` on a card, then ``fit`` with
   checkpoints every ``KFT_CHECKPOINT_EVERY`` steps, paced by
   ``KFT_STEP_SLEEP`` seconds a step. Under ``KFT_DEPOT`` the capture
   stays local and its outcome is "compiled" (``parallel/depot.py``). On
   the CPU (``KFT_FORCE_PLATFORM=cpu``) there is no graph: the step runs
   eagerly and the outcome is reported as ``"eager"``, never as a
   capture. Over more than one process the trainer trains over the
   world ``KFT_MESH`` lays out (``bootstrap.world_mesh``: ``data`` and
   ``fsdp``, by default every process on ``fsdp``), each process feeding
   its own rows of the global batch, as the reference's pods do; the
   coordinator writes the metrics and the checkpoints, and every
   process restores its own part from them.

The world check and the training run over the backend the world chose
(``bootstrap.choose_backend``), which the last line names with its
reason.
"""

from __future__ import annotations

import os
import sys

# the outcome reported where no step is captured (the CPU)
EAGER = "eager"


def _phase(phases: dict, name: str, extra: dict | None = None,
           at: float | None = None) -> None:
    """Record a named absolute timestamp (``at`` overrides "now" for
    events measured elsewhere, as the profiler window's stop) and flush
    the report to KFT_PHASES_PATH, so the operator can decompose
    submit->first-step into spawn / imports / rendezvous / compile /
    step 1.

    Two transports behind the one env value, as KFT_HEARTBEAT_FILE: a
    filesystem path writes an atomic JSON file ``{path}.{process}``
    (each ``extra`` key in its own ``{path}.{key}.{process}``); an
    http(s) URL POSTs ``{"phases": {...}, **extra}`` to the operator,
    whose failures are swallowed (missed posts are the signal, and the
    receiver merges whole-dict posts)."""
    import time

    phases[name] = time.time() if at is None else float(at)
    path = os.environ.get("KFT_PHASES_PATH")
    if not path:
        return
    import json

    proc = os.environ.get("KFT_PROCESS_ID", os.environ.get("RANK", "0"))
    if path.startswith(("http://", "https://")):
        import urllib.request

        try:
            req = urllib.request.Request(
                path, method="POST",
                data=json.dumps(
                    {"phases": phases, **(extra or {})}).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=5).close()
        except Exception:
            pass
        return
    try:
        with open(f"{path}.{os.getpid()}", "w") as f:
            json.dump(phases, f)
        os.replace(f"{path}.{os.getpid()}", f"{path}.{proc}")
        for key, val in (extra or {}).items():
            with open(f"{path}.{key}.{os.getpid()}", "w") as f:
                json.dump(val, f)
            os.replace(f"{path}.{key}.{os.getpid()}",
                       f"{path}.{key}.{proc}")
    except OSError:
        pass


def world_check(world, device, mesh=None) -> float:
    """All-reduce a ``[1, 4]`` tensor of ``process_id`` over the world
    (``mesh``'s backend) and check the total against
    ``4 * sum(range(N))``."""
    import torch

    local = torch.full((1, 4), float(world.process_id),
                       dtype=torch.float32, device=device)
    if mesh is not None:
        mesh.all_reduce(local, "world")
    total = float(local.sum().item())
    expect = 4 * sum(range(world.num_processes))
    assert abs(total - expect) < 1e-5, f"all-reduce {total} != {expect}"
    return total


def train(world, device, steps: int, phases: dict, metrics_path,
          mesh=None):
    """The ``KFT_TRAIN_STEPS`` mode (module docstring, step 3), over
    ``mesh`` (a ``parallel.mesh.WorldMesh``) for more than one process.
    Returns ``(fit result, depot outcome)``."""
    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.parallel.depot import DepotStats, depot_from_env
    from kubeflow_tpu_torch.training import (
        MetricsWriter, Trainer, TrainerConfig, checkpoint_manager, fit,
        lm_loss_fn, restore_latest, synthetic_lm_batches,
    )

    cfg = llama.llama_tiny(dtype=torch.float32)
    trainer = Trainer(
        lambda g: llama.init_params(g, cfg, device=device),
        lm_loss_fn(llama.forward, cfg),
        TrainerConfig(learning_rate=1e-3, warmup_steps=2,
                      total_steps=max(steps, 3)),
        device=device, mesh=mesh,
        param_axes=llama.param_logical_axes(cfg))
    global_batch = max(2 * world.num_processes, 4)

    def batches(start):
        # this process's rows: the stream is seeded by its process index
        return synthetic_lm_batches(cfg.vocab_size, global_batch, 16,
                                    start_step=start)

    dstats = DepotStats()
    depot = depot_from_env(stats=dstats)
    wait_s = (float(os.environ.get("KFT_DEPOT_WAIT_S", "120"))
              if depot is not None and not world.is_coordinator else 0.0)
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    _phase(phases, "state_init_done")

    # restore BEFORE the capture, as the reference restores before it
    # loads its executable: the takeover step is known up front, and the
    # restore writes into the tensors the capture then records
    ckpt_dir = os.environ.get("KFT_CHECKPOINT_DIR")
    resumed = None
    if ckpt_dir:
        mgr = checkpoint_manager(
            trainer, ckpt_dir,
            os.environ.get("KFT_CHECKPOINT_MIRROR") or None)
        resumed = restore_latest(trainer, mgr)
        mgr.close()
        if resumed is not None:
            phases["resumed_from_step"] = float(resumed)
            _phase(phases, "restore_done")

    if device.type == "cuda":
        outcome = trainer.precompile(next(batches(0)), depot=depot,
                                     stats=dstats, wait_s=wait_s)
    else:
        outcome = EAGER
    phases["depot_hit"] = 0.0           # a CUDA graph is never fetched
    _phase(phases, "compile_done",
           extra={"depot": dstats.snapshot()} if depot is not None
           else None)

    metrics = MetricsWriter(metrics_path) if metrics_path else None
    step_sleep = float(os.environ.get("KFT_STEP_SLEEP", "0"))

    def _first_step(step, m):
        if "first_step_done" not in phases:
            _phase(phases, "first_step_done")
        if step_sleep:
            import time

            time.sleep(step_sleep)

    result = fit(trainer, batches, max_steps=steps, metrics=metrics,
                 metrics_every=1, checkpoint_dir=ckpt_dir,
                 checkpoint_every=int(
                     os.environ.get("KFT_CHECKPOINT_EVERY", "100")),
                 on_step=_first_step, already_resumed=resumed)
    if result.profile is not None:
        phases["profile_dir"] = result.profile["dir"]
        phases["profile_start"] = result.profile["t_start"]
        _phase(phases, "profile_done", at=result.profile["t_stop"])
    return result, outcome


def main() -> int:
    phases: dict = {}
    _phase(phases, "proc_start")
    import torch

    from kubeflow_tpu_torch.rendezvous.bootstrap import (
        initialize, world_mesh,
    )
    from kubeflow_tpu_torch.training.metrics import MetricsWriter

    _phase(phases, "imports_done")
    world, device = initialize()
    mesh = world_mesh(world, device)
    _phase(phases, "rendezvous_done")
    try:
        total = world_check(world, device, mesh)
        metrics_path = os.environ.get("KFT_METRICS_PATH")
        if metrics_path:
            MetricsWriter(metrics_path).write(
                0, world_ok=1.0, process_id=world.process_id, total=total)
        steps = int(os.environ.get("KFT_TRAIN_STEPS", "0"))
        if steps:
            result, outcome = train(world, device, steps, phases,
                                    metrics_path, mesh)
            incarnation = os.environ.get("KFT_WORKER_INCARNATION", "0")
            print(f"worker {world.process_id}: trained to step "
                  f"{result.final_step} (resumed_from={result.resumed_from}, "
                  f"depot={outcome}, incarnation={incarnation})")
        backend = (f", mesh={mesh.shape}, backend={mesh.backend.name} "
                   f"({mesh.backend.reason})" if mesh is not None else "")
        print(f"worker {world.process_id}/{world.num_processes}: world ok, "
              f"devices={world.num_processes}, collective={total}{backend}")
    finally:
        if torch.distributed.is_initialized():
            # a captured step's graphs hold the NCCL communicators'
            # kernels: free them (they sit in reference cycles) before
            # the communicators are torn down
            import gc

            gc.collect()
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

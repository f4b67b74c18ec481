"""High-level training loop (counterpart of
``kubeflow_tpu.training.loop``): checkpoint auto-resume, metrics export,
heartbeats and the profiler toggle around ``Trainer.train_step``.

Every run is restore-latest -> train -> periodic save: a restarted job
resumes where it left off, step-exact (``restore_latest`` writes the
saved state into the trainer's own tensors, so a step already captured
as CUDA graphs trains the restored state at its next replay).

Over a world (a trainer with a ``WorldMesh``) every rank runs ``fit``:
the coordinator alone writes the metrics and the checkpoints, the whole
state in the one-process format (``Trainer.checkpoint_state``), so a
checkpoint written by N processes restores into any number, 1 included;
every rank restores its own part from it, at the step the coordinator
reads, and the ranks pass a barrier at each save. Only the coordinator's
manager has the mirror (``checkpoint_manager``): it alone copies steps
to the mirror and fetches them back, so no two processes write one path.

``KFT_PROFILE_DIR`` / ``KFT_PROFILE_STEPS`` drive ``torch.profiler`` (CPU
and, on a card, CUDA activity) where the JAX loop drives
``jax.profiler``; the window's trace lands in the directory as a Chrome
trace.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Any, Callable, Iterable, Optional

import torch

from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from kubeflow_tpu_torch.training.metrics import MetricsWriter
from kubeflow_tpu_torch.training.trainer import Trainer


@dataclasses.dataclass
class FitResult:
    final_step: int
    resumed_from: Optional[int]
    last_metrics: dict
    # set iff the profiler window actually ran: {"dir", "t_start",
    # "t_stop", "trace"} (wall times of start/stop and the trace file)
    profile: Optional[dict] = None


def post_heartbeat(url: str, step=None, warning=None, spans=None,
                   timeout: float = 5.0) -> bool:
    """The http transport of the heartbeat contract (beats + warnings +
    worker-reported spans). Failures are swallowed: missed beats ARE the
    failure signal."""
    import json
    import urllib.request

    body: dict = {}
    if step is not None:
        body["step"] = int(step)
    if warning is not None:
        body["warning"] = warning
    if spans:
        body["spans"] = list(spans)
    try:
        req = urllib.request.Request(
            url, method="POST", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=timeout).close()
        return True
    except Exception:
        return False


class Heartbeat:
    """Liveness signal the controller turns missed beats into restarts
    with. One env value (KFT_HEARTBEAT_FILE), two transports:

    - a filesystem path (shared fs): mtime is the signal, content is the
      last step;
    - an http(s) URL: beats POST to the operator's heartbeat route from a
      BACKGROUND thread holding only the latest step (rate-limited), so a
      slow or down operator never stalls the training loop.
    """

    def __init__(self, path: str, min_interval_s: float = 1.0):
        self.path = path
        self.is_url = path.startswith(("http://", "https://"))
        self.min_interval_s = min_interval_s
        if self.is_url:
            import queue
            import threading

            self._latest: Optional[int] = None
            self._latest_lock = threading.Lock()
            self._warnings: "queue.Queue[dict]" = queue.Queue()
            self._kick = threading.Event()
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._pump, daemon=True, name="kft-heartbeat-post")
            self._thread.start()
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, warning: Optional[dict] = None) -> None:
        if self.is_url:
            with self._latest_lock:
                self._latest = int(step)
            if warning is not None:
                self._warnings.put(warning)
            self._kick.set()
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, self.path)

    def _take(self) -> tuple[Optional[int], Optional[dict]]:
        """Claim the pending step under the lock, plus one warning."""
        import queue

        with self._latest_lock:
            step, self._latest = self._latest, None
        try:
            warning = self._warnings.get_nowait()
        except queue.Empty:
            warning = None
        return step, warning

    def _pump(self) -> None:
        while not self._stop.is_set():
            self._kick.wait()
            self._kick.clear()
            step, warning = self._take()
            if step is not None or warning is not None:
                post_heartbeat(self.path, step=step, warning=warning)
            if not self._warnings.empty() or self._latest is not None:
                self._kick.set()
            self._stop.wait(self.min_interval_s)

    def close(self) -> None:
        if self.is_url:
            self._stop.set()
            self._kick.set()
            self._thread.join(timeout=10.0)
            while True:
                step, warning = self._take()
                if step is None and warning is None:
                    break
                post_heartbeat(self.path, step=step, warning=warning)


def profile_from_env(env=None) -> tuple[Optional[str],
                                        Optional[tuple[int, int]]]:
    """The pod env contract of the profiler toggle: KFT_PROFILE_DIR names
    the trace directory (unset = off), KFT_PROFILE_STEPS is "start:stop"
    (or "start,stop"). Returns (dir, steps) with None for whatever is
    unset or malformed: a bad value never fails a job over an optional
    profile."""
    env = os.environ if env is None else env
    profile_dir = env.get("KFT_PROFILE_DIR") or None
    steps = None
    raw = env.get("KFT_PROFILE_STEPS") or ""
    if raw:
        try:
            a, b = raw.replace(",", ":").split(":")
            steps = (int(a), int(b))
            if steps[0] >= steps[1] or steps[0] < 0:
                steps = None
        except ValueError:
            steps = None
    return profile_dir, steps


def _is_coordinator(trainer: Trainer) -> bool:
    return trainer.mesh is None or trainer.mesh.is_coordinator


def checkpoint_manager(trainer: Trainer, directory: str,
                       mirror: Optional[str] = None) -> CheckpointManager:
    """The ``CheckpointManager`` of ``directory`` for this process: with
    ``mirror`` on the coordinator, without it on the other ranks of a
    world (module docstring)."""
    return CheckpointManager(
        directory, mirror=mirror if _is_coordinator(trainer) else None)


def restore_latest(trainer: Trainer, mgr: CheckpointManager):
    """Restore the newest checkpoint of ``mgr`` into ``trainer`` and
    return its step, or None when there is none. Shared by ``fit`` and
    by a worker that restores before it captures its step. Over a world
    every rank calls it; the step is the coordinator's newest, and the
    coordinator reads it first (fetching it from its mirror where its
    manager has one and must), then the others, after a barrier.

    The saved parameters and optimizer state (its device-side counts
    included, which drive the device-side schedule) are COPIED into the
    trainer's existing tensors (``Trainer.load_state``), never bound in
    their place: a trainer that was ``precompile``d holds graphs over
    those addresses, and a rebinding restore would leave every later
    replay training the stale state with no error. So
    restore-then-precompile and precompile-then-restore give the same
    steps. The gradient accumulators and the step's sums are zeroed at
    every step and are not saved."""
    if trainer.params is None:
        raise ValueError("restore_latest needs init_state() first")
    latest = mgr.latest_step()
    if trainer.mesh is not None:
        latest = trainer.mesh.broadcast_object(latest)
    if latest is None:
        return None
    first = _is_coordinator(trainer)
    if first:
        _, state = mgr.restore(latest)
    if trainer.mesh is not None:
        trainer.mesh.barrier()
    if not first:
        _, state = mgr.restore(latest)
    trainer.load_state(state, latest)
    return latest


def _save(trainer: Trainer, mgr: CheckpointManager, force: bool = False):
    """Every rank: the whole state (gathered under fsdp), written by the
    coordinator; then the world's barrier."""
    state = trainer.checkpoint_state()
    if _is_coordinator(trainer):
        mgr.save(trainer.step, state, force=force)
    if trainer.mesh is not None:
        trainer.mesh.barrier()


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, info: dict, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    info["t_stop"] = time.time()
    os.makedirs(info["dir"], exist_ok=True)
    path = os.path.join(info["dir"], f"trace-{os.getpid()}-"
                        f"{int(info['t_start'] * 1e3)}.json")
    prof.export_chrome_trace(path)
    info["trace"] = path


def fit(
    trainer: Trainer,
    batches: Iterable[Any] | Callable[[int], Iterable[Any]],
    *,
    generator: Optional[torch.Generator] = None,
    max_steps: int,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    checkpoint_mirror: Optional[str] = None,
    metrics: Optional[MetricsWriter] = None,
    metrics_every: int = 10,
    heartbeat: Optional[Heartbeat] = None,
    profile_dir: Optional[str] = None,
    profile_steps: Optional[tuple[int, int]] = None,
    on_step: Optional[Callable[[int, dict], None]] = None,
    already_resumed: Optional[int] = None,
) -> FitResult:
    """Run ``trainer`` up to ``max_steps`` with auto-resume.

    The state is initialised from ``generator`` unless the caller already
    did. If ``checkpoint_dir`` holds a checkpoint, it is restored
    (``restore_latest``) and training continues from the saved step;
    every ``checkpoint_every`` steps and at the end the state is saved
    there (and replicated to ``checkpoint_mirror`` or
    KFT_CHECKPOINT_MIRROR). Data resumes deterministically: ``batches``
    is a callable ``(start_step) -> iterator`` (preferred: a
    step-indexed dataset seeks), or a plain iterable whose first
    ``resumed_from`` batches are skipped.

    ``already_resumed`` says the caller restored the checkpoint itself
    (a worker that restores before it captures its step): fit skips its
    own restore but still performs the resume handshake, an immediate
    heartbeat at the takeover step.

    A trainer whose step was ``precompile``d replays its captured graphs
    at every step (``Trainer.train_step``); the profiler window then
    sees the kernels the replays run. Heartbeats and the profiler window
    follow the pod env (KFT_HEARTBEAT_FILE, KFT_PROFILE_DIR,
    KFT_PROFILE_STEPS) where the arguments leave them unset. A mirror
    that fails is counted as ``ckpt_mirror_errors`` in the metrics.

    Over a world every rank calls ``fit`` with the same arguments and
    its own rows; ``metrics`` are written by the coordinator only, and
    so are the checkpoints (module docstring).
    """
    own_heartbeat = heartbeat is None \
        and bool(os.environ.get("KFT_HEARTBEAT_FILE"))
    if own_heartbeat:
        heartbeat = Heartbeat(os.environ["KFT_HEARTBEAT_FILE"])
    env_dir, env_steps = profile_from_env()
    if profile_dir is None:
        profile_dir = env_dir
    if profile_steps is None:
        profile_steps = env_steps or (10, 20)

    if trainer.params is None:
        trainer.init_state(generator)
    if not _is_coordinator(trainer):
        metrics = None
    resumed_from = already_resumed
    mgr = None
    if checkpoint_dir:
        mgr = checkpoint_manager(
            trainer, checkpoint_dir,
            checkpoint_mirror or os.environ.get("KFT_CHECKPOINT_MIRROR")
            or None)
        if already_resumed is None:
            resumed_from = restore_latest(trainer, mgr)
    if resumed_from is not None and heartbeat is not None:
        # resume handshake: the takeover step, before the first
        # post-resume step completes
        heartbeat.beat(resumed_from)

    if callable(batches):
        batches = batches(trainer.step)
    elif resumed_from:
        batches = itertools.islice(iter(batches), resumed_from, None)

    prof = None
    profile_info: Optional[dict] = None
    last: dict = {}
    try:
        for batch in batches:
            if trainer.step >= max_steps:
                break
            if profile_dir and prof is None \
                    and trainer.step == profile_steps[0]:
                profile_info = {"dir": profile_dir, "t_start": time.time()}
                prof = _start_profiler(trainer.device)
            m = trainer.train_step(batch)
            if prof is not None and trainer.step >= profile_steps[1]:
                _stop_profiler(prof, profile_info, trainer.device)
                prof = None

            last = {k: float(v) for k, v in m.items()
                    if hasattr(v, "__float__")}
            if mgr is not None and mgr.mirror_errors:
                last["ckpt_mirror_errors"] = float(mgr.mirror_errors)
            if metrics is not None and trainer.step % metrics_every == 0:
                metrics.write(trainer.step, **last)
            if heartbeat is not None:
                heartbeat.beat(trainer.step)
            if mgr is not None and trainer.step % checkpoint_every == 0:
                _save(trainer, mgr)
            if on_step is not None:
                on_step(trainer.step, last)
        if mgr is not None:
            # the final save, unless this step is already on disk (the
            # in-loop save took it, or a resumed run trained 0 steps);
            # the in-loop save's write may still be running, and a step
            # counts once its write has ended
            mgr.wait()
            latest = mgr.latest_step()
            if trainer.mesh is not None:
                latest = trainer.mesh.broadcast_object(latest)
            if latest != trainer.step:
                _save(trainer, mgr, force=True)
            mgr.wait()
            if trainer.mesh is not None:
                trainer.mesh.barrier()      # the write is on disk
    finally:
        if prof is not None:
            _stop_profiler(prof, profile_info, trainer.device)
        if own_heartbeat:
            heartbeat.close()
        if mgr is not None:
            mgr.close()         # a pending write finishes either way
    if metrics is not None and last:
        metrics.write(trainer.step, **last)
    return FitResult(final_step=trainer.step, resumed_from=resumed_from,
                     last_metrics=last,
                     profile=(profile_info
                              if profile_info and "t_stop" in profile_info
                              else None))

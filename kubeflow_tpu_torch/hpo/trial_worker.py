"""HPO trial worker of the PyTorch port (counterpart of
``kubeflow_tpu.hpo.trial_worker``): the trial pod's program.

Run as ``python -m kubeflow_tpu_torch.hpo.trial_worker`` inside a trial
pod. The env is the reference's: ``KFT_TRIAL_LR``, ``KFT_TRIAL_WD``
(scalar hyperparameters), ``KFT_TRIAL_WIDTH``, ``KFT_TRIAL_DEPTH``
(structural ones), ``KFT_TRAIN_STEPS``, ``KFT_STEP_SLEEP`` (seconds
slept after each step), ``KFT_METRICS_PATH`` and ``KFT_DEPOT_WAIT_S``.
It runs on the card; ``KFT_FORCE_PLATFORM=cpu`` is the one way to run it
on the CPU, and without it and without a card it raises.

The reference's design rule, in torch: scalars are arguments, not
constants. ``lr`` and ``wd`` are 0-d float32 device tensors that the
step reads (``TrialStep``). On the card the step of one ``(width,
depth)`` is captured once as a CUDA graph over static buffers; the trial
writes its scalars into those buffers with ``copy_`` and replays, so
every trial of a structural config runs the same program. On the CPU the
same body runs eagerly. ``program_key(width, depth)`` names that
program: the scalars never enter it, and width and depth fork it.

The objective is the reference's deterministic convex toy: gradient
descent on ``f(w) = ½‖w‖²`` from ``w = ones(depth, width)`` with ``w ←
w − lr·w − wd·w``, in that order, in float32. Each metrics line is
``loss = raw / (½·depth·width)`` (1.0 at step 0 for every structural
config, then ``(1 − lr − wd)^(2k)``) beside ``raw_loss``. The phase
stamps are the reference's (``proc_start``, ``imports_done``,
``state_init_done``, ``compile_done`` with the depot snapshot,
``first_step_done`` with the ``trial.load`` and ``trial.step`` spans,
plus ``depot_hit`` and ``depot_outcome``), through the port's
``rendezvous.worker_check._phase``.

The depot: a CUDA graph cannot be published to another process, so the
capture is always local and its outcome comes from
``parallel.depot.local_capture`` ("compiled" under ``KFT_DEPOT``, with
one compile and one serialize failure counted). ``KFT_DEPOT_WAIT_S`` is
read, and no follower waits on it: the publish it would wait for never
comes. On the CPU nothing is captured and the outcome is "eager", as the
training pod's.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import sys
import time

from kubeflow_tpu_torch.rendezvous.worker_check import EAGER, _phase

# the depot scope of the trial program (the reference's fingerprint stage)
STAGE = "hpo-trial"


def step_body(w, lr, wd, loss) -> None:
    """One train step in place: ``loss <- ½‖w‖²`` of the ``w`` it
    starts from, then ``w <- w − lr·w − wd·w``."""
    loss.copy_(0.5 * (w * w).sum())
    w.copy_(w - lr * w - wd * w)


def program_key(width: int, depth: int) -> str:
    """The key of the trial program of one structural config: its
    stage, the structural values, its inputs' shapes and dtypes and the
    step's source. ``lr`` and ``wd`` enter only as 0-d float32 inputs,
    so trials differing in scalars share the key; width and depth fork
    it."""
    spec = {"stage": STAGE,
            "extra": [f"width={width}", f"depth={depth}"],
            "inputs": {"w": [depth, width, "float32"],
                       "lr": [[], "float32"], "wd": [[], "float32"]},
            "body": inspect.getsource(step_body)}
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()


class TrialStep:
    """The trial's state and step for one ``(width, depth)`` on
    ``device``: ``w``, the scalars ``lr`` and ``wd`` and the step's
    ``loss``, each a static tensor the step reads or writes in place."""

    def __init__(self, width: int, depth: int, device):
        import torch

        f32 = dict(dtype=torch.float32, device=device)
        self.device = device
        self.w = torch.ones((depth, width), **f32)
        self.lr = torch.zeros((), **f32)
        self.wd = torch.zeros((), **f32)
        self.loss = torch.zeros((), **f32)
        self.graph = None
        self.captures = 0

    def tensors(self) -> dict:
        return {"w": self.w, "lr": self.lr, "wd": self.wd,
                "loss": self.loss}

    def _run(self) -> None:
        step_body(self.w, self.lr, self.wd, self.loss)

    def set_scalars(self, lr: float, wd: float) -> None:
        """Write a trial's scalars into the step's inputs (float32)."""
        import torch

        self.lr.copy_(torch.tensor(lr, dtype=torch.float32))
        self.wd.copy_(torch.tensor(wd, dtype=torch.float32))

    def capture(self):
        """Capture the step as a CUDA graph (``cuda_graph.capture``); the
        warm-up's writes to ``w`` are undone. Returns the capture."""
        from kubeflow_tpu_torch import cuda_graph

        w0 = self.w.clone()
        cap = cuda_graph.capture([self._run], self.tensors, (), self.device,
                                 "the trial step's inputs",
                                 restore=lambda: self.w.copy_(w0))
        self.graph = cap.graphs[0]
        self.captures += 1
        return cap

    def step(self) -> float:
        """One step (replayed once captured, eager before); the loss of
        the ``w`` it started from."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self._run()
        return float(self.loss)


def main() -> int:
    phases: dict = {}
    _phase(phases, "proc_start")
    from kubeflow_tpu_torch.device import platform_device, resolve_device
    from kubeflow_tpu_torch.parallel.depot import (
        DepotStats, depot_from_env, local_capture,
    )
    from kubeflow_tpu_torch.training.metrics import MetricsWriter

    _phase(phases, "imports_done")

    lr = float(os.environ.get("KFT_TRIAL_LR", "0.1"))
    wd = float(os.environ.get("KFT_TRIAL_WD", "0.0"))
    width = int(os.environ.get("KFT_TRIAL_WIDTH", "8"))
    depth = int(os.environ.get("KFT_TRIAL_DEPTH", "2"))
    steps = int(os.environ.get("KFT_TRAIN_STEPS", "8"))
    step_sleep = float(os.environ.get("KFT_STEP_SLEEP", "0"))
    # parsed as the reference parses it; nothing waits on it (docstring)
    float(os.environ.get("KFT_DEPOT_WAIT_S", "0"))
    device = resolve_device(
        platform_device(os.environ.get("KFT_FORCE_PLATFORM")))

    dstats = DepotStats()
    depot = depot_from_env(stats=dstats)
    trial = TrialStep(width, depth, device)
    trial.set_scalars(lr, wd)
    _phase(phases, "state_init_done")

    if device.type == "cuda":
        trial.capture()
        outcome = local_capture(depot, dstats)
    else:
        outcome = EAGER
    phases["depot_hit"] = 0.0           # a CUDA graph is never fetched
    phases["depot_outcome"] = outcome
    _phase(phases, "compile_done",
           extra={"depot": dstats.snapshot()} if depot is not None
           else None)

    metrics_path = os.environ.get("KFT_METRICS_PATH")
    metrics = MetricsWriter(metrics_path) if metrics_path else None
    loss = float("nan")
    for i in range(steps):
        t_step = time.time()
        loss = trial.step()
        if i == 0:
            t_now = time.time()
            _phase(phases, "first_step_done", extra={"spans": [
                {"name": "trial.load", "t0": phases["proc_start"],
                 "t1": t_step,
                 "attrs": {"depot_outcome": outcome, "width": width,
                           "depth": depth}},
                {"name": "trial.step", "t0": t_step, "t1": t_now,
                 "attrs": {"step": 0}},
            ]})
        if metrics is not None:
            metrics.write(i, loss=loss / (0.5 * depth * width),
                          raw_loss=loss)
        if step_sleep:
            time.sleep(step_sleep)

    print(f"trial done: lr={lr} wd={wd} width={width} depth={depth} "
          f"steps={steps} loss={loss} depot={outcome}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

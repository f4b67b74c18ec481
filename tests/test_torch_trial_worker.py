"""The PyTorch port's HPO trial pod (``python -m
kubeflow_tpu_torch.hpo.trial_worker``) against the JAX package's
(``python -m kubeflow_tpu.hpo.trial_worker``) on the CPU: both run as
subprocesses on the same env (the JAX one with ``JAX_PLATFORMS=cpu``,
the port's with ``KFT_FORCE_PLATFORM=cpu``), and their metrics lines,
phase stamps, spans and final line are compared. One port trial pod runs
as a job on the reference's ``LocalProcessCluster``; its objective comes
from the port's ``objective_from_metrics`` and the operator's
``obs.export.build_job_trace`` renders its phases.

Tolerance: step k's ``loss`` and ``raw_loss`` within ``max(1e-6, (N -
1) * 2^-24) + k * 2.4e-7`` relative of the JAX worker's, N = depth *
width. The first term is the sum: ``raw_loss`` adds N equal squares, and
XLA adds them nearly in sequence, whose float32 error is bounded by (N -
1) * 2^-24 relative (Higham's bound for recursive summation; at N = 512
XLA's sum reads 3.0e-6 off the exact value, torch's pairwise one 1.4e-7;
1e-6 is the floor, for the sums of a few dozen terms). The second is the
update: the port rounds each float32 op of ``w - lr*w - wd*w`` (the
reference's order), while XLA's CPU code contracts a product and its
subtraction into one fused multiply-add, so each update can move ``w``
by up to two roundings (1.2e-7 relative) and its square by twice that
(``w`` after three updates of the (0.3, 0.05) trial: 0.27462497 here,
0.27462500 under XLA).
Every subprocess has its own timeout.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kubeflow_tpu.controller import JobController, LocalProcessCluster
from kubeflow_tpu.api.types import ConditionType
from kubeflow_tpu.client import TrainingClient
from kubeflow_tpu.obs.export import build_job_trace
from kubeflow_tpu_torch.hpo import trial_worker as tw
from kubeflow_tpu_torch.training.metrics import (
    objective_from_metrics, read_metrics,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_STEP = 2.4e-7          # each update's rounding (module docstring)


def rtol(trial, step: int) -> float:
    """The module docstring's tolerance of ``trial``'s step ``step``."""
    n = trial[2] * trial[3]
    return max(1e-6, (n - 1) * 2.0 ** -24) + step * RTOL_STEP

TIMEOUT = 120               # seconds a worker process or job may take
PORT_CMD = [sys.executable, "-m", "kubeflow_tpu_torch.hpo.trial_worker"]
JAX_CMD = [sys.executable, "-m", "kubeflow_tpu.hpo.trial_worker"]

# (lr, wd, width, depth, steps) of the compared trials
TRIALS = [(0.1, 0.0, 8, 2, 8), (0.01, 0.001, 16, 3, 6),
          (0.3, 0.05, 64, 8, 5)]


def _env(tmp, tag: str, trial, **extra) -> dict:
    lr, wd, width, depth, steps = trial
    return {**os.environ,
            "PYTHONPATH": REPO + ":" + os.environ.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1",
            "KFT_TRIAL_LR": str(lr), "KFT_TRIAL_WD": str(wd),
            "KFT_TRIAL_WIDTH": str(width), "KFT_TRIAL_DEPTH": str(depth),
            "KFT_TRAIN_STEPS": str(steps),
            "KFT_METRICS_PATH": str(tmp / f"{tag}.jsonl"),
            "KFT_PHASES_PATH": str(tmp / f"{tag}.phases"), **extra}


def _read(tmp, tag: str, out: str) -> dict:
    def load(path):
        with open(path) as f:
            return json.load(f)

    line = [ln for ln in out.splitlines() if ln.startswith("trial done: ")]
    assert len(line) == 1, out
    fields = dict(kv.split("=", 1)
                  for kv in line[0][len("trial done: "):].split())
    return {"metrics": read_metrics(str(tmp / f"{tag}.jsonl")),
            "phases": load(tmp / f"{tag}.phases.0"),
            "spans": load(tmp / f"{tag}.phases.spans.0"),
            "fields": fields}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every trial through both workers, all processes at once."""
    tmp = tmp_path_factory.mktemp("trials")
    procs = {}
    for i, trial in enumerate(TRIALS):
        procs[("jax", i)] = subprocess.Popen(
            JAX_CMD, env=_env(tmp, f"jax{i}", trial, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        env = _env(tmp, f"port{i}", trial, KFT_FORCE_PLATFORM="cpu")
        env.pop("JAX_PLATFORMS", None)
        procs[("port", i)] = subprocess.Popen(
            PORT_CMD, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for (pkg, i), p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (pkg, i, stderr[-3000:])
            out[(pkg, i)] = _read(tmp, f"{pkg}{i}", stdout)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("i", range(len(TRIALS)))
def test_metrics_lines_match_jax(runs, i):
    """Every step's normalized ``loss`` and ``raw_loss`` within the
    module's tolerance of the JAX worker's, and equal to the closed form
    ``(1 - lr - wd)^(2k)`` to float32 round-off."""
    lr, wd, width, depth, steps = TRIALS[i]
    mine, ref = runs[("port", i)]["metrics"], runs[("jax", i)]["metrics"]
    assert [r["step"] for r in mine] == list(range(steps))
    assert [r["step"] for r in ref] == list(range(steps))
    for a, b in zip(mine, ref):
        assert set(a) == set(b)
        for k in ("loss", "raw_loss"):
            np.testing.assert_allclose(
                a[k], b[k], rtol=rtol(TRIALS[i], a["step"]), atol=0,
                err_msg=f"step {a['step']} {k}")
    closed = [(1 - lr - wd) ** (2 * k) for k in range(steps)]
    np.testing.assert_allclose([r["loss"] for r in mine], closed,
                               rtol=1e-5, atol=0)
    assert mine[0]["loss"] == 1.0 and mine[0]["raw_loss"] == 0.5 * (
        width * depth)


@pytest.mark.parametrize("i", range(len(TRIALS)))
def test_phases_spans_and_final_line_match_jax(runs, i):
    """The same phase names, the same span names with the same
    attributes (the depot outcome apart: the JAX worker compiles with no
    depot, the port's runs eagerly on the CPU) and the same printed
    fields."""
    mine, ref = runs[("port", i)], runs[("jax", i)]
    assert set(mine["phases"]) == set(ref["phases"])
    order = ["proc_start", "imports_done", "state_init_done",
             "compile_done", "first_step_done"]
    assert [mine["phases"][k] for k in order] == sorted(
        mine["phases"][k] for k in order)
    assert mine["phases"]["depot_outcome"] == "eager"
    assert ref["phases"]["depot_outcome"] == "no_depot"
    assert mine["phases"]["depot_hit"] == ref["phases"]["depot_hit"] == 0.0
    assert [s["name"] for s in mine["spans"]] == [
        s["name"] for s in ref["spans"]] == ["trial.load", "trial.step"]
    for a, b in zip(mine["spans"], ref["spans"]):
        assert set(a) == set(b) and a["t0"] <= a["t1"]
        assert {k: v for k, v in a["attrs"].items()
                if k != "depot_outcome"} == {
            k: v for k, v in b["attrs"].items() if k != "depot_outcome"}
    assert mine["spans"][0]["attrs"]["depot_outcome"] == "eager"
    f, g = mine["fields"], ref["fields"]
    assert list(f) == list(g)
    for k in ("lr", "wd", "width", "depth", "steps"):
        assert f[k] == g[k], k
    np.testing.assert_allclose(float(f["loss"]), float(g["loss"]),
                               rtol=rtol(TRIALS[i], int(f["steps"]) - 1),
                               atol=0)
    assert float(f["loss"]) == runs[("port", i)]["metrics"][-1]["raw_loss"]


def test_program_key_shared_across_scalars_forked_by_structure():
    """The reference's shared-compile contract (tests/test_swarm.py):
    trials differing only in ``lr``/``wd`` share the program, a change
    of width or depth forks its key. The scalars are the step's 0-d
    inputs, written in place: the step's tensors stay the same."""
    assert tw.program_key(8, 2) == tw.program_key(8, 2)
    assert tw.program_key(8, 2) != tw.program_key(16, 2)
    assert tw.program_key(8, 2) != tw.program_key(8, 4)
    step = tw.TrialStep(8, 2, torch.device("cpu"))
    ptrs = {k: t.data_ptr() for k, t in step.tensors().items()}
    losses = {}
    for lr, wd in ((0.1, 0.0), (0.01, 0.001)):
        step.w.fill_(1.0)
        step.set_scalars(lr, wd)
        losses[lr] = [step.step() for _ in range(3)]
        assert {k: t.data_ptr() for k, t in step.tensors().items()} == ptrs
    assert losses[0.1][0] == losses[0.01][0] == 8.0
    np.testing.assert_allclose(losses[0.1], [8.0 * 0.9 ** (2 * k)
                                             for k in range(3)], rtol=1e-6)
    assert step.captures == 0 and step.graph is None      # eager on the CPU


def test_capture_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        tw.TrialStep(8, 2, torch.device("cpu")).capture()


def test_trial_pod_on_local_process_cluster(tmp_path):
    """One port trial pod as a job on the reference's controller: the
    job succeeds, the port's ``objective_from_metrics`` reads the trial's
    objective (the last, lowest normalized loss), and the operator's
    ``build_job_trace`` renders the pod's phases and its posted spans."""
    lr, wd, steps = 0.2, 0.01, 5
    env = {"PYTHONPATH": REPO + ":" + os.environ.get("PYTHONPATH", ""),
           "KFT_FORCE_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
           "KFT_TRIAL_LR": str(lr), "KFT_TRIAL_WD": str(wd),
           "KFT_TRAIN_STEPS": str(steps),
           "KFT_METRICS_PATH": str(tmp_path / "metrics.jsonl"),
           "KFT_PHASES_PATH": str(tmp_path / "phases")}
    cluster = LocalProcessCluster(log_dir=str(tmp_path / "pods"))
    client = TrainingClient(JobController(cluster))
    try:
        job = client.create_jax_job("torch-trial", workers=1,
                                    command=PORT_CMD, env=env)
        done = client.wait_for_job_conditions("torch-trial",
                                              timeout=TIMEOUT)
        log = client.get_job_logs("torch-trial", index=0)
        assert done.status.condition() == ConditionType.SUCCEEDED, log
        assert "trial done: lr=0.2 wd=0.01 width=8 depth=2 steps=5" in log
    finally:
        cluster.shutdown()
    objective = objective_from_metrics(
        read_metrics(str(tmp_path / "metrics.jsonl")), "loss")
    np.testing.assert_allclose(objective, (1 - lr - wd) ** (2 * (steps - 1)),
                               rtol=1e-5)
    with open(tmp_path / "phases.0") as f:
        phases = json.load(f)
    with open(tmp_path / "phases.spans.0") as f:
        posted = json.load(f)
    trace = build_job_trace(job.namespace, "torch-trial", job.uid or "u",
                            {"torch-trial-0": phases},
                            worker_spans={"torch-trial-0": posted})
    names = [s["name"] for s in trace]
    assert names[0] == "job:torch-trial"
    for seg in ("worker:torch-trial-0", "worker.imports", "worker.compile",
                "worker.first_step"):
        assert seg in names, names
    pod = next(s for s in trace if s["name"] == "worker:torch-trial-0")
    assert pod["attrs"]["depot_outcome"] == "eager"
    assert pod["t0"] == phases["proc_start"]
    assert pod["t1"] == phases["first_step_done"]

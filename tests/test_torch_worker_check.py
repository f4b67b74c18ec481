"""The PyTorch port's training pod (``kubeflow_tpu_torch.rendezvous``)
against the JAX package's on the CPU: its env parsing agrees with the
reference's, its phase stamps travel both transports, and
``python -m kubeflow_tpu_torch.rendezvous.worker_check`` runs as the pods
of a ``JAXJob`` and a ``PyTorchJob`` that the reference's controller
starts on ``LocalProcessCluster`` (one and two processes over gloo).
With ``KFT_TRAIN_STEPS`` and ``KFT_CHECKPOINT_*`` a pod SIGKILLed after
its step-2 checkpoint and started again resumes, and its losses from the
resume on are bitwise those of an uninterrupted pod (both eager on the
CPU, one thread each). Two processes with ``KFT_TRAIN_STEPS`` train over
the world (``KFT_MESH=data=2``, or the default fsdp) with the losses of
the JAX ``Trainer`` on the same global batches (1e-5 relative: float32
sums over the two processes' partial sums in another order than
XLA's). Every subprocess has its own timeout."""

import http.server
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from kubeflow_tpu.api.types import (
    ConditionType, RunPolicy, pytorch_job,
)
from kubeflow_tpu.client import TrainingClient
from kubeflow_tpu.controller import JobController, LocalProcessCluster
from kubeflow_tpu.rendezvous import bootstrap as j_boot
from kubeflow_tpu.training.metrics import read_metrics
from kubeflow_tpu_torch.rendezvous import bootstrap as t_boot
from kubeflow_tpu_torch.rendezvous import worker_check as t_wc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_CMD = [sys.executable, "-m",
              "kubeflow_tpu_torch.rendezvous.worker_check"]
POD_TIMEOUT = 120           # seconds a job or a pod process may take


# ------------------------------------------------------------ env parsing --

ENVS = [
    {},
    {"KFT_COORDINATOR": "w-0.ns.svc:8476", "KFT_NUM_PROCESSES": "4",
     "KFT_PROCESS_ID": "3", "KFT_JOB_NAME": "j"},
    {"KFT_NUM_PROCESSES": "2", "KFT_PROCESS_ID": "1",
     "MASTER_ADDR": "ignored", "MASTER_PORT": "1"},
]


@pytest.mark.parametrize("env", ENVS)
def test_world_from_env_agrees_with_the_reference(env):
    assert t_boot.world_from_env(env) == t_boot.WorldInfo(
        **vars(j_boot.world_from_env(env)))


def test_load_downward_env_agrees_with_the_reference(tmp_path):
    path = tmp_path / "annotations"
    path.write_text(
        'kubeflow-tpu.org/env.KFT_COORDINATOR="10.0.0.7:8476"\n'
        'kubeflow-tpu.org/env.KFT_PROCESS_ID="2"\n'
        'kubeflow-tpu.org/env.KFT_QUOTED="a \\"b\\" c\\\\d"\n'
        'other.org/label="x"\n'
        'no-equals-sign\n')
    env = {"KFT_PROCESS_ID": "5", "KEEP": "1"}
    ours = t_boot.load_downward_env(str(path), env)
    assert ours == j_boot.load_downward_env(str(path), env)
    assert ours["KFT_PROCESS_ID"] == "5"          # direct env wins
    assert ours["KFT_QUOTED"] == 'a "b" c\\d'
    assert t_boot.load_downward_env(str(tmp_path / "none"), env) == env


def test_pytorchjob_env_is_read():
    """The env the reference's controller stamps on a PyTorchJob's pods
    (Master first): each pod reads the same coordinator, the world size
    and its rank."""
    from kubeflow_tpu.controller.cluster import FakeCluster

    ctl = JobController(FakeCluster())
    job = ctl.submit(pytorch_job("pt", workers=2))
    ctl.reconcile("default", "pt")
    worlds = [t_boot.world_from_env(ctl.cluster_env(job, rt, i))
              for rt, i in (("Master", 0), ("Worker", 0), ("Worker", 1))]
    assert [w.process_id for w in worlds] == [0, 1, 2]
    assert {w.num_processes for w in worlds} == {3}
    env = ctl.cluster_env(job, "Master", 0)
    assert {w.coordinator for w in worlds} == {
        f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"}
    assert worlds[0].is_coordinator and not worlds[1].is_coordinator


@pytest.mark.parametrize("mesh,dcn,n", [
    ("", "", 1), ("", "", 4), ("data=2", "", 2), ("data=2,fsdp=2", "", 4),
    ("fsdp=2", "data=2", 4), ("data=4", "", 8), ("data=1,tensor=1", "", 1),
])
def test_world_layout_agrees_with_the_reference_mesh(mesh, dcn, n):
    """One device a process: the port's layout of ``KFT_MESH`` /
    ``KFT_DCN`` over N processes has the axis sizes the reference's
    ``mesh_from_topology_env`` gives over N devices."""
    import jax

    from kubeflow_tpu.parallel.mesh import mesh_from_topology_env

    env = {"KFT_MESH": mesh, "KFT_DCN": dcn}
    ref = dict(mesh_from_topology_env(env, devices=jax.devices()[:n]).shape)
    ours = t_boot.world_layout(env, n)
    assert ours["data"] * ours["dcn_data"] == ref["data"]
    assert ours["fsdp"] * ours["dcn_fsdp"] == ref["fsdp"]
    assert all(v == 1 for k, v in ref.items() if k not in ("data", "fsdp"))


def test_world_layout_refuses_what_is_not_ported():
    """What is not ported raises (a DCN axis other than data and fsdp,
    sizes that do not make the world, an unknown axis); ``expert`` beside
    ``context`` is ported and lays out as the reference's mesh does."""
    import jax

    from kubeflow_tpu.parallel.mesh import mesh_from_topology_env

    env = {"KFT_MESH": "expert=2,context=2"}
    ref = dict(mesh_from_topology_env(env, devices=jax.devices()[:4]).shape)
    ours = t_boot.world_layout(env, 4)
    for axis in ("data", "fsdp", "expert", "context", "tensor"):
        assert ours[axis] == ref[axis], axis
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        t_boot.world_layout({"KFT_MESH": "pipeline=2",
                             "KFT_DCN": "pipeline=2"}, 4)
    with pytest.raises(ValueError, match="one device each"):
        t_boot.world_layout({"KFT_MESH": "data=2,fsdp=2"}, 2)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        t_boot.world_layout({"KFT_MESH": "bogus=2"}, 2)


def test_initialize_and_wait_for_workers_on_the_cpu():
    """One CPU process: no process group, and the world's size needs
    none; a world of two without a group raises."""
    import torch

    world, dev = t_boot.initialize({"KFT_FORCE_PLATFORM": "cpu",
                                    "KFT_MESH": "data=1"})
    assert dev == torch.device("cpu") and world.num_processes == 1
    assert not torch.distributed.is_initialized()
    t_boot.wait_for_workers(world)
    with pytest.raises(RuntimeError, match="initialize"):
        t_boot.wait_for_workers(t_boot.WorldInfo("h:1", 2, 0))


# ---------------------------------------------------------------- phases --

def test_phase_file_transport(tmp_path, monkeypatch):
    """An atomic JSON file ``{path}.{process}``; each extra key in its own
    ``{path}.{key}.{process}``; no temporary file left behind."""
    path = str(tmp_path / "phases")
    monkeypatch.setenv("KFT_PHASES_PATH", path)
    monkeypatch.setenv("KFT_PROCESS_ID", "3")
    phases: dict = {}
    t_wc._phase(phases, "proc_start")
    t_wc._phase(phases, "compile_done", extra={"depot": {"compiles": 1}},
                at=12.5)
    assert json.load(open(f"{path}.3")) == phases
    assert phases["compile_done"] == 12.5
    assert json.load(open(f"{path}.depot.3")) == {"compiles": 1}
    assert sorted(os.listdir(tmp_path)) == ["phases.3", "phases.depot.3"]


def test_phase_http_transport(monkeypatch):
    """A POST of ``{"phases": ..., **extra}`` per stamp to a local server;
    a dead endpoint is swallowed."""
    got = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            got.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        monkeypatch.setenv("KFT_PHASES_PATH",
                           f"http://127.0.0.1:{srv.server_port}/hb")
        phases: dict = {}
        t_wc._phase(phases, "proc_start")
        t_wc._phase(phases, "compile_done", extra={"depot": {"compiles": 1}})
    finally:
        srv.shutdown()
        srv.server_close()
    assert [set(g) for g in got] == [{"phases"}, {"phases", "depot"}]
    assert got[1]["phases"] == phases and got[1]["depot"] == {"compiles": 1}
    monkeypatch.setenv("KFT_PHASES_PATH", f"http://127.0.0.1:{srv.server_port}")
    t_wc._phase({}, "after_shutdown")               # no raise


# ------------------------------------------------------------------ pods --

def _env(tmp_path, **extra):
    return {"PYTHONPATH": REPO + ":" + os.environ.get("PYTHONPATH", ""),
            "KFT_FORCE_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
            "KFT_METRICS_PATH": str(tmp_path / "metrics.jsonl"), **extra}


@pytest.fixture()
def client(tmp_path):
    cluster = LocalProcessCluster(log_dir=str(tmp_path / "pods"))
    yield TrainingClient(JobController(cluster))
    cluster.shutdown()


@pytest.mark.parametrize("workers", [1, 2])
def test_jaxjob_world(client, tmp_path, workers):
    """The port's pod under a JAXJob: the world forms (gloo for two),
    every process's all-reduce total is 4 * sum(range(N)), and
    ``world_ok`` arrives through the metrics file."""
    client.create_jax_job("torch-world", workers=workers,
                          command=WORKER_CMD, mesh={"data": workers},
                          env=_env(tmp_path))
    done = client.wait_for_job_conditions("torch-world",
                                          timeout=POD_TIMEOUT)
    logs = [client.get_job_logs("torch-world", index=i)
            for i in range(workers)]
    assert done.status.condition() == ConditionType.SUCCEEDED, logs
    total = float(4 * sum(range(workers)))
    for i, log in enumerate(logs):
        assert f"worker {i}/{workers}: world ok, devices={workers}, " \
               f"collective={total}" in log, log
    recs = read_metrics(str(tmp_path / "metrics.jsonl"))
    assert sorted(r["process_id"] for r in recs
                  if r.get("world_ok") == 1.0) == list(range(workers))
    assert {r["total"] for r in recs} == {total}


def test_pytorchjob_world(tmp_path):
    """The same pod under a PyTorchJob (a Master and one Worker): the
    MASTER_ADDR / WORLD_SIZE / RANK contract forms the world."""
    cluster = LocalProcessCluster(log_dir=str(tmp_path / "pods"))
    client = TrainingClient(JobController(cluster))
    try:
        client.create_job(pytorch_job("torch-pt", workers=1,
                                      command=WORKER_CMD,
                                      env=_env(tmp_path)))
        done = client.wait_for_job_conditions("torch-pt",
                                              timeout=POD_TIMEOUT)
        logs = client.get_job_logs("torch-pt", replica_type="Master")
        assert done.status.condition() == ConditionType.SUCCEEDED, logs
        assert "worker 0/2: world ok, devices=2, collective=4.0" in logs
    finally:
        cluster.shutdown()


POD_STEPS = 3


def _jax_pod_losses(data: int, fsdp: int) -> list:
    """The reference pod's training (``worker_check``: llama_tiny f32,
    adamw, lr 1e-3, warmup 2, global batch max(2N, 4) x 16) in the JAX
    ``Trainer`` over ``data`` x ``fsdp`` host devices, from the port
    pod's own initial parameters, fed the global batches: every process's
    rows of ``synthetic_lm_batches`` (seeded by ``[0, step, process]``)
    concatenated. Its losses, step by step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from kubeflow_tpu.models import llama as jl
    from kubeflow_tpu.parallel import MeshConfig, build_mesh
    from kubeflow_tpu.training import data as j_data
    from kubeflow_tpu.training import trainer as j_trainer
    from kubeflow_tpu_torch.models import llama as tl
    from kubeflow_tpu_torch.training import optim

    n = data * fsdp
    host = optim.tree_map(lambda t: t.numpy(), tl.init_params(
        torch.Generator().manual_seed(0),
        tl.llama_tiny(dtype=torch.float32), device="cpu"))
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    mesh = build_mesh(MeshConfig(data=data, fsdp=fsdp),
                      devices=jax.devices()[:n])
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jax.tree_util.tree_map(
            jnp.asarray, host),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(jl.forward, jcfg),
        config=j_trainer.TrainerConfig(learning_rate=1e-3, warmup_steps=2,
                                       total_steps=max(POD_STEPS, 3)))
    jt.init_state(jax.random.key(0))
    local = max(2 * n, 4) // n
    losses = []
    for step in range(POD_STEPS):
        rows = [np.random.default_rng([0, step, p]).integers(
            0, jcfg.vocab_size, (local, 17), dtype=np.int32)
            for p in range(n)]
        m = jt.train_step(j_data.put_batch(
            mesh, {"tokens": np.concatenate(rows)}))
        losses.append(float(m["loss"]))
    return losses


def _assert_pod_trained_like_jax(tmp_path, logs, data, fsdp):
    recs = read_metrics(str(tmp_path / "metrics.jsonl"))
    got = {r["step"]: r["loss"] for r in recs if "loss" in r}
    assert sorted(got) == list(range(1, POD_STEPS + 1)), (recs, logs)
    # the coordinator alone writes the training metrics: one record a
    # step, and the final one
    assert sum("loss" in r for r in recs) == POD_STEPS + 1, recs
    want = _jax_pod_losses(data, fsdp)
    import numpy as np

    np.testing.assert_allclose([got[s] for s in range(1, POD_STEPS + 1)],
                               want, rtol=1e-5)


def test_two_process_jaxjob_trains_like_the_jax_trainer(client, tmp_path):
    """A 2-process JAXJob pod with ``KFT_MESH=data=2`` and
    ``KFT_TRAIN_STEPS``: both processes train over the world, each
    feeding its own rows, and the coordinator's losses are the JAX
    ``Trainer``'s on MeshConfig(data=2) fed the same global batches."""
    client.create_jax_job("torch-train2", workers=2, command=WORKER_CMD,
                          mesh={"data": 2},
                          env=_env(tmp_path,
                                   KFT_TRAIN_STEPS=str(POD_STEPS)),
                          run_policy=RunPolicy(backoff_limit=0))
    done = client.wait_for_job_conditions("torch-train2",
                                          timeout=POD_TIMEOUT)
    logs = [client.get_job_logs("torch-train2", index=i) for i in range(2)]
    assert done.status.condition() == ConditionType.SUCCEEDED, logs
    for i, log in enumerate(logs):
        assert f"worker {i}: trained to step {POD_STEPS}" in log, log
        assert "mesh={'data': 2, 'fsdp': 1}, backend=gloo" in log, log
    _assert_pod_trained_like_jax(tmp_path, logs, 2, 1)


def test_two_process_pytorchjob_trains_like_the_jax_trainer(tmp_path):
    """The same under a PyTorchJob's env (a Master and one Worker;
    ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK``) and no ``KFT_MESH``: the
    world's default puts both processes on fsdp, as the JAX mesh's
    default does, and the losses are the JAX ``Trainer``'s on
    MeshConfig(fsdp=2)."""
    cluster = LocalProcessCluster(log_dir=str(tmp_path / "pods"))
    client = TrainingClient(JobController(cluster))
    try:
        client.create_job(pytorch_job(
            "torch-pt-train", workers=1, command=WORKER_CMD,
            env=_env(tmp_path, KFT_TRAIN_STEPS=str(POD_STEPS))))
        done = client.wait_for_job_conditions("torch-pt-train",
                                              timeout=POD_TIMEOUT)
        logs = [client.get_job_logs("torch-pt-train", replica_type=rt)
                for rt in ("Master", "Worker")]
        assert done.status.condition() == ConditionType.SUCCEEDED, logs
        assert "mesh={'data': 1, 'fsdp': 2}, backend=gloo" in logs[0], logs
    finally:
        cluster.shutdown()
    _assert_pod_trained_like_jax(tmp_path, logs, 1, 2)


def test_two_process_pod_under_context_trains_like_the_jax_trainer(
        client, tmp_path):
    """A 2-process JAXJob pod with ``KFT_MESH=context=2`` and
    ``KFT_TRAIN_STEPS``: both processes feed the same rows, each its
    chunk of their tokens, through ring attention
    (``worker_check.pod_config``), and the coordinator's losses are the
    JAX ``Trainer``'s on MeshConfig(context=2) fed those rows, its loss
    the forward with ``mesh=`` (1e-5 relative, as above)."""
    import dataclasses
    import functools
    import types

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from kubeflow_tpu.models import llama as jl
    from kubeflow_tpu.parallel import MeshConfig, build_mesh
    from kubeflow_tpu.training import data as j_data
    from kubeflow_tpu.training import trainer as j_trainer
    from kubeflow_tpu_torch.models import llama as tl
    from kubeflow_tpu_torch.training import optim

    client.create_jax_job("torch-context2", workers=2, command=WORKER_CMD,
                          mesh={"context": 2},
                          env=_env(tmp_path,
                                   KFT_TRAIN_STEPS=str(POD_STEPS)),
                          run_policy=RunPolicy(backoff_limit=0))
    done = client.wait_for_job_conditions("torch-context2",
                                          timeout=POD_TIMEOUT)
    logs = [client.get_job_logs("torch-context2", index=i) for i in range(2)]
    assert done.status.condition() == ConditionType.SUCCEEDED, logs
    for i, log in enumerate(logs):
        assert f"worker {i}: trained to step {POD_STEPS}" in log, log
        assert "mesh={'data': 1, 'fsdp': 1, 'context': 2}, backend=gloo" \
            in log, log
    recs = read_metrics(str(tmp_path / "metrics.jsonl"))
    got = {r["step"]: r["loss"] for r in recs if "loss" in r}
    assert sorted(got) == list(range(1, POD_STEPS + 1)), recs

    cfg = t_wc.pod_config(types.SimpleNamespace(context=2))
    assert cfg.attn_impl == "ring" and cfg.head_dim == 64
    host = optim.tree_map(lambda t: t.numpy(), tl.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    jcfg = dataclasses.replace(jl.llama_tiny(dtype=jnp.float32), dim=cfg.dim,
                               n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, attn_impl="ring")
    mesh = build_mesh(MeshConfig(data=1, fsdp=1, context=2, tensor=1),
                      devices=jax.devices()[:2])
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jax.tree_util.tree_map(
            jnp.asarray, host),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(
            functools.partial(jl.forward, mesh=mesh), jcfg),
        config=j_trainer.TrainerConfig(learning_rate=1e-3, warmup_steps=2,
                                       total_steps=max(POD_STEPS, 3)))
    jt.init_state(jax.random.key(0))
    want = []
    for step in range(POD_STEPS):
        rows = np.random.default_rng([0, step, 0]).integers(
            0, jcfg.vocab_size, (4, 17), dtype=np.int32)
        want.append(float(jt.train_step(j_data.put_batch(
            mesh, {"tokens": rows}))["loss"]))
    np.testing.assert_allclose([got[s] for s in range(1, POD_STEPS + 1)],
                               want, rtol=1e-5)


def test_four_process_moe_pod_under_expert_and_context_trains_like_jax(
        client, tmp_path):
    """A 4-process JAXJob pod with ``KFT_MESH=expert=2,context=2`` and
    ``KFT_TRAIN_EXPERTS=4``: the pod's model is MoE (4 experts, top-2),
    its experts cut over ``expert``, every process feeds the same rows,
    each context rank its chunk of their tokens through ring attention,
    and the coordinator's losses are the JAX ``Trainer``'s on
    MeshConfig(expert=2, context=2) fed those rows, its loss the forward
    with ``mesh=`` (1e-5 relative, as above)."""
    import dataclasses
    import functools
    import types

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from kubeflow_tpu.models import llama as jl
    from kubeflow_tpu.parallel import MeshConfig, build_mesh
    from kubeflow_tpu.training import data as j_data
    from kubeflow_tpu.training import trainer as j_trainer
    from kubeflow_tpu_torch.models import llama as tl
    from kubeflow_tpu_torch.training import optim

    client.create_jax_job("torch-moe-ctx", workers=4, command=WORKER_CMD,
                          mesh={"expert": 2, "context": 2},
                          env=_env(tmp_path, KFT_TRAIN_EXPERTS="4",
                                   KFT_TRAIN_STEPS=str(POD_STEPS)),
                          run_policy=RunPolicy(backoff_limit=0))
    done = client.wait_for_job_conditions("torch-moe-ctx",
                                          timeout=POD_TIMEOUT)
    logs = [client.get_job_logs("torch-moe-ctx", index=i) for i in range(4)]
    assert done.status.condition() == ConditionType.SUCCEEDED, logs
    for i, log in enumerate(logs):
        assert f"worker {i}: trained to step {POD_STEPS}" in log, log
        assert ("mesh={'data': 1, 'fsdp': 1, 'expert': 2, 'context': 2}, "
                "backend=gloo") in log, log
    recs = read_metrics(str(tmp_path / "metrics.jsonl"))
    got = {r["step"]: r["loss"] for r in recs if "loss" in r}
    assert sorted(got) == list(range(1, POD_STEPS + 1)), recs

    cfg = t_wc.pod_config(types.SimpleNamespace(context=2), 4)
    assert cfg.n_experts == 4 and cfg.attn_impl == "ring"
    host = optim.tree_map(lambda t: t.numpy(), tl.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    jcfg = dataclasses.replace(
        jl.llama_tiny(dtype=jnp.float32, n_experts=4), dim=cfg.dim,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, attn_impl="ring")
    mesh = build_mesh(MeshConfig(data=1, fsdp=1, expert=2, context=2,
                                 tensor=1), devices=jax.devices()[:4])
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jax.tree_util.tree_map(
            jnp.asarray, host),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(
            functools.partial(jl.forward, mesh=mesh), jcfg),
        config=j_trainer.TrainerConfig(learning_rate=1e-3, warmup_steps=2,
                                       total_steps=max(POD_STEPS, 3)))
    jt.init_state(jax.random.key(0))
    want = []
    for step in range(POD_STEPS):
        rows = np.random.default_rng([0, step, 0]).integers(
            0, jcfg.vocab_size, (8, 17), dtype=np.int32)
        want.append(float(jt.train_step(j_data.put_batch(
            mesh, {"tokens": rows}))["loss"]))
    np.testing.assert_allclose([got[s] for s in range(1, POD_STEPS + 1)],
                               want, rtol=1e-5)


def _pod(tmp_path, tag, extra):
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    env = {**os.environ, **_env(d), "KFT_TRAIN_STEPS": "6",
           "KFT_CHECKPOINT_EVERY": "2", "KFT_DEPOT": str(tmp_path / "depot"),
           "KFT_PHASES_PATH": str(d / "phases"),
           "KFT_HEARTBEAT_FILE": str(d / "heartbeat"), **extra}
    return subprocess.Popen(WORKER_CMD, env=env, cwd=str(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _losses(path) -> dict:
    return {r["step"]: r["loss"] for r in read_metrics(str(path))
            if "loss" in r}


def test_killed_pod_resumes_bitwise(tmp_path):
    """tests/test_dataset.py's kill-and-resume, on the port's pod: an
    uninterrupted pod, and one paced by KFT_STEP_SLEEP, SIGKILLed once
    its step-2 checkpoint exists and started again with the same env.
    The restart stamps ``resumed_from_step`` and ``restore_done``, its
    losses from the resume on equal the uninterrupted pod's bitwise, and
    on the CPU the outcome is "eager" with nothing counted on the
    depot, which is never touched."""
    ref = _pod(tmp_path, "ref", {"KFT_CHECKPOINT_DIR":
                                 str(tmp_path / "ref" / "ckpt")})
    out, err = ref.communicate(timeout=POD_TIMEOUT)
    assert ref.returncode == 0, err[-3000:]
    assert "trained to step 6 (resumed_from=None, depot=eager" in out

    ckpt = tmp_path / "victim" / "ckpt"
    victim = _pod(tmp_path, "victim", {"KFT_CHECKPOINT_DIR": str(ckpt),
                                       "KFT_STEP_SLEEP": "0.5"})
    deadline = time.time() + POD_TIMEOUT
    while not (ckpt / "2").is_dir():
        assert victim.poll() is None and time.time() < deadline, \
            victim.communicate()[1][-3000:]
        time.sleep(0.02)
    victim.send_signal(signal.SIGKILL)
    victim.communicate(timeout=POD_TIMEOUT)
    assert victim.returncode == -signal.SIGKILL
    killed_at = max(_losses(tmp_path / "victim" / "metrics.jsonl"))
    assert killed_at < 6

    restart = _pod(tmp_path, "victim", {"KFT_CHECKPOINT_DIR": str(ckpt)})
    out, err = restart.communicate(timeout=POD_TIMEOUT)
    assert restart.returncode == 0, err[-3000:]
    phases = json.load(open(tmp_path / "victim" / "phases.0"))
    resumed = int(phases["resumed_from_step"])
    assert 2 <= resumed <= killed_at
    assert f"trained to step 6 (resumed_from={resumed}, depot=eager" in out
    for stamp in ("proc_start", "imports_done", "rendezvous_done",
                  "state_init_done", "restore_done", "compile_done",
                  "first_step_done"):
        assert phases[stamp] > 0, stamp
    assert phases["depot_hit"] == 0.0
    assert json.load(open(tmp_path / "victim" / "phases.depot.0")) == {}
    assert not (tmp_path / "depot").exists()
    assert open(tmp_path / "victim" / "heartbeat").read() == "6"

    want = _losses(tmp_path / "ref" / "metrics.jsonl")
    got = {s: v for s, v in _losses(tmp_path / "victim" / "metrics.jsonl"
                                    ).items()}
    # the restart's records are the last ones for each step it trained
    assert {s: got[s] for s in range(resumed + 1, 7)} == \
        {s: want[s] for s in range(resumed + 1, 7)}
    assert sorted(os.listdir(ckpt)) == ["2", "4", "6"]

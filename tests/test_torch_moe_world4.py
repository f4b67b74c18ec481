"""Mixture-of-Experts over a world of four processes, and the pod under
``KFT_MESH=expert=2``, against the JAX package on the CPU (the method,
the helpers and the tolerances of tests/test_torch_moe_world.py, which
holds the world of two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.api.types import ConditionType, RunPolicy
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.training import data as j_data
from kubeflow_tpu.training import trainer as j_trainer
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.tools import world_train as wt
from kubeflow_tpu_torch.training import optim
from test_torch_flash_attention import warm_up_cpu_exp
from test_torch_moe_world import (
    _check_case, _check_layer, _jax_mesh, _job, _layer_plan, _plans,
)
from test_torch_world_training import RTOL

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

# (case, data, fsdp, tensor, expert, remat, TrainerConfig fields)
CASES_4 = [
    ("data-expert-full-adafactor", 2, 1, 1, 2, "full",
     dict(optimizer="adafactor", grad_accum=1)),
    ("fsdp-tensor-none-adamw", 1, 2, 2, 1, "none",
     dict(optimizer="adamw", grad_accum=1)),
]


# the layer's layouts over four processes
LAYOUTS_4 = {"data=2,expert=2": (2, 1, 1, 2),
             "fsdp=2,tensor=2": (1, 2, 2, 1), "data=4": (4, 1, 1, 1),
             "expert=2,tensor=2": (1, 1, 2, 2), "expert=4": (1, 1, 1, 4)}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One world of four processes: the layer under each of LAYOUTS_4,
    and every case of CASES_4."""
    root = tmp_path_factory.mktemp("moe4")
    jobs = [_job(c) for c in CASES_4]
    plans = [_layer_plan(*sizes) for sizes in LAYOUTS_4.values()] \
        + _plans(CASES_4, jobs)
    results = wt.run(wt.plans_rank, (plans,), 1, 4, ["cpu"] * 4,
                     str(root / "world"))
    return jobs, results


@pytest.mark.parametrize("layout", list(LAYOUTS_4))
def test_layer_over_four_ranks_matches_jax(four_ranks, layout):
    """The same over four ranks: batch ranks with expert or tensor peers,
    four batch ranks (three ranks ahead of the last in the slots),
    expert and tensor peers together, and one expert a rank."""
    ranks = [r[list(LAYOUTS_4).index(layout)] for r in four_ranks[-1]]
    _check_layer(ranks)


@pytest.mark.parametrize("case", range(len(CASES_4)),
                         ids=[c[0] for c in CASES_4])
def test_moe_trainer_over_four_ranks_matches_jax(four_ranks, case):
    """data=2 x expert=2 and fsdp=2 x tensor=2 (ZeRO-3 of each rank's
    expert slices): the same against the JAX trainer on the same mesh."""
    jobs, results = four_ranks
    _check_case(CASES_4[case], jobs[case],
                [r[len(LAYOUTS_4) + case] for r in results])


# ------------------------------------------------------------------ pod --

def test_two_process_pod_under_expert_trains_like_the_jax_trainer(tmp_path):
    """The port's pod (``worker_check``) as a 2-process JAXJob with
    ``KFT_MESH=expert=2``: its model is dense, so the axis replicates it
    (as in the reference); both processes feed the same rows, and the
    coordinator's losses are the JAX ``Trainer``'s on MeshConfig(expert=2)
    fed them."""
    from kubeflow_tpu.client import TrainingClient
    from kubeflow_tpu.controller import JobController, LocalProcessCluster
    from kubeflow_tpu.training.metrics import read_metrics
    from test_torch_worker_check import POD_STEPS, POD_TIMEOUT, WORKER_CMD
    from test_torch_worker_check import _env

    cluster = LocalProcessCluster(log_dir=str(tmp_path / "pods"))
    client = TrainingClient(JobController(cluster))
    try:
        client.create_jax_job("torch-expert2", workers=2,
                              command=WORKER_CMD, mesh={"expert": 2},
                              env=_env(tmp_path,
                                       KFT_TRAIN_STEPS=str(POD_STEPS)),
                              run_policy=RunPolicy(backoff_limit=0))
        done = client.wait_for_job_conditions("torch-expert2",
                                              timeout=POD_TIMEOUT)
        logs = [client.get_job_logs("torch-expert2", index=i)
                for i in range(2)]
    finally:
        cluster.shutdown()
    assert done.status.condition() == ConditionType.SUCCEEDED, logs
    for i, log in enumerate(logs):
        assert f"worker {i}: trained to step {POD_STEPS}" in log, log
        assert "mesh={'data': 1, 'fsdp': 1, 'expert': 2}, backend=gloo" \
            in log, log
    recs = read_metrics(str(tmp_path / "metrics.jsonl"))
    got = {r["step"]: r["loss"] for r in recs if "loss" in r}
    assert sorted(got) == list(range(1, POD_STEPS + 1)), recs

    host = optim.tree_map(lambda t: t.numpy(), tl.init_params(
        torch.Generator().manual_seed(0),
        tl.llama_tiny(dtype=torch.float32), device="cpu"))
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    mesh = _jax_mesh(1, 1, 1, 2)
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jax.tree_util.tree_map(
            jnp.asarray, host),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(jl.forward, jcfg),
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
                               want, rtol=RTOL)

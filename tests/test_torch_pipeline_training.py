"""Training under the ``pipeline`` axis (GPipe over the world's ranks,
``parallel/pipeline.py``, and the pipelined Llama,
``parallel/pipeline_llama.py``), alone and beside ``data``, ``fsdp``,
``tensor`` and, for an MoE model, ``expert``, against the JAX package's
pipelined trainer on the same mesh, on the CPU, in float32, on the same
numpy-seeded rows.

The port's ranks are spawned as processes that talk over gloo
(``tools/world_train.run``): one world of two processes
(``pipeline=2``) and one of four (``pipeline=2`` beside each other
axis), each running all its cases one after another
(``world_train.plans_rank``). Pipeline peers feed the same rows; the
places in the batch axes feed rows whose loss masks' density differs.
The oracle is the JAX ``Trainer`` on ``build_mesh(MeshConfig(pipeline=2,
...))`` over conftest's host devices with
``init_pipeline_params`` / ``pipeline_param_logical_axes`` /
``pipeline_lm_loss_fn(microbatches=2)``, fed the global batch (micro
batch by micro batch, the world's grouping), from the same weights.
JAX side attention "xla", port side "pallas" (its plain path on the
CPU).

Tolerances, each with its reason:
- loss, ``tokens``, ``grad_norm`` and ``moe_aux`` per step: 1e-5
  relative (tests/test_torch_world_training.py's: float32 sums over
  the ranks' partial sums and the pipeline's micro batches, in another
  order than XLA's);
- final parameters: 2e-5 absolute (its reason);
- the optimizer on stage parts against the whole tree's update: 1e-6
  absolute (tests/test_torch_world_training.py's: the same float32
  updates, their sums over the stages in another order);
- the leaves outside the stages, on the pipeline ranks of one place,
  after every step, and checkpoints: BITWISE (the same bytes: the
  gradients' sum over the axis, and copies).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.api.types import ConditionType, RunPolicy
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.parallel import pipeline_llama as jpl
from kubeflow_tpu.training import data as j_data
from kubeflow_tpu.training import trainer as j_trainer
from kubeflow_tpu.training.metrics import read_metrics
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.rendezvous import worker_check as t_wc
from kubeflow_tpu_torch.tools import world_train as wt
from kubeflow_tpu_torch.training import (
    CheckpointManager, optim, restore_latest,
)
from test_torch_flash_attention import warm_up_cpu_exp
from test_torch_world_training import (
    OPT_ATOL, PARAM_ATOL, RTOL, STEPS, _flat,
)

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

# the pipeline's micro batches (of each trainer micro batch)
MICRO = 2
# the leaves outside the stages, whole on every pipeline rank
WHOLE = ("embed", "final_norm")
# the optimizer on stage parts: two stacked stage leaves (one factored)
# cut on their stage dim over pipeline, beside two whole leaves
OPT_STAGES = {"a": (2, 3, 128, 256), "b": (2, 200), "c": (256, 128),
              "d": (200,)}
OPT_PIPELINE = {"a": 0, "b": 0}


def _tiny(remat, **fields):
    return dataclasses.replace(jl.llama_tiny(dtype=jnp.float32, remat=remat),
                               **fields)


def _factored(remat, **fields):
    """dim 128 and mlp 256: the embedding and the MLP weights factor
    under adafactor (tests/test_torch_tensor_training.py's config)."""
    return jl.LlamaConfig(**{
        **dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
               n_kv_heads=2, mlp_dim=256, max_seq=64, rope_scaling=None,
               tie_embeddings=True, dtype=jnp.float32, remat=remat),
        **fields})


def _moe(remat):
    """The JAX package's pipelined MoE test config (4 experts, top 2,
    capacity 4.0)."""
    return _tiny(remat, n_experts=4, moe_top_k=2, moe_capacity_factor=4.0)


# (case, (data, fsdp, tensor, expert, context, pipeline), JAX config,
# TrainerConfig fields)
CASES_2 = [
    ("pipeline-none-adamw-accum2", (1, 1, 1, 1, 1, 2),
     lambda: _tiny("none"), dict(optimizer="adamw", grad_accum=2)),
    ("pipeline-moe-full-adamw", (1, 1, 1, 1, 1, 2), lambda: _moe("full"),
     dict(optimizer="adamw", grad_accum=1)),
]
CASES_4 = [
    ("pipeline-data-full-adafactor", (2, 1, 1, 1, 1, 2),
     lambda: _factored("full"), dict(optimizer="adafactor", grad_accum=1)),
    ("pipeline-fsdp-dots-adamw-accum2", (1, 2, 1, 1, 1, 2),
     lambda: _tiny("dots"), dict(optimizer="adamw", grad_accum=2)),
    ("pipeline-tensor-none-untied-adafactor", (1, 1, 2, 1, 1, 2),
     lambda: _factored("none", tie_embeddings=False),
     dict(optimizer="adafactor", grad_accum=1)),
    ("pipeline-expert-moe-dots-adamw", (1, 1, 1, 2, 1, 2),
     lambda: _moe("dots"), dict(optimizer="adamw", grad_accum=1)),
]


def _job(jcfg, trainer_kw, **fields):
    host = jax.device_get(jl.init_params(jax.random.key(0), jcfg))
    tcfg = interop.config_from_jax(jcfg)
    tcfg = tl.LlamaConfig(**{**tcfg.__dict__, "attn_impl": "pallas"})
    return wt.Job(tcfg, dict(warmup_steps=2, total_steps=10, **trainer_kw),
                  local_batch=4, seq=16, steps=STEPS, mask=True,
                  params=host, keep_params=True, microbatches=MICRO,
                  watch=WHOLE, **fields)


def _plain(stages: dict) -> dict:
    """A JAX pipelined tree's stages as the plain ``layers`` stack."""
    out = {k: v for k, v in stages.items() if k != "stages"}
    out["layers"] = {k: np.reshape(v, (-1,) + v.shape[2:])
                     for k, v in stages["stages"].items()}
    return out


def _jax_run(jcfg, trainer_kw, job, sizes):
    """The JAX pipelined trainer on the case's mesh over host devices,
    on the global batches: per-step metrics and the final parameters
    (plain)."""
    data, fsdp, tensor, expert, _, pipeline = sizes
    mesh = build_mesh(MeshConfig(pipeline=pipeline, data=data, fsdp=fsdp,
                                 tensor=tensor, expert=expert),
                      devices=jax.devices()[:math.prod(sizes)])
    jt = j_trainer.Trainer(
        mesh=mesh,
        init_params_fn=lambda rng: jpl.init_pipeline_params(rng, jcfg,
                                                            pipeline),
        params_logical_axes=jpl.pipeline_param_logical_axes(jcfg),
        loss_fn=jpl.pipeline_lm_loss_fn(jcfg, mesh, microbatches=MICRO),
        config=j_trainer.TrainerConfig(warmup_steps=2, total_steps=10,
                                       **trainer_kw))
    jt.init_state(jax.random.key(0))
    metrics = []
    for step in range(STEPS):
        m = jt.train_step(j_data.put_batch(mesh, wt.global_batch(
            job, data * fsdp, step, trainer_kw.get("grad_accum", 1))))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _plain(jax.device_get(jt.params))


def _plans(cases, jobs):
    return [(*sizes, wt.train_rank, (job,))
            for (_, sizes, _, _), job in zip(cases, jobs)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One world of two processes (``pipeline=2``): every case of
    CASES_2, ``fit`` with checkpoints, the checkpoint restored into
    pipeline=2, and the optimizer on stage parts."""
    root = tmp_path_factory.mktemp("pipeline2")
    jobs = [_job(cfg(), kw) for _, _, cfg, kw in CASES_2]
    fit_job = dataclasses.replace(jobs[0], steps=4)
    plans = _plans(CASES_2, jobs) + [
        (1, 1, 1, 1, 1, 2, wt.fit_rank, (fit_job, str(root / "ckpt"), 2)),
        (1, 1, 1, 1, 1, 2, wt.restore_rank,
         (fit_job, str(root / "ckpt" / "a"))),
        (1, 1, 1, 1, 1, 2, wt.optimizer_rank,
         (OPT_STAGES, {}, "adafactor", STEPS, 0, None, OPT_PIPELINE))]
    results = wt.run(wt.plans_rank, (plans,), 1, 1, ["cpu"] * 2,
                     str(root / "world"), pipeline=2)
    return jobs, fit_job, root, results


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One world of four processes: every case of CASES_4."""
    root = tmp_path_factory.mktemp("pipeline4")
    jobs = [_job(cfg(), kw) for _, _, cfg, kw in CASES_4]
    results = wt.run(wt.plans_rank, (_plans(CASES_4, jobs),), 1, 1,
                     ["cpu"] * 4, str(root / "world"), pipeline=4)
    return jobs, results


def _check_case(case, job, ranks):
    name, sizes, cfg, kw = case
    data, fsdp, tensor, expert, _, pipeline = sizes
    assert {r["backend"]["backend"] for r in ranks} == {"gloo"}
    assert {r["backend"]["pipeline"] for r in ranks} == {pipeline}
    metrics, params = _jax_run(cfg(), kw, job, sizes)
    keys = ("loss", "tokens", "grad_norm") + (
        ("moe_aux",) if job.config.n_experts else ())
    want = _flat(params)
    for r, res in enumerate(ranks):
        got = res["runs"]["eager"]["metrics"]
        for step, (a, b) in enumerate(zip(got, metrics)):
            for key in keys:
                np.testing.assert_allclose(
                    a[key], b[key], rtol=RTOL,
                    err_msg=f"{name} rank {r} step {step} {key}")
        flat = _flat(res["params"])
        assert flat.keys() == want.keys()
        for leaf, x in flat.items():
            np.testing.assert_allclose(x, want[leaf], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{name} rank {r} {leaf}")
    # pipeline peers (ranks r and r + n / pipeline) see the same metrics
    # and hold the same bytes of the leaves outside the stages after
    # every step
    inner = len(ranks) // pipeline
    for r in range(inner):
        peers = [ranks[r + p * inner]["runs"]["eager"]
                 for p in range(pipeline)]
        assert all(p["metrics"] == peers[0]["metrics"] for p in peers)
        for step in range(STEPS):
            for leaf in WHOLE:
                for p in peers:
                    assert torch.equal(p["watched"][step][leaf],
                                       peers[0]["watched"][step][leaf]), \
                        (name, r, step, leaf)
    # tokens counted once: the global batch's count
    places = data * fsdp
    counts = [int(wt.batch_for(job, 0, i)["mask"][:, 1:].sum())
              for i in range(places)]
    assert ranks[0]["runs"]["eager"]["metrics"][0]["tokens"] == sum(counts)


@pytest.mark.parametrize("case", range(len(CASES_2)),
                         ids=[c[0] for c in CASES_2])
def test_pipeline_world_matches_the_jax_trainer(two_ranks, case):
    """pipeline=2 (dense and MoE): losses, tokens, grad norms (and
    ``moe_aux``) on every rank and the whole parameters after three
    steps against the JAX pipelined trainer on MeshConfig(pipeline=2)
    fed the same rows; the leaves outside the stages bitwise equal on
    both stages after every step."""
    jobs, _, _, results = two_ranks
    _check_case(CASES_2[case], jobs[case], [r[case] for r in results])


@pytest.mark.parametrize("case", range(len(CASES_4)),
                         ids=[c[0] for c in CASES_4])
def test_pipeline_beside_other_axes_matches_the_jax_trainer(four_ranks,
                                                            case):
    """pipeline=2 beside data=2, fsdp=2 (ZeRO-3 of each stage), tensor=2
    and, for the MoE model, expert=2: the same against the JAX
    pipelined trainer on the same mesh."""
    jobs, results = four_ranks
    ranks = [r[case] for r in results]
    assert [r["backend"]["rank"] for r in ranks] == [0, 1, 2, 3]
    _check_case(CASES_4[case], jobs[case], ranks)


def test_pipeline_checkpoint_restores_bitwise_into_one_process(two_ranks):
    """pipeline=2: ``fit`` to step 4 with a checkpoint every 2 steps, and
    the same stopped at step 2 and resumed by a fresh pipeline=2
    trainer: the losses after the resume and the whole final state
    bitwise the uninterrupted run's. The uninterrupted run's step-4
    checkpoint (the plain ``layers`` stack, written by the coordinator)
    restores bitwise into ONE process (the plain model) and into
    pipeline=2 again."""
    _, job, root, results = two_ranks
    fit = [r[len(CASES_2)] for r in results]
    for r, res in enumerate(fit):
        a, c = res["a"], res["c"]
        assert c["resumed_from"] == 2 and a["resumed_from"] is None
        assert {s: c["losses"][s] for s in (3, 4)} == \
            {s: a["losses"][s] for s in (3, 4)}, r
        for k, t in a["state"].items():
            assert torch.equal(t, c["state"][k]), (r, k)
            assert torch.equal(t, fit[0]["a"]["state"][k]), (r, k)
    world = fit[0]["a"]["state"]
    assert any(k.startswith("params/layers/") for k in world)
    assert not any("stages" in k for k in world)
    one = wt.make_trainer(job, torch.device("cpu"))
    mgr = CheckpointManager(str(root / "ckpt" / "a"))
    assert restore_latest(one, mgr) == 4
    mgr.close()
    mine = optim.named_leaves({"params": one.params,
                               "opt_state": one.opt_state})
    assert mine.keys() == world.keys()
    for k, t in mine.items():
        assert torch.equal(t.detach(), world[k]), k
    for r in results:
        restored = r[len(CASES_2) + 1]
        assert restored["step"] == 4
        assert restored["state"].keys() == world.keys()
        for k, t in restored["state"].items():
            assert torch.equal(t, world[k]), k


# ------------------------------------------------------------------ pod --

def test_optimizer_on_stage_parts_gives_the_unsharded_update(two_ranks):
    """adafactor on each rank's stage of the leaves the ``pipeline`` axis
    cuts, beside whole leaves, the stages' statistics made to differ: the
    block rms of the update and of the parameters summed over
    ``pipeline``, so each rank applies its stage of the whole update."""
    results = [r[len(CASES_2) + 2] for r in two_ranks[-1]]
    for r, diffs in enumerate(results):
        assert max(diffs.values()) <= OPT_ATOL, (r, diffs)


def test_two_process_pod_under_pipeline_trains_like_the_jax_pod(tmp_path):
    """The port's pod (``worker_check``) as a 2-process JAXJob with
    ``KFT_MESH=pipeline=2`` and ``KFT_TRAIN_STEPS``: both processes feed
    the same rows, each its stage (one layer of llama_tiny), and the
    coordinator's losses are the JAX pod's (the JAX ``Trainer`` with the
    plain forward on MeshConfig(pipeline=2), fed those rows)."""
    from kubeflow_tpu.client import TrainingClient
    from kubeflow_tpu.controller import JobController, LocalProcessCluster
    from test_torch_worker_check import POD_STEPS, POD_TIMEOUT, WORKER_CMD
    from test_torch_worker_check import _env

    cluster = LocalProcessCluster(log_dir=str(tmp_path / "pods"))
    client = TrainingClient(JobController(cluster))
    try:
        client.create_jax_job("torch-pipeline2", workers=2,
                              command=WORKER_CMD, mesh={"pipeline": 2},
                              env=_env(tmp_path,
                                       KFT_TRAIN_STEPS=str(POD_STEPS)),
                              run_policy=RunPolicy(backoff_limit=0))
        done = client.wait_for_job_conditions("torch-pipeline2",
                                              timeout=POD_TIMEOUT)
        logs = [client.get_job_logs("torch-pipeline2", index=i)
                for i in range(2)]
    finally:
        cluster.shutdown()
    assert done.status.condition() == ConditionType.SUCCEEDED, logs
    for i, log in enumerate(logs):
        assert f"worker {i}: trained to step {POD_STEPS}" in log, log
        assert "mesh={'pipeline': 2, 'data': 1, 'fsdp': 1}, backend=gloo" \
            in log, log
    recs = read_metrics(str(tmp_path / "metrics.jsonl"))
    got = {r["step"]: r["loss"] for r in recs if "loss" in r}
    assert sorted(got) == list(range(1, POD_STEPS + 1)), recs

    host = optim.tree_map(lambda t: t.numpy(), tl.init_params(
        torch.Generator().manual_seed(0),
        tl.llama_tiny(dtype=torch.float32), device="cpu"))
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    mesh = build_mesh(MeshConfig(pipeline=2, data=1, fsdp=1),
                      devices=jax.devices()[:2])
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
                               want, rtol=1e-5)


def test_pipeline_beside_context_raises_the_jax_error():
    """``pipeline`` beside ``context``: the pipelined forward's blocks
    get no mesh in the JAX package, so its ring attention raises there;
    the port's raises the same error, and so does the pod's model
    (ring attention under ``context``) through the pipelined loss."""
    import types

    from kubeflow_tpu_torch.parallel import pipeline_llama as tpl

    jcfg = _tiny("none", attn_impl="ring")
    mesh = build_mesh(MeshConfig(pipeline=2, context=2, data=1, fsdp=1),
                      devices=jax.devices()[:4])
    params = jpl.init_pipeline_params(jax.random.key(0), jcfg, 2)
    tokens = jnp.zeros((4, 16), jnp.int32)
    with pytest.raises(ValueError) as want:
        with mesh:
            jax.jit(lambda p, t: jpl.pipeline_forward(
                p, t, jcfg, mesh, microbatches=2))(params, tokens)
    cfg = t_wc.pod_config(types.SimpleNamespace(context=2, pipeline=2))
    assert cfg.attn_impl == "ring"
    tree = tpl.to_pipeline_params(
        tl.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"),
        1)
    loss = functools.partial(tpl.pipeline_lm_loss_fn(cfg, microbatches=2),
                             tree)
    with pytest.raises(ValueError) as got:
        loss({"tokens": torch.zeros((4, 17), dtype=torch.long)})
    assert str(got.value) == str(want.value) == \
        "attn_impl='ring' requires mesh="

"""Training under the ``context`` axis (ring and Ulysses attention,
``parallel/ring_attention.py``), alone and beside ``data``, ``fsdp``
and ``tensor``, against the JAX package's trainer on the CPU, in
float32, on the same numpy-seeded rows.

The port's ranks are spawned as processes that talk over gloo
(``tools/world_train.run``, as tests/test_torch_tensor_training.py runs
them): one world of two processes (``context=2``) and one of four
(``data=2 x context=2``, ``fsdp=2 x context=2`` and ``context=2 x
tensor=2``), each running all its cases one after another
(``world_train.plans_rank``). Context peers feed the same rows, each its
chunk of their tokens (the trainer stages it); the places in the batch
axes feed rows whose loss masks' density differs. The oracle is the JAX
``Trainer`` on ``build_mesh(MeshConfig(data=, fsdp=, context=,
tensor=))`` over conftest's host devices with the loss
``lm_loss_fn(functools.partial(llama.forward, mesh=mesh), cfg)``, fed
the global batch, from the same weights (``interop.params_from_jax``),
with the same ``attn_impl`` ("ring" or "ulysses") on both sides. The
cases cover remat "none", "full" and "dots", adamw and adafactor.

Tolerances, each with its reason:
- loss, ``tokens`` and ``grad_norm`` per step: 1e-5 relative (float32
  sums over the ranks' partial sums and the ring's blocks, in another
  order than XLA's; tests/test_torch_world_training.py's limit);
- final parameters: 2e-5 absolute (three updates of at most lr = 3e-4;
  tests/test_torch_training.py's reason);
- context peers' metrics and parameters, and checkpoints: BITWISE
  (every all-reduce hands its ranks the same bytes; a checkpoint is the
  same bytes, copied).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.parallel.mesh import mesh_from_topology_env
from kubeflow_tpu.training import data as j_data
from kubeflow_tpu.training import trainer as j_trainer
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel.mesh import (
    Backend, WorldMesh, resolve_world_axes,
)
from kubeflow_tpu_torch.rendezvous import bootstrap as t_boot
from kubeflow_tpu_torch.tools import world_train as wt
from kubeflow_tpu_torch.training import Trainer, TrainerConfig, lm_loss_fn
from test_torch_flash_attention import warm_up_cpu_exp
from test_torch_world_training import PARAM_ATOL, RTOL, STEPS, _flat

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact


def _tiny(remat, impl):
    return jl.llama_tiny(dtype=jnp.float32, remat=remat, attn_impl=impl)


def _factored(remat, impl):
    """dim 128 and mlp 256: the embedding and the MLP weights factor
    under adafactor; 2 KV heads, which Ulysses divides over context=2."""
    return jl.LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                          n_kv_heads=2, mlp_dim=256, max_seq=64,
                          rope_scaling=None, tie_embeddings=True,
                          dtype=jnp.float32, remat=remat, attn_impl=impl)


# (case, data, fsdp, tensor, context, JAX config, TrainerConfig fields)
CASES_2 = [
    ("context-ring-dots-adamw-accum2", 1, 1, 1, 2,
     lambda: _tiny("dots", "ring"), dict(optimizer="adamw", grad_accum=2)),
    ("context-ulysses-none-adafactor", 1, 1, 1, 2,
     lambda: _factored("none", "ulysses"),
     dict(optimizer="adafactor", grad_accum=1)),
]
CASES_4 = [
    ("data-context-ring-full-adafactor", 2, 1, 1, 2,
     lambda: _factored("full", "ring"),
     dict(optimizer="adafactor", grad_accum=1)),
    ("fsdp-context-ring-dots-adamw-accum2", 1, 2, 1, 2,
     lambda: _tiny("dots", "ring"), dict(optimizer="adamw", grad_accum=2)),
    ("context-tensor-ring-none-adamw", 1, 1, 2, 2,
     lambda: _tiny("none", "ring"), dict(optimizer="adamw", grad_accum=1)),
]


def _job(jcfg, trainer_kw, **fields):
    host = jax.device_get(jl.init_params(jax.random.key(0), jcfg))
    return wt.Job(interop.config_from_jax(jcfg),
                  dict(warmup_steps=2, total_steps=10, **trainer_kw),
                  local_batch=2, seq=16, steps=STEPS, mask=True,
                  params=host, keep_params=True, **fields)


def _jax_mesh(data, fsdp, tensor, context):
    return build_mesh(MeshConfig(data=data, fsdp=fsdp, tensor=tensor,
                                 context=context),
                      devices=jax.devices()[:data * fsdp * tensor * context])


def _jax_run(jcfg, trainer_kw, job, data, fsdp, tensor, context):
    """The JAX trainer over the mesh on the global batches, its loss the
    forward with ``mesh=``: per-step metrics and the final
    parameters."""
    mesh = _jax_mesh(data, fsdp, tensor, context)
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jl.init_params(rng, jcfg),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(
            functools.partial(jl.forward, mesh=mesh), jcfg),
        config=j_trainer.TrainerConfig(warmup_steps=2, total_steps=10,
                                       **trainer_kw))
    jt.init_state(jax.random.key(0))
    metrics = []
    for step in range(STEPS):
        m = jt.train_step(j_data.put_batch(
            mesh, wt.global_batch(job, data * fsdp, step)))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(jt.params)


def _plans(cases, jobs):
    return [(d, f, t, 1, c, wt.train_rank, (job,))
            for (_, d, f, t, c, _, _), job in zip(cases, jobs)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One world of two processes (``context=2``): every case of CASES_2,
    ``fit`` with checkpoints, and the checkpoint restored into
    ``data=2``."""
    root = tmp_path_factory.mktemp("context2")
    jobs = [_job(cfg(), kw) for *_, cfg, kw in CASES_2]
    fit_job = dataclasses.replace(jobs[0], steps=4)
    plans = _plans(CASES_2, jobs) + [
        (1, 1, 1, 1, 2, wt.fit_rank, (fit_job, str(root / "ckpt"), 2)),
        (2, 1, 1, 1, 1, wt.restore_rank, (fit_job, str(root / "ckpt" / "a"))),
    ]
    results = wt.run(wt.plans_rank, (plans,), 1, 1, ["cpu"] * 2,
                     str(root / "world"), context=2)
    return jobs, fit_job, results


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One world of four processes: every case of CASES_4."""
    root = tmp_path_factory.mktemp("context4")
    jobs = [_job(cfg(), kw) for *_, cfg, kw in CASES_4]
    results = wt.run(wt.plans_rank, (_plans(CASES_4, jobs),), 1, 1,
                     ["cpu"] * 4, str(root / "world"), context=4)
    return jobs, results


def _check_case(case, job, ranks):
    name, data, fsdp, tensor, context, cfg, kw = case
    assert {r["backend"]["backend"] for r in ranks} == {"gloo"}
    assert {r["backend"]["context"] for r in ranks} == {context}
    metrics, params = _jax_run(cfg(), kw, job, data, fsdp, tensor, context)
    want = _flat(params)
    for r, res in enumerate(ranks):
        got = res["runs"]["eager"]["metrics"]
        for step, (a, b) in enumerate(zip(got, metrics)):
            for key in ("loss", "tokens", "grad_norm"):
                np.testing.assert_allclose(
                    a[key], b[key], rtol=RTOL,
                    err_msg=f"{name} rank {r} step {step} {key}")
        for leaf, x in _flat(res["params"]).items():
            np.testing.assert_allclose(x, want[leaf], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{name} rank {r} {leaf}")
        assert res["runs"]["eager"]["collectives"][0]["context_calls"] > 0
    # context peers (ranks tensor apart) hold the same state: the same
    # metrics and the same parameters, bitwise
    for r, res in enumerate(ranks):
        peer = ranks[r + tensor if (r // tensor) % 2 == 0 else r - tensor]
        assert res["runs"]["eager"]["metrics"] == \
            peer["runs"]["eager"]["metrics"]
        for leaf, x in _flat(res["params"]).items():
            assert np.array_equal(x, _flat(peer["params"])[leaf]), leaf
    # every token counted once: the global batch's count
    counts = [int(wt.batch_for(job, 0, i)["mask"][:, 1:].sum())
              for i in range(data * fsdp)]
    assert ranks[0]["runs"]["eager"]["metrics"][0]["tokens"] == sum(counts)


@pytest.mark.parametrize("case", range(len(CASES_2)),
                         ids=[c[0] for c in CASES_2])
def test_context_world_matches_the_jax_trainer(two_ranks, case):
    """context=2 (ring, then Ulysses): losses, tokens and grad norms on
    both ranks, and the whole parameters after three steps, against the
    JAX trainer on MeshConfig(context=2) fed the same rows."""
    jobs, _, results = two_ranks
    _check_case(CASES_2[case], jobs[case], [r[case] for r in results])


@pytest.mark.parametrize("case", range(len(CASES_4)),
                         ids=[c[0] for c in CASES_4])
def test_context_beside_data_fsdp_and_tensor_matches_the_jax_trainer(
        four_ranks, case):
    """data=2 x context=2, fsdp=2 x context=2 (ZeRO-3: each layer
    gathered over fsdp inside the micro bodies, the ring over context)
    and context=2 x tensor=2 (the ring on each rank's heads): the same
    against the JAX trainer on the same mesh."""
    jobs, results = four_ranks
    ranks = [r[case] for r in results]
    assert [r["backend"]["rank"] for r in ranks] == [0, 1, 2, 3]
    _check_case(CASES_4[case], jobs[case], ranks)


def test_context_checkpoint_restores_bitwise_into_data(two_ranks):
    """context=2: ``fit`` to step 4 with a checkpoint every 2 steps, and
    the same stopped at step 2 and resumed by a fresh trainer: the
    losses after the resume and the whole final state bitwise the
    uninterrupted run's, on both ranks alike; the step-4 checkpoint
    restores bitwise into data=2."""
    _, _, results = two_ranks
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
    for r in results:
        restored = r[len(CASES_2) + 1]
        assert restored["step"] == 4
        assert restored["state"].keys() == world.keys()
        for k, t in restored["state"].items():
            assert torch.equal(t, world[k]), k


@pytest.mark.parametrize("mesh,n", [("context=2", 2), ("data=2,context=2", 4),
                                    ("fsdp=2,context=2", 4),
                                    ("context=2,tensor=2", 4),
                                    ("fsdp=-1,context=2", 8)])
def test_world_layout_with_context_agrees_with_the_reference(mesh, n):
    """``world_layout`` (and ``resolve_world_axes``) of ``KFT_MESH`` with
    ``context`` against the reference's mesh over N devices."""
    env = {"KFT_MESH": mesh}
    ref = dict(mesh_from_topology_env(env, devices=jax.devices()[:n]).shape)
    ours = t_boot.world_layout(env, n)
    for axis in ("data", "fsdp", "expert", "context", "tensor"):
        assert ours[axis] == ref[axis], axis
    sizes = {k: int(v) for k, v in (kv.split("=") for kv in mesh.split(","))}
    cfg = MeshConfig(**sizes).resolved(n)
    assert resolve_world_axes(n, sizes.get("data", 1), sizes.get("fsdp", -1),
                              sizes.get("tensor", 1), 1,
                              sizes.get("context", 1)) == (cfg.data, cfg.fsdp)


def test_context_beside_expert_or_moe_raises_naming_its_item(monkeypatch):
    """``context`` beside ``expert`` and an MoE model over a context world
    are ported: ``world_layout`` lays ``expert`` beside ``context`` out as
    the reference's mesh does, the world takes it, and an MoE trainer
    over a context world builds. What is still not ported raises naming
    ROADMAP queue 1 item 8.7: ``context`` in a serving mesh."""
    from kubeflow_tpu_torch.parallel.mesh import mesh_from_topology_env as sm

    for mesh in ("expert=2,context=2", "data=2,expert=2,context=2"):
        n = 4 if mesh.startswith("expert") else 8
        env = {"KFT_MESH": mesh}
        ref = dict(mesh_from_topology_env(env,
                                          devices=jax.devices()[:n]).shape)
        ours = t_boot.world_layout(env, n)
        for axis in ("data", "fsdp", "expert", "context", "tensor"):
            assert ours[axis] == ref[axis], (mesh, axis)
    monkeypatch.setattr(WorldMesh, "_make_groups", lambda self: None)
    world = WorldMesh(1, 1, 3, "cpu", Backend("gloo", "test"), expert=2,
                      context=2)
    assert (world.expert_index, world.context_index) == (1, 1)
    assert world.shape == {"data": 1, "fsdp": 1, "expert": 2, "context": 2}
    cfg = tl.llama_tiny(n_experts=4, dtype=torch.float32, attn_impl="ring")
    stub = types.SimpleNamespace(
        size=2, data=1, fsdp=1, tensor=1, expert=1, context=2,
        shape={"data": 1, "fsdp": 1, "context": 2},
        device=torch.device("cpu"))
    trainer = Trainer(lambda g: tl.init_params(g, cfg, device="cpu"),
                      lm_loss_fn(tl.forward, cfg), TrainerConfig(),
                      device="cpu", mesh=stub,
                      param_axes=tl.param_logical_axes(cfg))
    assert trainer.mesh is stub and trainer._context == 2
    with pytest.raises(NotImplementedError, match="queue 1 item 8.7"):
        sm({"KFT_MESH": "context=2"})


def test_a_context_world_refuses_what_it_cannot_split():
    """A sequence that ``context`` does not divide raises when it is
    staged; an attention impl other than ring or Ulysses over a context
    world raises rather than attend within the rank's chunk alone."""
    cfg = tl.llama_tiny(dtype=torch.float32, attn_impl="ring")
    stub = types.SimpleNamespace(
        size=2, data=1, fsdp=1, tensor=1, expert=1, context=2,
        shape={"data": 1, "fsdp": 1, "context": 2},
        device=torch.device("cpu"), axis_index=lambda axis: 0,
        axis_size=lambda axis: 2 if axis == "context" else 1)
    trainer = Trainer(lambda g: tl.init_params(g, cfg, device="cpu"),
                      lm_loss_fn(tl.forward, cfg), TrainerConfig(),
                      device="cpu", mesh=stub,
                      param_axes=tl.param_logical_axes(cfg))
    with pytest.raises(ValueError, match="does not split into context=2"):
        trainer._stage({"tokens": np.zeros((2, 16), dtype=np.int32)})
    flash = dataclasses.replace(cfg, attn_impl="flash")
    params = tl.init_params(torch.Generator().manual_seed(0), flash,
                            device="cpu")
    with pytest.raises(ValueError, match="use ring or ulysses"):
        tl.forward(params, torch.zeros((1, 8), dtype=torch.long), flash,
                   mesh=stub)

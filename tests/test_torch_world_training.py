"""Training over a world of processes (``parallel.mesh.WorldMesh``, the
``data`` and ``fsdp`` axes) against the JAX package's trainer on the CPU,
in float32, on the same numpy-seeded rows.

The port's ranks are spawned as processes that talk over gloo,
rendezvousing through a file under the test's tmp_path
(``tools/world_train.run``); each feeds its own rows, with a loss mask
whose density differs between ranks. The oracle is the JAX ``Trainer``
on ``build_mesh(MeshConfig(data=2))`` or ``(fsdp=2)`` over two of
tests/conftest.py's eight host devices (four for ``data=2,fsdp=2``), fed
the global batch (the ranks' rows concatenated), from the same weights
(``interop.params_from_jax``). JAX side attention "xla", port side
"pallas" (its plain path on the CPU), as tests/test_torch_training.py.

Tolerances, each with its reason:
- loss, ``tokens`` and ``grad_norm`` per step: 1e-5 relative (float32
  sums over the ranks' partial sums, in another order than XLA's);
- final parameters: 2e-5 absolute (three updates of at most lr = 3e-4;
  tests/test_torch_training.py's reason);
- the optimizer on fsdp parts against the whole tree's update on the
  same rank: 1e-6 absolute, two float32 ulps of the largest parameters
  (N(0, 1) draws up to ~5; a mean over a cut dim is a sum over the group
  divided once where the whole tree takes one mean, so a factor may
  differ by an ulp, and the update's add then rounds one ulp apart);
- checkpoints: BITWISE (the same bytes, copied).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.parallel import sharding as j_sharding
from kubeflow_tpu.training import data as j_data
from kubeflow_tpu.training import trainer as j_trainer
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel import sharding as t_sharding
from kubeflow_tpu_torch.parallel.mesh import (
    Backend, WorldMesh, resolve_world_axes,
)
from kubeflow_tpu_torch.rendezvous import bootstrap as t_boot
from kubeflow_tpu_torch.tools import world_train as wt
from kubeflow_tpu_torch.training import (
    CheckpointManager, Trainer, TrainerConfig, lm_loss_fn, optim,
    restore_latest,
)
from test_torch_flash_attention import warm_up_cpu_exp

STEPS = 3
RTOL = 1e-5
PARAM_ATOL = 2e-5
OPT_ATOL = 1e-6

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact


def _tiny():
    return jl.llama_tiny(dtype=jnp.float32)


def _factored():
    """dim 128 and mlp 256: the embedding and the MLP weights factor
    under adafactor (tests/test_torch_training.py's config)."""
    return jl.LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                          n_kv_heads=2, mlp_dim=256, max_seq=64,
                          rope_scaling=None, tie_embeddings=True,
                          dtype=jnp.float32)


# (case, data, fsdp, JAX config, TrainerConfig fields): each axis, each
# optimizer and each grad_accum, under ragged masks
CASES = [
    ("data-adamw-accum1", 2, 1, _tiny, dict(optimizer="adamw", grad_accum=1)),
    ("fsdp-adamw-accum2", 1, 2, _tiny, dict(optimizer="adamw", grad_accum=2)),
    ("fsdp-adafactor-accum1", 1, 2, _factored,
     dict(optimizer="adafactor", grad_accum=1)),
    ("data-adafactor-accum2", 2, 1, _factored,
     dict(optimizer="adafactor", grad_accum=2)),
]
# the optimizer on fsdp parts: the cut dim is the largest (256 x 128 on
# 0), the second largest (128 x 256 on 0), neither (4 x 128 x 256 on 0),
# and a leaf that does not factor
OPT_SHAPES = {"a": (256, 128), "b": (128, 256), "c": (4, 128, 256),
              "d": (200,)}
OPT_DIMS = {"a": 0, "b": 0, "c": 0, "d": 0}


def _job(jcfg, trainer_kw, seed=0):
    host = jax.device_get(jl.init_params(jax.random.key(seed), jcfg))
    tcfg = interop.config_from_jax(jcfg)
    tcfg = tl.LlamaConfig(**{**tcfg.__dict__, "attn_impl": "pallas"})
    return wt.Job(tcfg, dict(warmup_steps=2, total_steps=10, **trainer_kw),
                  local_batch=2, seq=16, steps=STEPS, mask=True,
                  params=host, keep_params=True)


def _jax_run(jcfg, trainer_kw, job, data, fsdp, seed=0):
    """The JAX trainer over data x fsdp host devices on the global
    batches: per-step metrics and the final parameters."""
    mesh = build_mesh(MeshConfig(data=data, fsdp=fsdp),
                      devices=jax.devices()[:data * fsdp])
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jl.init_params(rng, jcfg),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(jl.forward, jcfg),
        config=j_trainer.TrainerConfig(warmup_steps=2, total_steps=10,
                                       **trainer_kw))
    jt.init_state(jax.random.key(seed))
    metrics = []
    for step in range(STEPS):
        m = jt.train_step(j_data.put_batch(
            mesh, wt.global_batch(job, data * fsdp, step)))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(jt.params)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_matches(rank_results, jax_metrics, jax_params, what):
    for r, res in enumerate(rank_results):
        got = res["runs"]["eager"]["metrics"]
        for step, (a, b) in enumerate(zip(got, jax_metrics)):
            for key in ("loss", "tokens", "grad_norm"):
                np.testing.assert_allclose(
                    a[key], b[key], rtol=RTOL,
                    err_msg=f"{what} rank {r} step {step} {key}")
        want = _flat(jax_params)
        for name, x in _flat(res["params"]).items():
            np.testing.assert_allclose(x, want[name], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{what} rank {r} {name}")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One world of two processes running every case of CASES, each on
    its own layout, then the optimizer on fsdp parts."""
    jobs = [_job(cfg(), kw) for _, _, _, cfg, kw in CASES]
    plans = [(d, f, wt.train_rank, (job,))
             for (_, d, f, _, _), job in zip(CASES, jobs)]
    plans += [(1, 2, wt.optimizer_rank,
               (OPT_SHAPES, OPT_DIMS, "adafactor", STEPS)),
              (1, 2, wt.optimizer_rank,
               (OPT_SHAPES, OPT_DIMS, "adamw", STEPS))]
    results = wt.run(wt.plans_rank, (plans,), 1, 2, ["cpu"] * 2,
                     str(tmp_path_factory.mktemp("world2")))
    return jobs, results


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_world_matches_the_jax_trainer(two_ranks, case):
    """Losses, tokens and grad norms of the global batch on every rank,
    and every rank's whole parameters after three steps, against the JAX
    trainer over the same mesh axes fed the global batches."""
    jobs, results = two_ranks
    name, data, fsdp, cfg, kw = CASES[case]
    ranks = [r[case] for r in results]
    assert {r["backend"]["backend"] for r in ranks} == {"gloo"}
    metrics, params = _jax_run(cfg(), kw, jobs[case], data, fsdp)
    _assert_matches(ranks, metrics, params, name)
    # the ranks' token counts differ (ragged masks), and the world sums
    # them: tokens is the global batch's count
    counts = [int(wt.batch_for(jobs[case], 0, r)["mask"][:, 1:].sum())
              for r in range(2)]
    assert counts[0] != counts[1]
    assert ranks[0]["runs"]["eager"]["metrics"][0]["tokens"] == sum(counts)


def test_four_process_data_and_fsdp_matches_the_jax_trainer(tmp_path):
    """data=2, fsdp=2: four processes, gradients reduce-scattered over
    fsdp and all-reduced over data."""
    jcfg, kw = _tiny(), dict(optimizer="adamw", grad_accum=1)
    job = _job(jcfg, kw)
    results = wt.run(wt.train_rank, (job,), 2, 2, ["cpu"] * 4,
                     str(tmp_path))
    assert [r["backend"]["rank"] for r in results] == [0, 1, 2, 3]
    metrics, params = _jax_run(jcfg, kw, job, 2, 2)
    _assert_matches(results, metrics, params, "data=2,fsdp=2")


def test_fsdp_rank_keeps_half_the_optimizer_state(two_ranks):
    """What a rank keeps from step to step, counted by
    ``Trainer.state_bytes``, which must be every tensor the trainer
    still reaches after its steps (``world_train.reachable_tensors``). An
    fsdp rank keeps half the parameters and half the gradient accumulators
    (ZeRO-3: its parts; the micro bodies gather each layer), and half
    the optimizer state (adamw's two 0-d int32 counts aside, which every
    rank holds whole; adafactor's factored moments that lose the cut dim
    are whole on each rank, so there about half): less in all."""
    _, results = two_ranks
    for r, rank in enumerate(results):
        for i, case in enumerate(CASES):
            run = rank[i]["runs"]["eager"]
            assert run["state_bytes"]["total"] == run["held_bytes"], \
                (r, case[0], run["state_bytes"], run["held_bytes"])
    sizes = {CASES[i][0]: results[0][i]["runs"]["eager"]["state_bytes"]
             for i in range(len(CASES))}
    data, fsdp = sizes["data-adamw-accum1"], sizes["fsdp-adamw-accum2"]
    counts = 2 * 4
    assert 2 * fsdp["params"] == data["params"] > 0
    assert 2 * fsdp["grads"] == data["grads"] == data["params"]
    assert 2 * (fsdp["opt_state"] - counts) == data["opt_state"] - counts
    assert fsdp["total"] - fsdp["other"] < data["total"] - data["other"]
    data, fsdp = sizes["data-adafactor-accum2"], sizes["fsdp-adafactor-accum1"]
    assert 2 * fsdp["params"] == data["params"]
    assert 2 * fsdp["grads"] == data["grads"]
    assert 0.5 < fsdp["opt_state"] / data["opt_state"] < 0.55


@pytest.mark.parametrize("name", ["adafactor", "adamw"])
def test_optimizer_on_fsdp_parts_gives_the_unsharded_update(two_ranks,
                                                            name):
    _, results = two_ranks
    i = len(CASES) + ["adafactor", "adamw"].index(name)
    for r, res in enumerate(results):
        diffs = res[i]
        assert max(diffs.values()) <= OPT_ATOL, (r, diffs)


def _stub_mesh(data, fsdp):
    return types.SimpleNamespace(size=data * fsdp, data=data, fsdp=fsdp,
                                 shape={"data": data, "fsdp": fsdp},
                                 device=torch.device("cpu"))


def test_divisibility_error_matches_jax():
    """``init_state`` refuses a parameter whose fsdp dim does not divide,
    before any collective, with the JAX package's message."""
    axes = {"w": ("embed", "mlp"), "b": ("mlp",)}
    shapes = {"w": (3, 4), "b": (4,)}
    jmesh = build_mesh(MeshConfig(fsdp=2), devices=jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        j_sharding.validate_divisibility(jmesh, axes, shapes)
    trainer = Trainer(
        lambda g: {k: torch.zeros(s) for k, s in shapes.items()},
        lambda p, b: (p["w"].sum(), {"tokens": 1.0}), TrainerConfig(),
        device="cpu", mesh=_stub_mesh(1, 2), param_axes=axes)
    with pytest.raises(ValueError) as got:
        trainer.init_state()
    assert str(got.value) == str(want.value)
    assert "param ['w']: dim 3 not divisible" in str(got.value)


def test_moe_under_a_world_raises_naming_its_item():
    """An MoE trainer over a world is built (its parity cases are in
    tests/test_torch_moe_world.py and, under context, in
    tests/test_torch_moe_context.py); beside the expert axis, what is
    still to be ported raises naming ROADMAP queue 1 item 8.7: a
    ``KFT_DCN`` axis other than data and fsdp, and pipeline once the
    world chose NCCL."""
    cfg = tl.llama_tiny(n_experts=4, dtype=torch.float32)
    trainer = Trainer(lambda g: tl.init_params(g, cfg, device="cpu"),
                      lm_loss_fn(tl.forward, cfg), TrainerConfig(),
                      device="cpu", mesh=_stub_mesh(2, 1),
                      param_axes=tl.param_logical_axes(cfg))
    assert trainer.mesh is not None
    for env, backend in (({"KFT_MESH": "expert=2", "KFT_DCN": "expert=2"},
                          None),
                         ({"KFT_MESH": "expert=2,pipeline=2,data=2"},
                          "nccl")):
        with pytest.raises(NotImplementedError, match="queue 1 item 8.7"):
            t_boot.world_layout(env, 8, backend)
    for mesh in ("expert=2,context=2", "data=2,expert=2,context=2"):
        layout = t_boot.world_layout({"KFT_MESH": mesh}, 8)
        assert (layout["expert"], layout["context"]) == (2, 2)


def test_world_axes_follow_mesh_config_resolved():
    """resolve_world_axes against MeshConfig.resolved over the batch
    axes: its results and its messages."""
    for n, data, fsdp in ((4, 1, -1), (4, 2, -1), (4, -1, 2), (2, 2, 1)):
        ref = MeshConfig(data=data, fsdp=fsdp).resolved(n)
        assert resolve_world_axes(n, data, fsdp) == (ref.data, ref.fsdp)
    for n, data, fsdp in ((4, -1, -1), (4, 3, -1), (4, 2, 1)):
        with pytest.raises(ValueError) as want:
            MeshConfig(data=data, fsdp=fsdp).resolved(n)
        with pytest.raises(ValueError) as got:
            resolve_world_axes(n, data, fsdp)
        assert str(got.value) == str(want.value)


def test_backend_is_chosen_from_where_the_ranks_run(monkeypatch):
    """NCCL only when every rank has a card of its own; shared cards and
    the CPU take gloo; a world of both raises; a world without a card
    raises before any group unless the CPU is asked for. A mesh names
    its axes as the JAX mesh does, rank r at (r // fsdp, r % fsdp)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_boot.initialize({"KFT_NUM_PROCESSES": "2", "KFT_PROCESS_ID": "1"})
    assert not torch.distributed.is_initialized()
    assert t_boot.choose_backend(["cpu", "cpu"]).name == "gloo"
    shared = t_boot.choose_backend(["h/GPU-a", "h/GPU-a"])
    assert shared.name == "gloo" and "NCCL refuses" in shared.reason
    assert t_boot.choose_backend(["h/GPU-a", "h/GPU-b"]).name == "nccl"
    with pytest.raises(ValueError, match="one or the other"):
        t_boot.choose_backend(["cpu", "h/GPU-a"])
    one = WorldMesh(1, 1, 0, "cpu", Backend("gloo", "one rank"))
    assert one.shape == {"data": 1, "fsdp": 1}
    x = torch.ones(3)
    assert one.all_reduce(x) is x and torch.equal(x, torch.ones(3))
    assert t_sharding.axis_dim(("layers", "embed", "mlp"), "fsdp") == 1
    assert t_sharding.axis_dim(("vocab", "head_dim"), "fsdp") is None
    full = torch.arange(24.0).view(2, 4, 3)
    parts = [t_sharding.axis_shard(full, 1, i, 2, "fsdp") for i in range(2)]
    assert torch.equal(t_sharding.fsdp_unshard(parts, 1), full)


def test_param_logical_axes_match_jax_leaf_for_leaf():
    for jcfg in (jl.llama_tiny(), jl.llama_1b(), jl.llama3_8b(),
                 dataclasses.replace(jl.llama_tiny(), tie_embeddings=False),
                 jl.llama_tiny(n_experts=4)):
        tcfg = interop.config_from_jax(jcfg)
        assert tl.param_logical_axes(tcfg) == jl.param_logical_axes(jcfg)


@pytest.fixture(scope="module")
def fit_world(tmp_path_factory):
    """fsdp=2: ``world_train.fit_rank`` to step 4 with a checkpoint every
    2 steps, each directory mirrored."""
    root = tmp_path_factory.mktemp("fit2")
    job = _job(_tiny(), dict(optimizer="adamw", grad_accum=1))
    job = wt.Job(**{**job.__dict__, "steps": 4})
    results = wt.run(wt.fit_rank, (job, str(root / "ckpt"), 2,
                                   str(root / "mirror")),
                     1, 2, ["cpu"] * 2, str(root / "world"))
    return job, root, results


def test_checkpoint_of_two_processes_restores_bitwise(fit_world):
    """fsdp=2: ``fit`` to step 4 with a checkpoint every 2 steps; the same
    stopped at step 2 and resumed by a fresh trainer to step 4, whose
    losses after the resume and whole final state are bitwise the
    uninterrupted run's; then the uninterrupted run's step-4 checkpoint
    (written by the coordinator alone, the one-process format) restored
    into ONE process: parameters and optimizer state bitwise the world's
    gathered state."""
    job, root, results = fit_world
    ckpt = root / "ckpt"
    for r, res in enumerate(results):
        a, c = res["a"], res["c"]
        assert c["resumed_from"] == 2 and a["resumed_from"] is None
        assert {s: c["losses"][s] for s in (3, 4)} == \
            {s: a["losses"][s] for s in (3, 4)}, r
        assert a["state"].keys() == c["state"].keys()
        for k, t in a["state"].items():
            assert torch.equal(t, c["state"][k]), (r, k)
    assert sorted(p.name for p in (ckpt / "a").iterdir()) == ["2", "4"]

    one = wt.make_trainer(job, torch.device("cpu"))
    mgr = CheckpointManager(str(ckpt / "a"))
    assert restore_latest(one, mgr) == 4
    mgr.close()
    mine = optim.named_leaves({"params": one.params,
                               "opt_state": one.opt_state})
    world = results[0]["a"]["state"]
    assert mine.keys() == world.keys()
    for k, t in mine.items():
        assert torch.equal(t.detach(), world[k]), k


def test_world_fit_mirrors_from_the_coordinator_alone(fit_world):
    """The same runs with ``checkpoint_mirror`` set: the coordinator
    alone copies to the mirror, so every step lands there whole, byte
    for byte the local one, with no leftover and no mirror error on any
    rank; the run resumed from ``b`` mirrors its later steps too."""
    _, root, results = fit_world
    for r, res in enumerate(results):
        for run in ("a", "b", "c"):
            assert "ckpt_mirror_errors" not in res[run]["last"], (r, run)
    for name, steps in (("a", ["2", "4"]), ("b", ["2", "4"])):
        local, mirror = root / "ckpt" / name, root / "mirror" / name
        assert sorted(p.name for p in mirror.iterdir()) == steps, name
        for step in steps:
            files = sorted(p.name for p in (local / step).iterdir())
            assert sorted(p.name for p in (mirror / step).iterdir()) \
                == files
            for f in files:
                assert (local / step / f).read_bytes() \
                    == (mirror / step / f).read_bytes(), (name, step, f)

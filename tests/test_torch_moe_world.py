"""Mixture-of-Experts over a world of processes (``parallel/moe.py`` with
``world=``, the ``expert`` axis, and MoE under ``data``, ``fsdp`` and
``tensor``) against the JAX package on the CPU, in float32, on the same
numpy-seeded inputs.

The port's ranks are spawned as processes that talk over gloo
(``tools/world_train.run``): one world of two processes here and one of
four in tests/test_torch_moe_world4.py, each running all its layouts one
after another (``world_train.plans_rank``). Expert and tensor peers
feed the same rows; the places in the batch axes feed rows (and, for
the layer, token masks) that differ.
The oracle is the JAX function on the global batch: the layer's
``moe_layer`` (GSPMD never changes what it computes, so its global
function is what every mesh computes) and the JAX ``Trainer`` on
``build_mesh(MeshConfig(...))`` of the same layout over conftest's host
devices. With ``grad_accum`` = 2 the JAX trainer is handed the global
batch micro batch by micro batch (``world_train.global_batch(...,
grad_accum=2)``), the world's grouping of micro batches
(``training/trainer.py``): an MoE layer's capacity and slots depend on
which rows share a micro batch.

Tolerances, each with its reason:
- the layer's outputs and gradients: 1e-5 absolute (float32 einsums
  over the rank's experts and mlp slices, summed over the ranks in
  another order; tests/test_torch_moe.py's limits), the aux losses 1e-6
  relative (the global sums in another order), the dropped fraction
  exactly (it counts integers);
- the trainer: loss, ``tokens``, ``moe_aux`` and ``grad_norm`` per step
  1e-5 relative, final parameters 2e-5 absolute
  (tests/test_torch_world_training.py's reasons);
- expert peers' metrics and the leaves the expert axis does not cut,
  and checkpoints: BITWISE (the same all-reduced bytes, and copies).

This file holds the world of two processes; tests/test_torch_moe_world4.py
the world of four and the pod, on the helpers defined here.
"""

import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.parallel import moe as j_moe
from kubeflow_tpu.parallel import sharding as j_sharding
from kubeflow_tpu.parallel.mesh import mesh_from_topology_env
from kubeflow_tpu.training import data as j_data
from kubeflow_tpu.training import trainer as j_trainer
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel.mesh import resolve_world_axes
from kubeflow_tpu_torch.rendezvous import bootstrap as t_boot
from kubeflow_tpu_torch.tools import world_train as wt
from kubeflow_tpu_torch.training import Trainer, TrainerConfig, optim
from test_torch_flash_attention import warm_up_cpu_exp
from test_torch_tensor_training import _check_fit, _flat_axes
from test_torch_world_training import PARAM_ATOL, RTOL, STEPS, _flat

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

LAYER_ATOL = 1e-5
AUX_RTOL = 1e-6
# the layer's shapes: global batch [B, S, D], E experts of mlp M
B, S, D, M, E = 4, 6, 16, 32, 4


# ---------------------------------------------------------------- layer --

def layer_inputs(seed: int) -> dict:
    """The layer's whole inputs (float32, from ``seed``): x [B, S, D], the
    router and the experts, a token mask whose density differs between
    the halves of the batch, and the weight of each output element in
    the loss."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (rng.standard_normal(shape)
                                   * scale).astype(np.float32)
    density = np.array([0.9, 0.7, 0.5, 0.3])[:, None]
    return {"x": f(B, S, D),
            "params": {"router": f(D, E, scale=D ** -0.5),
                       "w_gate": f(E, D, M, scale=D ** -0.5),
                       "w_up": f(E, D, M, scale=D ** -0.5),
                       "w_down": f(E, M, D, scale=M ** -0.5)},
            "mask": rng.random((B, S)) < density,
            "weights": f(B, S, D)}


# (case, capacity factor, top_k, masked): the capacity path with drops
# (factor 0.5: a quarter of the slots the choices ask for), the
# dropless path, and the capacity path unmasked at the default factor
LAYER_CASES = [("capacity-drops", 0.5, 2, True), ("dropless", 0.0, 2, True),
               ("capacity-1.25", 1.25, 2, False),
               ("capacity-top1", 0.75, 1, True)]


@functools.lru_cache(maxsize=None)
def _jax_layer(case, seed=0):
    """The JAX layer on the whole inputs: (y, aux, grads of x and of the
    weights) of ``sum(y * weights) + aux`` (once a case: every layout
    checks against it)."""
    _, cf, top_k, masked = case
    inp = layer_inputs(seed)
    cfg = j_moe.MoEConfig(dim=D, mlp_dim=M, n_experts=E, top_k=top_k,
                          capacity_factor=cf, dtype=jnp.float32)
    mask = jnp.asarray(inp["mask"]) if masked else None

    def loss(p, x):
        y, aux = j_moe.moe_layer(p, x, cfg, token_mask=mask)
        return (y * inp["weights"]).sum() + j_moe.moe_aux_total(aux), \
            (y, aux)

    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(inp["x"]))
    return (np.asarray(y), {k: float(v) for k, v in aux.items()},
            np.asarray(gx), jax.tree_util.tree_map(np.asarray, gp))


def _check_layer(ranks):
    """Each rank's rows of the output and of the input gradient, the
    global aux on every rank, and the weights' gradients (summed over the
    batch ranks, each expert and tensor rank's slice) against the JAX
    layer on the whole inputs."""
    for c, case in enumerate(LAYER_CASES):
        y, aux, gx, gp = _jax_layer(case)
        if case[1] > 0 and case[0] != "capacity-1.25":
            assert aux["moe_dropped_fraction"] > 0, case
        summed: dict = {}
        for r in ranks:
            i, n = r["batch"]
            ix, nx = r["expert"]
            it, nt = r["tensor"]
            rows = slice(i * B // n, (i + 1) * B // n)
            got = r["cases"][c]
            np.testing.assert_allclose(got["y"].numpy(), y[rows], rtol=0,
                                       atol=LAYER_ATOL, err_msg=case[0])
            np.testing.assert_allclose(got["x"].numpy(), gx[rows], rtol=0,
                                       atol=LAYER_ATOL, err_msg=case[0])
            for k in ("moe_load_balance", "moe_router_z"):
                np.testing.assert_allclose(got["aux"][k], aux[k],
                                           rtol=AUX_RTOL, err_msg=k)
            assert got["aux"]["moe_dropped_fraction"] == \
                aux["moe_dropped_fraction"], case[0]
            for k, g in got["grads"].items():
                summed.setdefault((k, ix, it), []).append(g)
        for (k, ix, it), parts in summed.items():
            want = gp[k]
            if k != "router":
                want = want[ix * E // nx:(ix + 1) * E // nx]
                cols = slice(it * M // nt, (it + 1) * M // nt)
                want = want[:, :, cols] if k != "w_down" else want[:, cols]
            np.testing.assert_allclose(sum(parts).numpy(), want, rtol=0,
                                       atol=LAYER_ATOL,
                                       err_msg=f"{case[0]} {k}")
        # the router's gradient: the same bytes on every expert and
        # tensor peer (each holds the whole router)
        for r in ranks:
            peers = [p for p in ranks if p["batch"] == r["batch"]]
            for p in peers:
                assert torch.equal(p["cases"][c]["grads"]["router"],
                                   r["cases"][c]["grads"]["router"])


# -------------------------------------------------------------- trainer --

def _moe_tiny(remat, **fields):
    return dataclasses.replace(
        jl.llama_tiny(dtype=jnp.float32, remat=remat, n_experts=4,
                      moe_top_k=2), **fields)


# (case, data, fsdp, tensor, expert, remat, TrainerConfig fields)
CASES_2 = [
    ("data-none-adamw-accum2", 2, 1, 1, 1, "none",
     dict(optimizer="adamw", grad_accum=2)),
    ("fsdp-dots-adafactor", 1, 2, 1, 1, "dots",
     dict(optimizer="adafactor", grad_accum=1)),
    ("tensor-full-adamw", 1, 1, 2, 1, "full",
     dict(optimizer="adamw", grad_accum=1)),
    ("expert-dots-adamw-accum2", 1, 1, 1, 2, "dots",
     dict(optimizer="adamw", grad_accum=2)),
]


def _job(case, **fields):
    jcfg = _moe_tiny(case[5])
    host = jax.device_get(jl.init_params(jax.random.key(0), jcfg))
    tcfg = interop.config_from_jax(jcfg)
    tcfg = tl.LlamaConfig(**{**tcfg.__dict__, "attn_impl": "pallas"})
    return wt.Job(tcfg, dict(warmup_steps=2, total_steps=10, **case[6]),
                  local_batch=2, seq=16, steps=STEPS, mask=True,
                  params=host, keep_params=True, **fields)


def _jax_mesh(data, fsdp, tensor, expert):
    n = data * fsdp * tensor * expert
    return build_mesh(MeshConfig(data=data, fsdp=fsdp, tensor=tensor,
                                 expert=expert), devices=jax.devices()[:n])


def _jax_run(case, job):
    """The JAX trainer on the case's mesh on the global batches, micro
    batch by micro batch as the world groups them: per-step metrics and
    the final parameters."""
    _, data, fsdp, tensor, expert, remat, kw = case
    jcfg = _moe_tiny(remat)
    mesh = _jax_mesh(data, fsdp, tensor, expert)
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jl.init_params(rng, jcfg),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(jl.forward, jcfg),
        config=j_trainer.TrainerConfig(warmup_steps=2, total_steps=10, **kw))
    jt.init_state(jax.random.key(0))
    metrics = []
    for step in range(STEPS):
        m = jt.train_step(j_data.put_batch(mesh, wt.global_batch(
            job, data * fsdp, step, kw["grad_accum"])))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(jt.params)


def _plans(cases, jobs):
    return [(d, f, t, x, wt.train_rank, (job,))
            for (_, d, f, t, x, _, _), job in zip(cases, jobs)]


def _layer_plan(data, fsdp, tensor, expert):
    return (data, fsdp, tensor, expert, wt.moe_layer_rank,
            (layer_inputs(0), LAYER_CASES))


# the layer's layouts over two processes
LAYOUTS_2 = {"data=2": (2, 1, 1, 1), "expert=2": (1, 1, 1, 2),
             "tensor=2": (1, 1, 2, 1)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One world of two processes: the layer under each of LAYOUTS_2;
    every case of CASES_2; ``fit`` with checkpoints under expert=2, its
    checkpoint restored into fsdp=2."""
    root = tmp_path_factory.mktemp("moe2")
    jobs = [_job(c) for c in CASES_2]
    fit_job = dataclasses.replace(jobs[3], steps=4)
    plans = [_layer_plan(*sizes) for sizes in LAYOUTS_2.values()] \
        + _plans(CASES_2, jobs) + [
        (1, 1, 1, 2, wt.fit_rank, (fit_job, str(root / "ckpt"), 2)),
        (1, 2, 1, 1, wt.restore_rank, (fit_job, str(root / "ckpt" / "a")))]
    results = wt.run(wt.plans_rank, (plans,), 1, 2, ["cpu"] * 2,
                     str(root / "world"))
    return jobs, fit_job, root, results


@pytest.mark.parametrize("layout", list(LAYOUTS_2))
def test_layer_over_two_ranks_matches_jax(two_ranks, layout):
    """moe_layer over a world of two against the JAX layer on the global
    batch: the capacity path with drops, the dropless path and top-1,
    with token masks that differ by batch rank; outputs, aux, the dropped
    fraction and the gradients of the input, the router and the experts
    (``jax.grad``)."""
    ranks = [r[list(LAYOUTS_2).index(layout)] for r in two_ranks[-1]]
    _check_layer(ranks)
    for r in ranks:
        assert r["timings"]["moe_calls"] > 0


def _check_case(case, job, ranks):
    name, data, fsdp, tensor, expert = case[:5]
    assert {r["backend"]["backend"] for r in ranks} == {"gloo"}
    metrics, params = _jax_run(case, job)
    want = _flat(params)
    for r, res in enumerate(ranks):
        got = res["runs"]["eager"]["metrics"]
        for step, (a, b) in enumerate(zip(got, metrics)):
            for key in ("loss", "tokens", "moe_aux", "grad_norm"):
                np.testing.assert_allclose(
                    a[key], b[key], rtol=RTOL,
                    err_msg=f"{name} rank {r} step {step} {key}")
        for leaf, x in _flat(res["params"]).items():
            np.testing.assert_allclose(x, want[leaf], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{name} rank {r} {leaf}")
    # expert and tensor peers (neighbouring ranks) see the same metrics
    # and hold the same bytes of the leaves the axes do not cut
    peers_n = expert * tensor
    for r in range(0, len(ranks), peers_n):
        peers = ranks[r:r + peers_n]
        assert all(p["runs"]["eager"]["metrics"]
                   == peers[0]["runs"]["eager"]["metrics"] for p in peers)
        for leaf in ("final_norm", "layers/attn_norm", "layers/moe_router"):
            for p in peers:
                assert np.array_equal(_flat(p["params"])[leaf],
                                      _flat(peers[0]["params"])[leaf]), leaf


@pytest.mark.parametrize("case", range(len(CASES_2)),
                         ids=[c[0] for c in CASES_2])
def test_moe_trainer_over_two_ranks_matches_jax(two_ranks, case):
    """llama_tiny with 4 experts, top-2, over data=2, fsdp=2, tensor=2 and
    expert=2: losses, tokens, moe_aux and grad norms on every rank, and
    the whole parameters after three steps, against the JAX trainer on
    the same mesh fed the same rows."""
    jobs, _, _, results = two_ranks
    _check_case(CASES_2[case], jobs[case],
                [r[len(LAYOUTS_2) + case] for r in results])


def test_expert_rank_keeps_half_the_experts(two_ranks):
    """What an expert=2 rank keeps (``Trainer.state_bytes``, every tensor
    the trainer reaches): half of every expert leaf and the whole rest,
    for the parameters and adamw's two moments."""
    jobs, _, _, results = two_ranks
    cfg = jobs[3].config
    shapes = _flat_axes(tl.param_shapes(cfg))
    axes = _flat_axes(tl.param_logical_axes(cfg))
    cut = sum(math.prod(s) for k, s in shapes.items() if "expert" in axes[k])
    whole = sum(math.prod(s) for s in shapes.values())
    want = 4 * (whole - cut + cut // 2)
    for r in results:
        run = r[len(LAYOUTS_2) + 3]["runs"]["eager"]
        assert run["state_bytes"]["total"] == run["held_bytes"]
        assert run["state_bytes"]["params"] == want
        assert run["state_bytes"]["grads"] == want
        assert run["state_bytes"]["opt_state"] == 2 * want + 2 * 4


def test_expert_checkpoint_restores_bitwise_into_any_layout(two_ranks):
    """expert=2: ``fit`` to step 4 with a checkpoint every 2 steps, and the
    same stopped at step 2 and resumed, bitwise; the step-4 checkpoint
    (the one-process format) restores bitwise into ONE process and into
    fsdp=2."""
    _, job, root, results = two_ranks
    at = len(LAYOUTS_2) + len(CASES_2)
    world = _check_fit([r[at] for r in results], job, root)
    for r in results:
        restored = r[at + 1]
        assert restored["step"] == 4
        for k, t in restored["state"].items():
            assert torch.equal(t, world[k]), k


def test_adafactor_factors_expert_leaves_on_their_last_two_dims():
    """adafactor's factored moments of an expert leaf [L, E, d, m] run
    over its two largest dims (d and m) and never over the expert dim,
    so an expert=2 rank's moments are its own experts' with no sum over
    the axis; a leaf whose expert dim were among the two would sum its
    mean over ``expert`` (``LeafCut.axis_of``)."""
    cut = optim.LeafCut((2, 8, 128, 256), dim=None, tensor_dim=None,
                        expert_dim=1)
    assert optim._factored_dims(cut.full_shape, 128) == (2, 3)
    assert cut.axes == ("expert",)
    assert cut.axis_of(2) is None and cut.axis_of(3) is None
    assert cut.axis_of(1) == "expert"
    calls = []
    shards = optim.Shards({"w": cut}, lambda t, axes: calls.append(axes)
                          or t)
    tx = optim.adafactor(lambda c: torch.ones(()), shards=shards)
    part = {"w": torch.ones((2, 4, 128, 256))}
    state = tx.init(part)
    assert state[0]["v"]["w"]["v_row"].shape == (2, 4, 128)
    assert state[0]["v"]["w"]["v_col"].shape == (2, 4, 256)
    tx.update({"w": torch.full((2, 4, 128, 256), 0.5)}, state, part)
    # only the block rms (clip, parameter scale) sums over expert
    assert calls == [("expert",), ("expert",)]


def _stub_mesh(**sizes):
    sizes = {"data": 1, "fsdp": 1, "tensor": 1, "expert": 1, **sizes}
    shape = {k: v for k, v in sizes.items()
             if k in ("data", "fsdp") or v > 1}
    return types.SimpleNamespace(size=math.prod(sizes.values()), shape=shape,
                                 device=torch.device("cpu"), **sizes)


def test_expert_divisibility_error_matches_jax():
    """``init_state`` refuses an expert count that expert=2 does not
    divide, before any collective, with the JAX package's message."""
    cfg = tl.llama_tiny(n_experts=3, dtype=torch.float32)
    axes = tl.param_logical_axes(cfg)
    shapes = tl.param_shapes(cfg)
    with pytest.raises(ValueError) as want:
        j_sharding.validate_divisibility(_jax_mesh(1, 1, 1, 2), axes,
                                         shapes)
    trainer = Trainer(lambda g: tl.init_params(g, cfg, device="cpu"),
                      lambda p, b: (None, {}), TrainerConfig(), device="cpu",
                      mesh=_stub_mesh(expert=2), param_axes=axes)
    with pytest.raises(ValueError) as got:
        trainer.init_state()
    assert str(got.value) == str(want.value)
    assert "dim 3 not divisible by mesh axes ('expert',)" in str(got.value)


@pytest.mark.parametrize("mesh,n", [
    ("expert=2", 2), ("data=2,expert=2", 4), ("expert=2,tensor=2", 4),
    ("fsdp=-1,expert=2", 8), ("data=-1,fsdp=2,expert=2", 8),
    ("expert=4", 8)])
def test_world_layout_with_expert_agrees_with_the_reference(mesh, n):
    """``world_layout`` and ``resolve_world_axes`` with ``expert`` against
    the reference's mesh over N devices (``MeshConfig.resolved``)."""
    env = {"KFT_MESH": mesh}
    ref = dict(mesh_from_topology_env(env, devices=jax.devices()[:n]).shape)
    ours = t_boot.world_layout(env, n)
    for axis in ("data", "fsdp", "expert", "tensor"):
        assert ours[axis] == ref[axis], axis
    sizes = {k: int(v) for k, v in (kv.split("=") for kv in mesh.split(","))}
    cfg = MeshConfig(**sizes).resolved(n)
    assert resolve_world_axes(n, sizes.get("data", 1), sizes.get("fsdp", -1),
                              sizes.get("tensor", 1),
                              sizes.get("expert", 1)) == (cfg.data, cfg.fsdp)


def test_expert_axis_errors_match_mesh_config():
    with pytest.raises(ValueError) as want:
        MeshConfig(data=2, fsdp=1, expert=3).resolved(4)
    with pytest.raises(ValueError) as got:
        resolve_world_axes(4, 2, 1, 1, 3)
    assert str(got.value) == str(want.value)

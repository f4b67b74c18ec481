"""Mixture-of-Experts under the ``context`` axis (``parallel/moe.py`` over
the ``tokens`` group, ring and Ulysses attention beside it), alone and
beside ``expert``, ``data``, ``fsdp`` and ``tensor``, against the JAX
package on the CPU, in float32, on the same numpy-seeded inputs.

The port's ranks are spawned as processes that talk over gloo
(``tools/world_train.run``): one world of two processes (``context=2``),
one of four (``data=2``, ``expert=2`` or ``tensor=2`` beside
``context=2``) and one of eight (``fsdp=2 x expert=2 x context=2``), each
running its cases one after another (``world_train.plans_rank``).
Context peers feed the same rows, each its chunk of their tokens; expert
and tensor peers feed the same tokens; the places in the batch axes feed
rows whose loss masks (and, for the layer, token masks) differ.

The oracle is the JAX function on the global batch: the layer's
``moe_layer`` and ``jax.grad`` (GSPMD never changes what it computes),
and the JAX ``Trainer`` on ``build_mesh(MeshConfig(...))`` of the same
layout over conftest's host devices with the loss ``lm_loss_fn(
functools.partial(llama.forward, mesh=mesh), cfg)`` and the same
``attn_impl``. A layer's capacity and slots run over the global micro
batch in row-major token order, so a context rank's pairs sit between
other ranks' (tests/test_torch_moe_world.py's cases; capacity factor 0.5
in the trainer, so tokens drop there too).

Tolerances, each with its reason:
- the layer: tests/test_torch_moe_world.py's (outputs and gradients 1e-5
  absolute on values of order 1, the aux losses 1e-6 relative, the
  dropped fraction exactly: it counts integers);
- the trainer: loss, ``tokens``, ``moe_aux`` and ``grad_norm`` per step
  1e-5 relative, final parameters 2e-5 absolute
  (tests/test_torch_context_training.py's reasons);
- context peers' metrics and parameters, and checkpoints: BITWISE (every
  all-reduce hands its ranks the same bytes; a checkpoint is the same
  bytes, copied).
"""

import dataclasses
import functools

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
from kubeflow_tpu_torch.parallel.mesh import (
    Backend, WorldMesh, resolve_world_axes,
)
from kubeflow_tpu_torch.rendezvous import bootstrap as t_boot
from kubeflow_tpu_torch.tools import world_train as wt
from test_torch_flash_attention import warm_up_cpu_exp
from test_torch_moe_world import (
    AUX_RTOL, LAYER_ATOL, LAYER_CASES, B, E, M, S, _jax_layer, layer_inputs,
)
from test_torch_tensor_training import _check_fit
from test_torch_world_training import PARAM_ATOL, RTOL, STEPS, _flat

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact


# ---------------------------------------------------------------- layer --

# the layer's layouts (data, fsdp, tensor, expert, context)
LAYOUTS_2 = {"context=2": (1, 1, 1, 1, 2)}
LAYOUTS_4 = {"data=2,context=2": (2, 1, 1, 1, 2),
             "expert=2,context=2": (1, 1, 1, 2, 2),
             "context=2,tensor=2": (1, 1, 2, 1, 2)}


def _layer_plan(data, fsdp, tensor, expert, context):
    return (data, fsdp, tensor, expert, context, wt.moe_layer_rank,
            (layer_inputs(0), LAYER_CASES))


def _check_layer(ranks):
    """Each rank's part (its rows, its chunk of their tokens) of the
    output and of the input gradient, the global aux and dropped
    fraction on every rank, and the weights' gradients (summed over the
    tokens ranks, each expert and tensor rank's slice) against the JAX
    layer on the whole inputs."""
    for c, case in enumerate(LAYER_CASES):
        y, aux, gx, gp = _jax_layer(case)
        if case[1] > 0 and case[0] != "capacity-1.25":
            assert aux["moe_dropped_fraction"] > 0, case
        summed: dict = {}
        for r in ranks:
            (i, n), (ic, nc) = r["batch"], r["context"]
            ix, nx = r["expert"]
            it, nt = r["tensor"]
            part = (slice(i * B // n, (i + 1) * B // n),
                    slice(ic * S // nc, (ic + 1) * S // nc))
            got = r["cases"][c]
            np.testing.assert_allclose(got["y"].numpy(), y[part], rtol=0,
                                       atol=LAYER_ATOL, err_msg=case[0])
            np.testing.assert_allclose(got["x"].numpy(), gx[part], rtol=0,
                                       atol=LAYER_ATOL, err_msg=case[0])
            for k in ("moe_load_balance", "moe_router_z"):
                np.testing.assert_allclose(got["aux"][k], aux[k],
                                           rtol=AUX_RTOL, err_msg=k)
            assert got["aux"]["moe_dropped_fraction"] == \
                aux["moe_dropped_fraction"], case[0]
            for k, g in got["grads"].items():
                summed.setdefault((k, ix, nx, it, nt), []).append(g)
        for (k, ix, nx, it, nt), parts in summed.items():
            want = gp[k]
            if k != "router":
                want = want[ix * E // nx:(ix + 1) * E // nx]
                cols = slice(it * M // nt, (it + 1) * M // nt)
                want = want[:, :, cols] if k != "w_down" else want[:, cols]
            np.testing.assert_allclose(sum(parts).numpy(), want, rtol=0,
                                       atol=LAYER_ATOL,
                                       err_msg=f"{case[0]} {k}")


# -------------------------------------------------------------- trainer --

def _moe_tiny(remat, impl, cf):
    return jl.llama_tiny(dtype=jnp.float32, remat=remat, attn_impl=impl,
                         n_experts=4, moe_top_k=2, moe_capacity_factor=cf)


# (case, data, fsdp, tensor, expert, context, remat, attn_impl, capacity
#  factor, TrainerConfig fields)
CASES_2 = [
    ("context-ring-dots-adamw", 1, 1, 1, 1, 2, "dots", "ring", 0.5,
     dict(optimizer="adamw", grad_accum=1)),
    ("context-ulysses-none-adafactor-accum2", 1, 1, 1, 1, 2, "none",
     "ulysses", 0.5, dict(optimizer="adafactor", grad_accum=2)),
]
CASES_4 = [
    ("expert-context-ring-full-adamw-accum2", 1, 1, 1, 2, 2, "full", "ring",
     0.5, dict(optimizer="adamw", grad_accum=2)),
    ("expert-context-ulysses-dots-adafactor", 1, 1, 1, 2, 2, "dots",
     "ulysses", 0.5, dict(optimizer="adafactor", grad_accum=1)),
    ("expert-context-ring-none-adamw-dropless", 1, 1, 1, 2, 2, "none",
     "ring", 0.0, dict(optimizer="adamw", grad_accum=1)),
    ("data-context-ring-dots-adamw", 2, 1, 1, 1, 2, "dots", "ring", 0.5,
     dict(optimizer="adamw", grad_accum=1)),
    ("context-tensor-ring-full-adafactor", 1, 1, 2, 1, 2, "full", "ring",
     0.5, dict(optimizer="adafactor", grad_accum=1)),
]
CASES_8 = [
    ("fsdp-expert-context-ring-dots-adafactor", 1, 2, 1, 2, 2, "dots",
     "ring", 0.5, dict(optimizer="adafactor", grad_accum=1)),
]


def _job(case, **fields):
    *_, remat, impl, cf, kw = case
    jcfg = _moe_tiny(remat, impl, cf)
    host = jax.device_get(jl.init_params(jax.random.key(0), jcfg))
    return wt.Job(interop.config_from_jax(jcfg),
                  dict(warmup_steps=2, total_steps=10, **kw),
                  local_batch=2, seq=16, steps=STEPS, mask=True,
                  params=host, keep_params=True, **fields)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX trainer on case ``name``'s mesh on the global batches,
    micro batch by micro batch as the world groups them, its loss the
    forward with ``mesh=``: per-step metrics and the final
    parameters."""
    case = CASES[name]
    _, data, fsdp, tensor, expert, context, remat, impl, cf, kw = case
    jcfg = _moe_tiny(remat, impl, cf)
    n = data * fsdp * tensor * expert * context
    mesh = build_mesh(MeshConfig(data=data, fsdp=fsdp, tensor=tensor,
                                 expert=expert, context=context),
                      devices=jax.devices()[:n])
    job = _job(case)
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jl.init_params(rng, jcfg),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(
            functools.partial(jl.forward, mesh=mesh), jcfg),
        config=j_trainer.TrainerConfig(warmup_steps=2, total_steps=10, **kw))
    jt.init_state(jax.random.key(0))
    metrics = []
    for step in range(STEPS):
        m = jt.train_step(j_data.put_batch(mesh, wt.global_batch(
            job, data * fsdp, step, kw["grad_accum"])))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat(jax.device_get(jt.params))


CASES = {c[0]: c for c in CASES_2 + CASES_4 + CASES_8}


def _plans(cases):
    return [(*case[1:6], wt.train_rank, (_job(case),)) for case in cases]


def _check_case(case, ranks):
    name, data, fsdp, tensor, expert, context = case[:6]
    assert {r["backend"]["backend"] for r in ranks} == {"gloo"}
    assert [r["backend"]["rank"] for r in ranks] == list(range(len(ranks)))
    metrics, want = _jax_run(name)
    for r, res in enumerate(ranks):
        run = res["runs"]["eager"]
        for step, (a, b) in enumerate(zip(run["metrics"], metrics)):
            for key in ("loss", "tokens", "moe_aux", "grad_norm"):
                np.testing.assert_allclose(
                    a[key], b[key], rtol=RTOL,
                    err_msg=f"{name} rank {r} step {step} {key}")
        for leaf, x in _flat(res["params"]).items():
            np.testing.assert_allclose(x, want[leaf], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{name} rank {r} {leaf}")
        assert run["collectives"][0]["context_calls"] > 0
        assert run["collectives"][0]["moe_calls"] > 0
    # context peers (ranks tensor apart) hold the same state: the same
    # metrics and the same parameters, bitwise
    for r, res in enumerate(ranks):
        peer = ranks[r + tensor if (r // tensor) % 2 == 0 else r - tensor]
        assert res["runs"]["eager"]["metrics"] == \
            peer["runs"]["eager"]["metrics"]
        for leaf, x in _flat(res["params"]).items():
            assert np.array_equal(x, _flat(peer["params"])[leaf]), leaf


def _fit_job():
    return dataclasses.replace(_job(CASES_4[0]), steps=4)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One world of four processes: the layer under each of LAYOUTS_4,
    every case of CASES_4, and ``fit`` with checkpoints under expert=2 x
    context=2."""
    root = tmp_path_factory.mktemp("moe_context4")
    plans = [_layer_plan(*sizes) for sizes in LAYOUTS_4.values()] \
        + _plans(CASES_4) + [
        (1, 1, 1, 2, 2, wt.fit_rank, (_fit_job(), str(root / "ckpt"), 2))]
    results = wt.run(wt.plans_rank, (plans,), 1, 1, ["cpu"] * 4,
                     str(root / "world"), context=4)
    return root, results


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, four_ranks):
    """One world of two processes: the layer under context=2, every case
    of CASES_2, and the expert=2 x context=2 checkpoint restored into
    expert=2."""
    root = tmp_path_factory.mktemp("moe_context2")
    plans = [_layer_plan(*sizes) for sizes in LAYOUTS_2.values()] \
        + _plans(CASES_2) + [
        (1, 1, 1, 2, 1, wt.restore_rank,
         (_fit_job(), str(four_ranks[0] / "ckpt" / "a")))]
    return wt.run(wt.plans_rank, (plans,), 1, 1, ["cpu"] * 2,
                  str(root / "world"), context=2)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """One world of eight processes: every case of CASES_8."""
    root = tmp_path_factory.mktemp("moe_context8")
    return wt.run(wt.plans_rank, (_plans(CASES_8),), 1, 1, ["cpu"] * 8,
                  str(root / "world"), context=8)


@pytest.mark.parametrize("layout", list(LAYOUTS_2) + list(LAYOUTS_4))
def test_layer_over_context_matches_jax(two_ranks, four_ranks, layout):
    """moe_layer over context=2, alone and beside data, expert and tensor,
    against the JAX layer on the global batch: the capacity path with
    drops, the dropless path, the default factor and top-1, with token
    masks that differ by row; outputs, aux, the dropped fraction and the
    gradients of the input, the router and the experts (``jax.grad``).
    A context rank holds chunk c of several rows, so its slots sit
    between the other rank's row by row."""
    if layout in LAYOUTS_2:
        ranks = [r[list(LAYOUTS_2).index(layout)] for r in two_ranks]
    else:
        ranks = [r[list(LAYOUTS_4).index(layout)] for r in four_ranks[1]]
    assert {r["context"][1] for r in ranks} == {2}
    _check_layer(ranks)
    for r in ranks:
        assert r["timings"]["moe_calls"] > 0


@pytest.mark.parametrize("case", range(len(CASES_2)),
                         ids=[c[0] for c in CASES_2])
def test_moe_trainer_over_context_matches_jax(two_ranks, case):
    """llama_tiny with 4 experts, top-2, capacity 0.5, over context=2
    (ring, then Ulysses): losses, tokens, moe_aux and grad norms on both
    ranks, and the whole parameters after three steps, against the JAX
    trainer on MeshConfig(context=2) fed the same rows."""
    _check_case(CASES_2[case], [r[len(LAYOUTS_2) + case] for r in two_ranks])


@pytest.mark.parametrize("case", range(len(CASES_4)),
                         ids=[c[0] for c in CASES_4])
def test_moe_trainer_beside_expert_data_tensor_matches_jax(four_ranks, case):
    """The same over four ranks: expert=2 x context=2 (ring and Ulysses,
    the capacity path and the dropless one), data=2 x context=2 and
    context=2 x tensor=2, against the JAX trainer on the same mesh."""
    _check_case(CASES_4[case],
                [r[len(LAYOUTS_4) + case] for r in four_ranks[1]])


@pytest.mark.parametrize("case", range(len(CASES_8)),
                         ids=[c[0] for c in CASES_8])
def test_moe_trainer_beside_fsdp_and_expert_matches_jax(eight_ranks, case):
    """fsdp=2 x expert=2 x context=2 (ZeRO-3 of each rank's expert
    slices, the ring over context): the same against the JAX trainer."""
    _check_case(CASES_8[case], [r[case] for r in eight_ranks])


def test_expert_context_checkpoint_restores_bitwise_into_other_layouts(
        two_ranks, four_ranks):
    """expert=2 x context=2: ``fit`` to step 4 with a checkpoint every 2
    steps, and the same stopped at step 2 and resumed, bitwise; the
    step-4 checkpoint (the coordinator's, gathered over the expert cut)
    restores bitwise into ONE process and into expert=2."""
    root, results = four_ranks
    at = len(LAYOUTS_4) + len(CASES_4)
    world = _check_fit([r[at] for r in results], _fit_job(), root)
    for r in two_ranks:
        restored = r[len(LAYOUTS_2) + len(CASES_2)]
        assert restored["step"] == 4
        assert restored["state"].keys() == world.keys()
        for k, t in restored["state"].items():
            assert torch.equal(t, world[k]), k


# --------------------------------------------------------------- layout --

@pytest.mark.parametrize("mesh,n", [
    ("expert=2,context=2", 4), ("data=2,expert=2,context=2", 8),
    ("fsdp=-1,expert=2,context=2", 8), ("expert=2,context=2,tensor=2", 8),
    ("expert=4,context=2", 8)])
def test_world_layout_with_expert_and_context_agrees_with_the_reference(
        mesh, n):
    """``world_layout`` and ``resolve_world_axes`` of ``KFT_MESH`` with
    ``expert`` beside ``context`` against the reference's mesh over N
    devices (``MeshConfig.resolved``)."""
    env = {"KFT_MESH": mesh}
    ref = dict(mesh_from_topology_env(env, devices=jax.devices()[:n]).shape)
    ours = t_boot.world_layout(env, n)
    for axis in ("data", "fsdp", "expert", "context", "tensor"):
        assert ours[axis] == ref[axis], axis
    sizes = {k: int(v) for k, v in (kv.split("=") for kv in mesh.split(","))}
    cfg = MeshConfig(**sizes).resolved(n)
    assert resolve_world_axes(
        n, sizes.get("data", 1), sizes.get("fsdp", -1),
        sizes.get("tensor", 1), sizes.get("expert", 1),
        sizes.get("context", 1)) == (cfg.data, cfg.fsdp)


def _world(monkeypatch, rank, **sizes):
    """A ``WorldMesh`` of ``sizes`` at ``rank`` without its process
    groups (its members are arithmetic)."""
    monkeypatch.setattr(WorldMesh, "_make_groups", lambda self: None)
    sizes = {"data": 1, "fsdp": 1, **sizes}
    return WorldMesh(sizes.pop("data"), sizes.pop("fsdp"), rank, "cpu",
                     Backend("gloo", "test"), **sizes)


@pytest.mark.parametrize("sizes", [
    dict(expert=2, context=2), dict(data=2, expert=2, context=2),
    dict(fsdp=2, expert=2, context=2, tensor=2)])
def test_groups_under_expert_and_context(monkeypatch, sizes):
    """Every rank of a world with ``expert`` beside ``context`` sits at
    rank ((d*F + f)*X + x)*C + c)*T + t; its ``tokens`` group holds the
    ranks of its expert and tensor index in (batch, context) order,
    ``data_context`` those of its fsdp too, ``rows`` the ranks of its
    (data, fsdp, context), ``replica`` and ``fsdp_expert`` never span
    ``context``, and its ``context`` group (the ring's and Ulysses'
    collectives) shares its expert index and its experts."""
    n = 1
    for v in sizes.values():
        n *= v
    worlds = [_world(monkeypatch, r, **sizes) for r in range(n)]
    w0 = worlds[0]
    for r, w in enumerate(worlds):
        d, f, x, c, t = (w.data_index, w.fsdp_index, w.expert_index,
                         w.context_index, w.tensor_index)
        assert r == (((d * w0.fsdp + f) * w0.expert + x) * w0.context
                     + c) * w0.tensor + t
        assert w.axis_index("tokens") == w.axis_index("batch") \
            * w0.context + c
        assert w.axis_size("tokens") == w0.data * w0.fsdp * w0.context
        for group, same in (("tokens", "xt"), ("data_context", "fxt"),
                            ("rows", "dfc"), ("replica", "dc"),
                            ("fsdp_expert", "dct"), ("context", "dfxt")):
            for p in w._members[group]:
                q = worlds[p]
                coords = {"d": q.data_index, "f": q.fsdp_index,
                          "x": q.expert_index, "c": q.context_index,
                          "t": q.tensor_index}
                mine = {"d": d, "f": f, "x": x, "c": c, "t": t}
                assert all(coords[a] == mine[a] for a in same), (group, r, p)
        assert len(w._members["context"]) == w0.context

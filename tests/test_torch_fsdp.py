"""ZeRO-3 under ``fsdp`` (``parallel/fsdp.py``, ``Trainer`` over a
``WorldMesh``, ``models/llama.forward``'s layer accessor) on the CPU in
float32.

On one process, ``fsdp.PlainGroup`` stands in for the ``fsdp`` axis: the
gather Function's loss and gradient parts against the unsharded tree's
and against the plain version (the whole leaves as ``torch.cat`` of the
ranks' parts), under each remat mode, tied and untied; and what autograd
keeps of the gathered weights. Over worlds of spawned processes talking
over gloo (``tools/world_train``, as tests/test_torch_world_training.py
runs them): ``fsdp=2`` and ``data=2 x fsdp=2`` against the JAX trainer
on the same mesh under remat "none", "full" and "dots"; the bytes a rank
keeps; a ZeRO-3 checkpoint restored into ``fsdp=2``, ``data=2`` and one
process.

Tolerances, each with its reason:
- one process: BITWISE (the same products on the same whole weights;
  the gather and the reduce-scatter only copy, and the plain version's
  cut is a copy too);
- against the JAX trainer: tests/test_torch_world_training.py's (loss,
  tokens and grad norm 1e-5 relative, parameters 2e-5 absolute);
- kept bytes: exact (1/2 of ``data``'s to the byte, adamw's two 0-d
  counts aside);
- checkpoints: BITWISE (the same bytes, copied).
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel import fsdp, sharding
from kubeflow_tpu_torch.tools import world_train as wt
from kubeflow_tpu_torch.training import CheckpointManager, optim
from kubeflow_tpu_torch.training import restore_latest
from test_torch_flash_attention import warm_up_cpu_exp
from test_torch_world_training import _assert_matches, _jax_run, _job

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

REMATS = ("none", "full", "dots")


def _tiny(remat, **fields):
    return dataclasses.replace(jl.llama_tiny(dtype=jnp.float32, remat=remat),
                               **fields)


# ---------------------------------------------------------------- one process

def _plain_ranks(cfg, whole, n=2):
    """n ranks' ``FsdpParams`` of ``whole`` in one process, each served by
    a ``PlainGroup`` over all of them."""
    ranks: list = []
    for r in range(n):
        ranks.append(fsdp.FsdpParams(whole, tl.param_logical_axes(cfg), None,
                                     fsdp.PlainGroup(n, r, ranks)))
    return ranks


def _plain_whole(ranks, r):
    """The plain version for rank ``r``: every rank's parts as leaves
    that record gradients, the whole tree as their ``torch.cat``; returns
    (the whole tree, rank r's part leaves)."""
    parts = [optim.tree_map(lambda p: p.detach().clone().requires_grad_(
        i == r), fp.parts) for i, fp in enumerate(ranks)]
    whole = optim.tree_map(
        lambda d, *ps: sharding.fsdp_unshard(ps, d), ranks[r].dims, *parts)
    return whole, parts[r]


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("remat", REMATS)
def test_gather_gradients_match_the_unsharded_leaf_and_the_plain_version(
        remat, tie):
    """On one process, for each of two ranks: the loss through the rank's
    ``FsdpParams`` (each layer gathered inside its block, the rest once)
    and the gradient parts its reduce-scatters add, against the whole
    tree's loss and its gradients cut to the rank's part, and against
    the plain version's (``torch.cat`` of the parts, whose backward is
    the cut). The stacked leaves' parts are strided views across the
    layer units; ``wo`` and ``w_down`` are cut on their last dim."""
    cfg = dataclasses.replace(
        tl.llama_tiny(dtype=torch.float32, attn_impl="pallas", remat=remat),
        tie_embeddings=tie)
    whole = tl.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    ref = optim.tree_map(lambda t: t.clone().requires_grad_(True), whole)
    want = tl.forward(ref, tokens, cfg).square().mean()
    want.backward()
    ranks = _plain_ranks(cfg, whole)
    for r, fp in enumerate(ranks):
        got = tl.forward(fp, tokens, cfg).square().mean()
        got.backward()
        plain, plain_parts = _plain_whole(ranks, r)
        tl.forward(plain, tokens, cfg).square().mean().backward()
        assert torch.equal(got, want), (r, got, want)
        dims = optim.named_leaves(fp.dims)
        refs = optim.named_leaves(ref)
        for k, g in optim.named_leaves(fp.grads).items():
            cut = sharding.axis_shard(refs[k].grad, dims[k], r, 2, "fsdp")
            assert torch.equal(g, cut), (r, k)
            assert torch.equal(g, optim.named_leaves(plain_parts)[k].grad), \
                (r, k)
        for k, p in optim.named_leaves(fp.parts).items():
            assert torch.equal(p, sharding.axis_shard(refs[k].detach(),
                                                      dims[k], r, 2,
                                                      "fsdp")), k
        assert fp.flat.grad is None


@pytest.mark.parametrize("remat", REMATS)
def test_remat_gathers_again_instead_of_keeping_the_whole_weights(remat):
    """What autograd keeps of the gathered layer weights for the backward
    (tensors saved outside the checkpointed blocks), and how often each
    unit is gathered: under "full" and "dots" nothing of a whole layer
    weight is saved and each layer is gathered again in the backward
    (2 L + 1 gathers: "dots" saves the ``mm`` outputs, and ``mm``'s own
    inputs, the weights among them, are recomputed); under "none" every
    whole layer weight is saved and gathered once (L + 1). Every unit is
    reduce-scattered once. Shapes are chosen so no activation has a
    layer weight's element count (B=1, S=4: at most 1024 elements)."""
    cfg = tl.llama_tiny(dtype=torch.float32, attn_impl="pallas", remat=remat)
    whole = tl.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    fp = _plain_ranks(cfg, whole)[0]
    sizes = {v.numel() // cfg.n_layers
             for k, v in whole["layers"].items() if v.dim() > 2}
    saved: list = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        loss = tl.forward(fp, torch.zeros((1, 4), dtype=torch.long),
                          cfg).square().mean()
    assert fp.timings["gathers"] == cfg.n_layers + 1
    loss.backward()
    kept = sizes & set(saved)
    L = cfg.n_layers
    if remat == "none":
        assert kept == sizes and fp.timings["gathers"] == L + 1
    else:
        assert not kept and fp.timings["gathers"] == 2 * L + 1
    assert fp.timings["scatters"] == L + 1
    layer, rest = (fp.n * 4 * fp._layer_numel, fp.n * 4 * fp._rest_numel)
    assert fp.timings["gather_bytes"] \
        == (fp.timings["gathers"] - 1) * layer + rest
    assert fp.timings["scatter_bytes"] == L * layer + rest


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_strided_layer_parts_as_contiguous_ones(name):
    """The optimizer over a rank's parts as the trainer keeps them (the
    stacked leaves strided across the layer units of one flat buffer)
    against the same parts as contiguous tensors of their own, three
    steps on the same gradients: bitwise. ``Shards`` sums over a group
    of one here, so both sides reduce the same parts (at dim 128 and
    mlp 256 every matrix factors under adafactor)."""
    from kubeflow_tpu_torch.training import TrainerConfig, make_optimizer

    cfg = dataclasses.replace(tl.llama_tiny(dtype=torch.float32), dim=128,
                              mlp_dim=256)
    whole = tl.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    fp = _plain_ranks(cfg, whole)[0]
    assert not fp.parts["layers"]["wq"].is_contiguous()
    cuts = optim.tree_map(lambda s, d: optim.LeafCut(s, d), fp.shapes,
                          fp.dims)
    tx = make_optimizer(TrainerConfig(optimizer=name, warmup_steps=2,
                                      total_steps=10),
                        optim.Shards(cuts, lambda t, axes: t))
    own = optim.tree_map(lambda p: p.clone(), fp.parts)
    s_views, s_own = tx.init(fp.parts), tx.init(own)
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        g = optim.tree_map(lambda p: torch.randn(p.shape, generator=gen),
                           own)
        optim.tree_map(lambda dst, src: dst.copy_(src), fp.grads, g)
        up, _ = tx.update(fp.grads, s_views, fp.parts)
        optim.apply_updates(fp.parts, up)
        up, _ = tx.update(g, s_own, own)
        optim.apply_updates(own, up)
    for k, p in optim.named_leaves(own).items():
        assert torch.equal(optim.named_leaves(fp.parts)[k], p), k
    for k, t in optim.named_leaves(s_own).items():
        assert torch.equal(optim.named_leaves(s_views)[k], t), k


# --------------------------------------------------------------- two processes

# (case, data, fsdp, JAX config, TrainerConfig fields): each remat mode
# under fsdp=2, an untied head, and a data=2 run of the first config for
# the bytes a rank keeps
CASES = [
    ("fsdp-none-adamw-accum2", 1, 2, lambda: _tiny("none"),
     dict(optimizer="adamw", grad_accum=2)),
    ("fsdp-full-untied-adamw", 1, 2,
     lambda: _tiny("full", tie_embeddings=False),
     dict(optimizer="adamw", grad_accum=1)),
    ("fsdp-dots-adafactor", 1, 2,
     lambda: _tiny("dots", dim=128, mlp_dim=256),
     dict(optimizer="adafactor", grad_accum=1)),
    ("data-none-adamw-accum2", 2, 1, lambda: _tiny("none"),
     dict(optimizer="adamw", grad_accum=2)),
]


@pytest.fixture(scope="module")
def zero3_world(tmp_path_factory):
    """One world of two processes: every case of CASES, then ``fit`` to
    step 4 under fsdp=2 with a checkpoint every 2 steps, then that
    checkpoint's newest step restored by fresh trainers as data=2 and as
    fsdp=2."""
    root = tmp_path_factory.mktemp("zero3")
    jobs = [_job(cfg(), kw) for _, _, _, cfg, kw in CASES]
    fit_job = wt.Job(**{**jobs[0].__dict__, "steps": 4})
    ckpt = str(root / "ckpt")
    plans = [(d, f, wt.train_rank, (job,))
             for (_, d, f, _, _), job in zip(CASES, jobs)]
    plans += [(1, 2, wt.fit_rank, (fit_job, ckpt, 2)),
              (2, 1, wt.restore_rank, (fit_job, ckpt + "/a")),
              (1, 2, wt.restore_rank, (fit_job, ckpt + "/a"))]
    results = wt.run(wt.plans_rank, (plans,), 1, 2, ["cpu"] * 2,
                     str(root / "world"))
    return jobs, fit_job, ckpt, results


@pytest.mark.parametrize("case", range(len(CASES) - 1),
                         ids=[c[0] for c in CASES[:-1]])
def test_zero3_matches_the_jax_trainer(zero3_world, case):
    """fsdp=2 under each remat mode: losses, tokens and grad norms of the
    global batch on every rank, and every rank's whole parameters
    (gathered) after three steps, against the JAX trainer on the same
    mesh fed the global batches."""
    jobs, _, _, results = zero3_world
    name, data, fsdp_n, cfg, kw = CASES[case]
    ranks = [r[case] for r in results]
    metrics, params = _jax_run(cfg(), kw, jobs[case], data, fsdp_n)
    _assert_matches(ranks, metrics, params, name)


def test_zero3_rank_keeps_half_of_every_kind(zero3_world):
    """Under fsdp=2 a rank keeps exactly half of ``data=2``'s parameter
    and gradient bytes, and half of its adamw moments (the two 0-d int32
    counts are whole on each rank), counted by ``Trainer.state_bytes``
    and equal to what the trainer reaches; no tensor it reaches has the
    shape of a whole parameter, where a data rank reaches each."""
    jobs, _, _, results = zero3_world
    kept = {}
    for i in (0, len(CASES) - 1):
        for res in results:
            run = res[i]["runs"]["eager"]
            assert run["state_bytes"]["total"] == run["held_bytes"]
        kept[CASES[i][0]] = results[0][i]["runs"]["eager"]
    fsdp_run, data_run = kept[CASES[0][0]], kept[CASES[-1][0]]
    z3, whole = fsdp_run["state_bytes"], data_run["state_bytes"]
    counts = 2 * 4
    assert 2 * z3["params"] == whole["params"] > 0
    assert 2 * z3["grads"] == whole["grads"] == whole["params"]
    assert 2 * (z3["opt_state"] - counts) == whole["opt_state"] - counts
    assert z3["other"] == whole["other"]
    shapes = tl.param_shapes(jobs[0].config)
    shapes = set(shapes.pop("layers").values()) | set(shapes.values())
    assert not shapes & set(fsdp_run["held_shapes"])
    assert shapes <= set(data_run["held_shapes"])


def test_zero3_checkpoint_restores_bitwise_into_any_layout(zero3_world):
    """The checkpoint that fsdp=2 wrote at step 4 (the coordinator alone,
    in the one-process format) restored by fresh trainers as fsdp=2, as
    data=2 and in one process: each holds, bitwise, the whole state the
    fsdp=2 world gathered at step 4."""
    _, fit_job, ckpt, results = zero3_world
    n = len(CASES)
    want = results[0][n]["a"]["state"]
    for label, i in (("data=2", n + 1), ("fsdp=2", n + 2)):
        for r, res in enumerate(results):
            got = res[i]
            assert got["step"] == 4 and got["state"].keys() == want.keys()
            for k, t in got["state"].items():
                assert torch.equal(t, want[k]), (label, r, k)
    one = wt.make_trainer(fit_job, torch.device("cpu"))
    mgr = CheckpointManager(ckpt + "/a")
    assert restore_latest(one, mgr) == 4
    mgr.close()
    mine = optim.named_leaves({"params": one.params,
                               "opt_state": one.opt_state})
    assert mine.keys() == want.keys()
    for k, t in mine.items():
        assert torch.equal(t.detach(), want[k]), k


# -------------------------------------------------------------- four processes

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """data=2 x fsdp=2 over four processes, one run a remat mode."""
    jobs = [_job(_tiny(remat), dict(optimizer="adamw", grad_accum=1))
            for remat in REMATS]
    results = wt.run(wt.plans_rank, ([(2, 2, wt.train_rank, (job,))
                                      for job in jobs],),
                     2, 2, ["cpu"] * 4, str(tmp_path_factory.mktemp("w4")))
    return jobs, results


@pytest.mark.parametrize("remat", REMATS)
def test_data_and_fsdp_zero3_matches_the_jax_trainer(four_ranks, remat):
    """data=2 x fsdp=2: each layer gathered and reduce-scattered over
    fsdp inside the micro bodies, the gradient parts all-reduced over
    data; against the JAX trainer on the same mesh."""
    jobs, results = four_ranks
    i = REMATS.index(remat)
    assert [r[i]["backend"]["rank"] for r in results] == [0, 1, 2, 3]
    metrics, params = _jax_run(_tiny(remat), dict(optimizer="adamw",
                                                  grad_accum=1),
                               jobs[i], 2, 2)
    _assert_matches([r[i] for r in results], metrics, params,
                    f"data=2,fsdp=2 remat={remat}")

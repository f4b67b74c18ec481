"""Training under the ``tensor`` axis (Megatron's column and row cuts,
``parallel/tensor.py``), alone and beside ``data`` and ``fsdp``, against
the JAX package's trainer on the CPU, in float32, on the same
numpy-seeded rows.

The port's ranks are spawned as processes that talk over gloo
(``tools/world_train.run``, as tests/test_torch_world_training.py runs
them): one world of two processes (``tensor=2``) and one of four
(``data=2, tensor=2`` and ``fsdp=2, tensor=2``), each running all its
cases one after another (``world_train.plans_rank``). Tensor peers feed
the same rows; the places in the batch axes feed rows whose loss masks'
density differs. The oracle is the JAX ``Trainer`` on
``build_mesh(MeshConfig(data=, fsdp=, tensor=))`` over conftest's host
devices, fed the global batch, from the same weights
(``interop.params_from_jax``). JAX side attention "xla", port side
"pallas" (its plain path on the CPU). The cases cover remat "none",
"full" and "dots", adamw and adafactor, tied and untied heads.

Tolerances, each with its reason:
- loss, ``tokens`` and ``grad_norm`` per step: 1e-5 relative (float32
  sums over the ranks' partial products and partial sums, in another
  order than XLA's);
- final parameters: 2e-5 absolute (three updates of at most lr = 3e-4;
  tests/test_torch_training.py's reason);
- one micro batch's gradients against ``jax.grad``: 1e-5 absolute on
  entries up to ~7 (the token-weighted sum over the micro batch's 19
  tokens; float32 sums over the rows and over the ranks' partial
  products in another order read 5.5e-6);
- the four collectives on float64 slices against the unsharded float64
  function and ``jax.grad``: 1e-12 absolute (a sum of two partial
  products against one product, in float64);
- the optimizer on fsdp and tensor parts against the whole tree's
  update on the same rank: 1e-6 absolute
  (tests/test_torch_world_training.py's reason);
- a leaf no axis cuts (the norms), tensor peers' metrics, and
  checkpoints: BITWISE (the same bytes: the all-reduced gradients and
  sums, and copies).
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.api.types import ConditionType, RunPolicy
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.parallel import sharding as j_sharding
from kubeflow_tpu.parallel.mesh import mesh_from_topology_env
from kubeflow_tpu.training import data as j_data
from kubeflow_tpu.training import trainer as j_trainer
from kubeflow_tpu.training.metrics import read_metrics
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel import mesh as t_mesh
from kubeflow_tpu_torch.parallel import tensor as t_tensor
from kubeflow_tpu_torch.parallel.mesh import resolve_world_axes
from kubeflow_tpu_torch.rendezvous import bootstrap as t_boot
from kubeflow_tpu_torch.tools import world_train as wt
from kubeflow_tpu_torch.training import (
    CheckpointManager, Trainer, TrainerConfig, lm_loss_fn, optim,
    restore_latest,
)
from test_torch_flash_attention import warm_up_cpu_exp
from test_torch_world_training import PARAM_ATOL, RTOL, STEPS, _flat

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

GRAD_ATOL = 1e-5
F64_ATOL = 1e-12
OPT_ATOL = 1e-6


# Rank bodies of the worlds below (``world_train.run`` pickles them by
# name, so they live at the module's top level).

def grads_rank(mesh, job) -> dict:
    """One step's micro bodies on this rank's rows of step 0, without the
    finish: the gradient accumulators as this rank keeps them
    (token-weighted sums over its micro batches, before any reduction
    over the world), by name, on the host."""
    trainer = wt.make_trainer(job, mesh.device, mesh)
    trainer._stage(wt.rows_for(job, 0, mesh.axis_index("batch")))
    for _ in range(trainer.config.grad_accum):
        trainer._micro_body()
    return {k: g.detach().cpu()
            for k, g in optim.named_leaves(trainer._grads()).items()}


def collectives_rank(mesh, seed: int = 0) -> dict:
    """The ``tensor`` axis's four collectives (``parallel/tensor.py``),
    each on this rank's slice of a seeded whole weight in float64, into
    a scalar loss weighing every output element, and its backward:
    ``copy`` into a column-parallel product (the loss of the rank's
    columns), ``reduce`` of a row-parallel one, ``vocab_lookup`` and
    ``gather_vocab`` of the head's columns after ``copy``. Returns, per
    collective, the output and the gradients of the input (``x``) and of
    the rank's slice (``w``) on the host, and ``inputs``: the whole
    tensors (``COLLECTIVE_SLICES`` says which dim each case cuts)."""
    n, i = mesh.axis_size("tensor"), mesh.axis_index("tensor")
    inputs = collective_inputs(seed)
    x = inputs["x"]
    out, grads = {}, {}
    for name, dim in COLLECTIVE_SLICES.items():
        whole = inputs[name]
        k = whole.shape[dim] // n
        w = whole.narrow(dim, i * k, k).clone().requires_grad_(True)
        xi = x.clone().requires_grad_(True)
        weight = inputs["weights"][name]
        if name == "copy":
            y = t_tensor.copy(xi, mesh) @ w
            weight = weight[:, i * k:(i + 1) * k]
        elif name == "reduce":
            y = t_tensor.reduce(xi[:, i * k:(i + 1) * k] @ w, mesh)
        elif name == "lookup":
            y = t_tensor.vocab_lookup(w, inputs["tokens"], mesh,
                                      torch.float64)
        else:
            y = t_tensor.gather_vocab(t_tensor.copy(xi, mesh) @ w, mesh)
        (y * weight).sum().backward()
        out[name] = y.detach()
        grads[name] = {"x": xi.grad, "w": w.grad}
    return {"index": i, "n": n, "out": out, "grads": grads,
            "timings": dict(mesh.timings)}


# the whole weight of each case of collectives_rank, and the dim its
# tensor slices cut
COLLECTIVE_SLICES = {"copy": 1, "reduce": 0, "lookup": 0, "gather": 1}


def collective_inputs(seed: int = 0) -> dict:
    """``collectives_rank``'s whole inputs (float64, from ``seed``): x
    [3, 8]; the weights copy [8, 6], reduce [8, 5], lookup [10, 8] (a
    vocab of 10), gather [8, 10]; tokens [2, 4]; and the loss's weight
    on each whole output."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape))
    out = {"x": t(3, 8), "copy": t(8, 6), "reduce": t(8, 5),
           "lookup": t(10, 8), "gather": t(8, 10),
           "tokens": torch.tensor([[0, 3, 9, 5], [7, 7, 1, 4]])}
    out["weights"] = {"copy": t(3, 6), "reduce": t(3, 5),
                      "lookup": t(2, 4, 8), "gather": t(3, 10)}
    return out


# the elements of pieces_rank's tensors: 6 MB and 3 MB of float32, more
# than one gloo piece of GLOO_MIN_PIECE_BYTES and less than one of
# GLOO_PIECE_BYTES, so each call is cut into one piece a lane
PIECES_NUMEL = (3 << 19) + 5, (3 << 18) + 1


def pieces_rank(mesh) -> dict:
    """The gloo collectives over ``tensor`` on tensors of PIECES_NUMEL
    elements, each rank's drawn from its index: the all-reduce, the
    all-gather and the reduce-scatter of them, on the host."""
    n, i = mesh.axis_size("tensor"), mesh.axis_index("tensor")
    big, part = PIECES_NUMEL
    rng = np.random.default_rng(i)
    x = torch.tensor(rng.standard_normal(big).astype(np.float32))
    y = torch.tensor(rng.standard_normal(part).astype(np.float32))
    z = torch.tensor(rng.standard_normal(n * part).astype(np.float32))
    gathered = torch.empty(n * part)
    scattered = torch.empty(part)
    return {"x": x, "y": y, "z": z,
            "all_reduce": mesh.all_reduce(x.clone(), "tensor"),
            "all_gather": mesh.all_gather(gathered, y, "tensor"),
            "reduce_scatter": mesh.reduce_scatter(scattered, z.clone(),
                                                  "tensor")}


def _tiny(remat, **fields):
    return dataclasses.replace(jl.llama_tiny(dtype=jnp.float32, remat=remat),
                               **fields)


def _factored(remat, **fields):
    """dim 128 and mlp 256: the embedding and the MLP weights factor
    under adafactor, on dims that ``tensor`` (and ``fsdp``) cut."""
    return jl.LlamaConfig(**{
        **dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
               n_kv_heads=2, mlp_dim=256, max_seq=64, rope_scaling=None,
               tie_embeddings=True, dtype=jnp.float32, remat=remat),
        **fields})


# (case, data, fsdp, tensor, JAX config, TrainerConfig fields)
CASES_2 = [
    ("tensor-none-adamw-accum2", 1, 1, 2, lambda: _tiny("none"),
     dict(optimizer="adamw", grad_accum=2)),
    ("tensor-full-untied-adafactor", 1, 1, 2,
     lambda: _factored("full", tie_embeddings=False),
     dict(optimizer="adafactor", grad_accum=1)),
    ("tensor-dots-adafactor-accum2", 1, 1, 2, lambda: _factored("dots"),
     dict(optimizer="adafactor", grad_accum=2)),
]
CASES_4 = [
    ("data-tensor-full-adafactor", 2, 1, 2, lambda: _factored("full"),
     dict(optimizer="adafactor", grad_accum=1)),
    ("fsdp-tensor-dots-adamw-accum2", 1, 2, 2, lambda: _tiny("dots"),
     dict(optimizer="adamw", grad_accum=2)),
    ("fsdp-tensor-none-untied-adafactor", 1, 2, 2,
     lambda: _factored("none", tie_embeddings=False),
     dict(optimizer="adafactor", grad_accum=1)),
]
# the optimizer on parts: fsdp cuts "a" and "b" on 0 and "c" on 1,
# tensor "a" and "b" on 1 and "c" on 2 (the factored means of "c" run
# over both axes: 128 on fsdp, 256 on tensor); "d" does not factor
OPT_SHAPES = {"a": (256, 128), "b": (128, 256), "c": (4, 128, 256),
              "d": (200,)}
OPT_FSDP = {"a": 0, "b": 0, "c": 1, "d": 0}
OPT_TENSOR = {"a": 1, "b": 1, "c": 2, "d": None}


def _job(jcfg, trainer_kw, **fields):
    host = jax.device_get(jl.init_params(jax.random.key(0), jcfg))
    tcfg = interop.config_from_jax(jcfg)
    tcfg = tl.LlamaConfig(**{**tcfg.__dict__, "attn_impl": "pallas"})
    return wt.Job(tcfg, dict(warmup_steps=2, total_steps=10, **trainer_kw),
                  local_batch=2, seq=16, steps=STEPS, mask=True,
                  params=host, keep_params=True, **fields)


def _jax_mesh(data, fsdp, tensor):
    return build_mesh(MeshConfig(data=data, fsdp=fsdp, tensor=tensor),
                      devices=jax.devices()[:data * fsdp * tensor])


def _jax_run(jcfg, trainer_kw, job, data, fsdp, tensor):
    """The JAX trainer on data x fsdp x tensor host devices on the
    global batches: per-step metrics and the final parameters."""
    mesh = _jax_mesh(data, fsdp, tensor)
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jl.init_params(rng, jcfg),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(jl.forward, jcfg),
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
    return [(d, f, t, wt.train_rank, (job,))
            for (_, d, f, t, _, _), job in zip(cases, jobs)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One world of two processes (``tensor=2``): every case of CASES_2,
    one step's gradients, the four collectives, the optimizer on tensor
    parts, ``fit`` with checkpoints, the checkpoint restored into
    ``fsdp=2``, and gloo calls cut into one piece a lane."""
    root = tmp_path_factory.mktemp("tensor2")
    jobs = [_job(cfg(), kw) for *_, cfg, kw in CASES_2]
    fit_job = dataclasses.replace(jobs[0], steps=4)
    grads_job = _job(_tiny("none"), dict(optimizer="adamw", grad_accum=1))
    plans = _plans(CASES_2, jobs) + [
        (1, 1, 2, grads_rank, (grads_job,)),
        (1, 1, 2, collectives_rank, ()),
        (1, 1, 2, wt.optimizer_rank,
         (OPT_SHAPES, {}, "adafactor", STEPS, 0, OPT_TENSOR)),
        (1, 1, 2, wt.fit_rank, (fit_job, str(root / "ckpt"), 2)),
        (1, 2, 1, wt.restore_rank, (fit_job, str(root / "ckpt" / "a"))),
        (1, 1, 2, pieces_rank, ()),
    ]
    results = wt.run(wt.plans_rank, (plans,), 1, 1, ["cpu"] * 2,
                     str(root / "world"), tensor=2)
    return jobs, grads_job, fit_job, root, results


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One world of four processes: every case of CASES_4, the optimizer
    on fsdp x tensor parts, and ``fit`` with checkpoints under fsdp=2 x
    tensor=2 (adafactor: factored moments cut on both axes)."""
    root = tmp_path_factory.mktemp("tensor4")
    jobs = [_job(cfg(), kw) for *_, cfg, kw in CASES_4]
    fit_job = dataclasses.replace(jobs[2], steps=4)
    plans = _plans(CASES_4, jobs) + [
        (1, 2, 2, wt.optimizer_rank,
         (OPT_SHAPES, OPT_FSDP, "adafactor", STEPS, 0, OPT_TENSOR)),
        (1, 2, 2, wt.fit_rank, (fit_job, str(root / "ckpt"), 2))]
    results = wt.run(wt.plans_rank, (plans,), 1, 1, ["cpu"] * 4,
                     str(root / "world"), tensor=4)
    return jobs, results, fit_job, root


def _check_case(case, job, ranks):
    name, data, fsdp, tensor, cfg, kw = case
    assert {r["backend"]["backend"] for r in ranks} == {"gloo"}
    metrics, params = _jax_run(cfg(), kw, job, data, fsdp, tensor)
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
    # tensor peers (neighbouring ranks) see the same metrics, bitwise,
    # and hold the same bytes of the leaves no axis cuts
    for r in range(0, len(ranks), tensor):
        peers = ranks[r:r + tensor]
        assert all(p["runs"]["eager"]["metrics"]
                   == peers[0]["runs"]["eager"]["metrics"] for p in peers)
        for leaf in ("final_norm", "layers/attn_norm", "layers/mlp_norm"):
            for p in peers:
                assert np.array_equal(_flat(p["params"])[leaf],
                                      _flat(peers[0]["params"])[leaf]), leaf
    # tokens counted once: the global batch's count, each place in the
    # batch axes with its own ragged mask
    places = data * fsdp
    counts = [int(wt.batch_for(job, 0, i)["mask"][:, 1:].sum())
              for i in range(places)]
    assert ranks[0]["runs"]["eager"]["metrics"][0]["tokens"] == sum(counts)
    if places > 1:
        assert counts[0] != counts[1]


@pytest.mark.parametrize("case", range(len(CASES_2)),
                         ids=[c[0] for c in CASES_2])
def test_tensor_world_matches_the_jax_trainer(two_ranks, case):
    """tensor=2: losses, tokens and grad norms on every rank, and the
    whole parameters after three steps, against the JAX trainer on
    MeshConfig(tensor=2) fed the same rows."""
    jobs, _, _, _, results = two_ranks
    _check_case(CASES_2[case], jobs[case], [r[case] for r in results])


@pytest.mark.parametrize("case", range(len(CASES_4)),
                         ids=[c[0] for c in CASES_4])
def test_tensor_beside_data_and_fsdp_matches_the_jax_trainer(four_ranks,
                                                             case):
    """data=2 x tensor=2 and fsdp=2 x tensor=2 (ZeRO-3 of each rank's
    tensor slice): the same against the JAX trainer on the same mesh,
    with ragged masks that differ by place in the batch axes."""
    jobs, results, _, _ = four_ranks
    ranks = [r[case] for r in results]
    assert [r["backend"]["rank"] for r in ranks] == [0, 1, 2, 3]
    _check_case(CASES_4[case], jobs[case], ranks)


def test_gradients_match_jax_grad_and_norms_match_on_peers(two_ranks):
    """One micro batch's gradient accumulators on each rank of tensor=2
    (before the finish): the rank's slices are its slices of
    ``jax.grad`` of the JAX loss times the token count, and the leaves
    no axis cuts, whose gradients the copies' backward all-reduces
    reach, are bitwise equal on both peers."""
    _, job, _, _, results = two_ranks
    grads = [r[len(CASES_2)] for r in results]
    jcfg = _tiny("none")
    params = jax.tree_util.tree_map(jnp.asarray, job.params)
    batch = wt.batch_for(job, 0, 0)
    loss_fn = j_trainer.lm_loss_fn(jl.forward, jcfg)
    tokens = float(batch["mask"][:, 1:].sum())
    want = _flat(jax.device_get(jax.grad(
        lambda p: loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}
                          )[0] * tokens)(params)))
    axes = _flat_axes(tl.param_logical_axes(interop.config_from_jax(jcfg)))
    for leaf, whole in want.items():
        dim = next((i for i, n in enumerate(axes[leaf])
                    if n in ("heads", "kv_heads", "mlp", "vocab")), None)
        for r, g in enumerate(grads):
            got = g[leaf].numpy()
            ref = whole if dim is None else np.split(whole, 2, dim)[r]
            np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_ATOL,
                                       err_msg=f"rank {r} {leaf}")
        if dim is None:
            assert torch.equal(grads[0][leaf], grads[1][leaf]), leaf


def _flat_axes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_axes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_gloo_calls_are_cut_into_one_piece_a_lane(two_ranks):
    """A gloo call of fewer than GLOO_LANES full pieces is cut into one
    piece a lane (none under GLOO_MIN_PIECE_BYTES, none over
    GLOO_PIECE_BYTES), and the collectives on such pieces give the sums
    and the concatenations of the ranks' tensors, bitwise (two ranks:
    one addition an element)."""
    lanes = t_mesh.GLOO_LANES
    # (elements, bytes each): pieces
    want = {(PIECES_NUMEL[0], 4): 4, (PIECES_NUMEL[1], 4): 4,
            (2 * 2048 * 2048, 2): 4, (100, 4): 1, (1 << 30, 4): 64}
    for (numel, itemsize), count in want.items():
        pieces = t_mesh.WorldMesh._ranges(numel, itemsize, lanes)
        assert len(pieces) == count, (numel, itemsize, pieces)
        assert pieces[0][0] == 0 and pieces[-1][1] == numel
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        assert max(b - a for a, b in pieces) * itemsize \
            <= t_mesh.GLOO_PIECE_BYTES
    assert t_mesh.WorldMesh._ranges(100, 4, 1) == [(0, 100)]
    _, _, _, _, results = two_ranks
    ranks = [r[len(CASES_2) + 5] for r in results]
    part = PIECES_NUMEL[1]
    total = ranks[0]["z"] + ranks[1]["z"]
    for i, r in enumerate(ranks):
        assert torch.equal(r["all_reduce"], ranks[0]["x"] + ranks[1]["x"])
        assert torch.equal(r["all_gather"],
                           torch.cat([ranks[0]["y"], ranks[1]["y"]]))
        assert torch.equal(r["reduce_scatter"],
                           total[i * part:(i + 1) * part])


def test_collectives_give_the_unsharded_gradients(two_ranks):
    """The four collectives of ``parallel/tensor.py`` on float64 slices:
    each rank's output and gradients against the unsharded function's
    (PyTorch autograd on the whole weight) and ``jax.grad``'s."""
    _, _, _, _, results = two_ranks
    ranks = [r[len(CASES_2) + 1] for r in results]
    inp = collective_inputs()
    x, tokens, wts = inp["x"], inp["tokens"], inp["weights"]

    def whole_fns(lib, emb):
        return {
            "copy": lambda x, w: (x @ w * lib(wts["copy"])).sum(),
            "reduce": lambda x, w: (x @ w * lib(wts["reduce"])).sum(),
            "lookup": lambda x, w: (emb(w) * lib(wts["lookup"])).sum(),
            "gather": lambda x, w: (x @ w * lib(wts["gather"])).sum(),
        }

    t_fns = whole_fns(lambda a: a, lambda w: w[tokens])
    j_fns = whole_fns(lambda a: jnp.asarray(a.numpy()),
                      lambda w: w[jnp.asarray(tokens.numpy())])
    with jax.enable_x64(True):
        for name, dim in COLLECTIVE_SLICES.items():
            xw = x.clone().requires_grad_(True)
            w = inp[name].clone().requires_grad_(True)
            t_fns[name](xw, w).backward()
            jx, jw = jax.grad(j_fns[name], argnums=(0, 1))(
                jnp.asarray(x.numpy()), jnp.asarray(inp[name].numpy()))
            for ref_x, ref_w in ((xw.grad, w.grad),
                                 (torch.tensor(np.asarray(jx)),
                                  torch.tensor(np.asarray(jw)))):
                got_x = sum(r["grads"][name]["x"] for r in ranks) \
                    if name == "reduce" else None
                for r in ranks:
                    i, n = r["index"], r["n"]
                    k = ref_w.shape[dim] // n
                    assert torch.allclose(r["grads"][name]["w"],
                                          ref_w.narrow(dim, i * k, k),
                                          rtol=0, atol=F64_ATOL), (name, i)
                    if name == "lookup":
                        assert r["grads"][name]["x"] is None
                    elif got_x is None:
                        assert torch.allclose(r["grads"][name]["x"], ref_x,
                                              rtol=0, atol=F64_ATOL), name
                if got_x is not None:
                    assert torch.allclose(got_x, ref_x, rtol=0,
                                          atol=F64_ATOL), name
    # outputs: the rank's columns, the sums and the whole logits
    for r in ranks:
        i = r["index"]
        assert torch.allclose(r["out"]["copy"],
                              (x @ inp["copy"])[:, 3 * i:3 * i + 3],
                              rtol=0, atol=F64_ATOL)
        assert torch.allclose(r["out"]["reduce"], x @ inp["reduce"],
                              rtol=0, atol=F64_ATOL)
        assert torch.equal(r["out"]["lookup"], inp["lookup"][tokens])
        assert torch.allclose(r["out"]["gather"], x @ inp["gather"],
                              rtol=0, atol=F64_ATOL)
        assert r["timings"]["tensor_calls"] > 0


@pytest.mark.parametrize("world", ["tensor=2", "fsdp=2,tensor=2"])
def test_optimizer_on_tensor_parts_gives_the_unsharded_update(
        two_ranks, four_ranks, world):
    """adafactor on parts cut over tensor (and fsdp): its factored means
    along a cut dim and its block rms summed over the axes that cut
    them, so each rank applies its part of the whole update."""
    if world == "tensor=2":
        results = [r[len(CASES_2) + 2] for r in two_ranks[-1]]
    else:
        results = [r[len(CASES_4)] for r in four_ranks[1]]
    for r, diffs in enumerate(results):
        assert max(diffs.values()) <= OPT_ATOL, (world, r, diffs)


def test_tensor_rank_keeps_its_slices(two_ranks):
    """What a tensor=2 rank keeps (``Trainer.state_bytes``, every tensor
    the trainer reaches): half of every leaf the axis cuts and the whole
    norms, for the parameters and the gradients; adamw's moments alike,
    and its two 0-d counts."""
    jobs, _, _, _, results = two_ranks
    cfg = jobs[0].config
    shapes = _flat_axes(tl.param_shapes(cfg))
    axes = _flat_axes(tl.param_logical_axes(cfg))
    cut = sum(math.prod(s) for k, s in shapes.items()
              if {"heads", "kv_heads", "mlp", "vocab"} & set(axes[k]))
    whole = sum(math.prod(s) for s in shapes.values())
    want = 4 * (whole - cut + cut // 2)
    for r in results:
        run = r[0]["runs"]["eager"]
        assert run["state_bytes"]["total"] == run["held_bytes"]
        assert run["state_bytes"]["params"] == want
        assert run["state_bytes"]["grads"] == want
        assert run["state_bytes"]["opt_state"] == 2 * want + 2 * 4


def _check_fit(fit, job, root):
    """``fit_rank``'s runs resumed bitwise on every rank, every rank's
    gathered state alike, and the step-4 checkpoint restored bitwise
    into one process; returns the world's state."""
    for r, res in enumerate(fit):
        a, c = res["a"], res["c"]
        assert c["resumed_from"] == 2 and a["resumed_from"] is None
        assert {s: c["losses"][s] for s in (3, 4)} == \
            {s: a["losses"][s] for s in (3, 4)}, r
        for k, t in a["state"].items():
            assert torch.equal(t, c["state"][k]), (r, k)
            assert torch.equal(t, fit[0]["a"]["state"][k]), (r, k)
    world = fit[0]["a"]["state"]

    one = wt.make_trainer(job, torch.device("cpu"))
    mgr = CheckpointManager(str(root / "ckpt" / "a"))
    assert restore_latest(one, mgr) == 4
    mgr.close()
    mine = optim.named_leaves({"params": one.params,
                               "opt_state": one.opt_state})
    assert mine.keys() == world.keys()
    for k, t in mine.items():
        assert torch.equal(t.detach(), world[k]), k
    return world


def test_tensor_checkpoint_restores_bitwise_into_any_layout(two_ranks):
    """tensor=2: ``fit`` to step 4 with a checkpoint every 2 steps, and
    the same stopped at step 2 and resumed by a fresh trainer: the
    losses after the resume and the whole final state bitwise the
    uninterrupted run's. The uninterrupted run's step-4 checkpoint
    (written by the coordinator alone, the one-process format) restores
    bitwise into ONE process and into fsdp=2 (each rank its parts,
    gathered back)."""
    _, _, job, root, results = two_ranks
    world = _check_fit([r[len(CASES_2) + 3] for r in results], job, root)
    for r in results:
        restored = r[len(CASES_2) + 4]
        assert restored["step"] == 4
        for k, t in restored["state"].items():
            assert torch.equal(t, world[k]), k


def test_fsdp_tensor_checkpoint_restores_bitwise_into_one_process(
        four_ranks):
    """fsdp=2 x tensor=2: the same, with every leaf cut on two axes
    gathered over the replica group (adafactor's factored moments too),
    restored bitwise into one process."""
    _, results, job, root = four_ranks
    _check_fit([r[len(CASES_4) + 1] for r in results], job, root)


def _stub_mesh(data, fsdp, tensor):
    shape = {"data": data, "fsdp": fsdp, "tensor": tensor}
    return types.SimpleNamespace(size=data * fsdp * tensor, data=data,
                                 fsdp=fsdp, tensor=tensor, shape=shape,
                                 device=torch.device("cpu"))


def test_divisibility_error_matches_jax():
    """``init_state`` refuses a leaf whose tensor dim does not divide,
    before any collective, with the JAX package's message."""
    axes = {"wk": ("embed", "kv_heads", "head_dim"), "b": ("mlp",)}
    shapes = {"wk": (4, 3, 2), "b": (4,)}
    jmesh = _jax_mesh(1, 1, 2)
    with pytest.raises(ValueError) as want:
        j_sharding.validate_divisibility(jmesh, axes, shapes)
    trainer = Trainer(
        lambda g: {k: torch.zeros(s) for k, s in shapes.items()},
        lambda p, b: (p["b"].sum(), {"tokens": 1.0}), TrainerConfig(),
        device="cpu", mesh=_stub_mesh(1, 1, 2), param_axes=axes)
    with pytest.raises(ValueError) as got:
        trainer.init_state()
    assert str(got.value) == str(want.value)
    assert "param ['wk']: dim 3 not divisible by mesh axes ('tensor',)" \
        in str(got.value)


@pytest.mark.parametrize("mesh,n", [
    ("tensor=2", 2), ("data=2,tensor=2", 4), ("fsdp=2,tensor=2", 4),
    ("tensor=2", 4), ("data=-1,fsdp=2,tensor=2", 8), ("tensor=4", 4),
])
def test_world_layout_with_tensor_agrees_with_the_reference(mesh, n):
    """``world_layout`` and ``resolve_world_axes`` with ``tensor`` against
    the reference's mesh over N devices (``MeshConfig.resolved``)."""
    env = {"KFT_MESH": mesh}
    ref = dict(mesh_from_topology_env(env, devices=jax.devices()[:n]).shape)
    ours = t_boot.world_layout(env, n)
    assert (ours["data"], ours["fsdp"], ours["tensor"]) == \
        (ref["data"], ref["fsdp"], ref["tensor"])
    sizes = dict(kv.split("=") for kv in mesh.split(","))
    cfg = MeshConfig(**{k: int(v) for k, v in sizes.items()})
    cfg = cfg.resolved(n)
    assert resolve_world_axes(n, int(sizes.get("data", 1)),
                              int(sizes.get("fsdp", -1)),
                              int(sizes.get("tensor", 1))) == \
        (cfg.data, cfg.fsdp)


@pytest.mark.parametrize("data,fsdp,tensor,n", [
    (1, -1, 3, 4), (2, 2, 2, 4), (-1, -1, 2, 4)])
def test_world_axes_errors_match_mesh_config(data, fsdp, tensor, n):
    with pytest.raises(ValueError) as want:
        MeshConfig(data=data, fsdp=fsdp, tensor=tensor).resolved(n)
    with pytest.raises(ValueError) as got:
        resolve_world_axes(n, data, fsdp, tensor)
    assert str(got.value) == str(want.value)


def test_axes_not_ported_still_raise_naming_their_item():
    """A ``KFT_DCN`` axis other than data and fsdp raises naming ROADMAP
    queue 1 item 8.7; ``expert`` beside ``context`` is ported and lays
    out."""
    for env in ({"KFT_MESH": "context=2", "KFT_DCN": "context=2"},
                {"KFT_MESH": "pipeline=2", "KFT_DCN": "pipeline=2"}):
        with pytest.raises(NotImplementedError, match="queue 1 item 8.7"):
            t_boot.world_layout(env, 4)
    layout = t_boot.world_layout({"KFT_MESH": "expert=2,context=2"}, 4)
    assert (layout["expert"], layout["context"]) == (2, 2)


def test_moe_under_tensor_raises():
    """MoE under the tensor axis raises only where the JAX package does:
    the trainer takes an MoE config over a tensor=2 world, and
    ``init_state`` refuses an expert mlp dim that tensor=2 does not
    divide, before any collective, with the JAX package's message."""
    jcfg = dataclasses.replace(jl.llama_tiny(n_experts=4, dtype=jnp.float32),
                               mlp_dim=129)
    cfg = interop.config_from_jax(jcfg)
    axes = tl.param_logical_axes(cfg)
    with pytest.raises(ValueError) as want:
        j_sharding.validate_divisibility(_jax_mesh(1, 1, 2), axes,
                                         tl.param_shapes(cfg))
    trainer = Trainer(lambda g: tl.init_params(g, cfg, device="cpu"),
                      lm_loss_fn(tl.forward, cfg), TrainerConfig(),
                      device="cpu", mesh=_stub_mesh(1, 1, 2),
                      param_axes=axes)
    with pytest.raises(ValueError) as got:
        trainer.init_state()
    assert str(got.value) == str(want.value)
    assert "['layers']['w_down']: dim 129 not divisible by mesh axes " \
        "('tensor',)" in str(got.value)


# ------------------------------------------------------------------ pod --

def test_two_process_pod_under_tensor_trains_like_the_jax_trainer(tmp_path):
    """The port's pod (``worker_check``) as a 2-process JAXJob with
    ``KFT_MESH=tensor=2`` and ``KFT_TRAIN_STEPS``: both processes feed
    the same rows (one place in the batch axes), and the coordinator's
    losses are the JAX ``Trainer``'s on MeshConfig(tensor=2) fed them."""
    from kubeflow_tpu.client import TrainingClient
    from kubeflow_tpu.controller import JobController, LocalProcessCluster
    from test_torch_worker_check import POD_STEPS, POD_TIMEOUT, WORKER_CMD
    from test_torch_worker_check import _env

    cluster = LocalProcessCluster(log_dir=str(tmp_path / "pods"))
    client = TrainingClient(JobController(cluster))
    try:
        client.create_jax_job("torch-tensor2", workers=2,
                              command=WORKER_CMD, mesh={"tensor": 2},
                              env=_env(tmp_path,
                                       KFT_TRAIN_STEPS=str(POD_STEPS)),
                              run_policy=RunPolicy(backoff_limit=0))
        done = client.wait_for_job_conditions("torch-tensor2",
                                              timeout=POD_TIMEOUT)
        logs = [client.get_job_logs("torch-tensor2", index=i)
                for i in range(2)]
    finally:
        cluster.shutdown()
    assert done.status.condition() == ConditionType.SUCCEEDED, logs
    for i, log in enumerate(logs):
        assert f"worker {i}: trained to step {POD_STEPS}" in log, log
        assert "mesh={'data': 1, 'fsdp': 1, 'tensor': 2}, backend=gloo" \
            in log, log
    recs = read_metrics(str(tmp_path / "metrics.jsonl"))
    got = {r["step"]: r["loss"] for r in recs if "loss" in r}
    assert sorted(got) == list(range(1, POD_STEPS + 1)), recs

    host = optim.tree_map(lambda t: t.numpy(), tl.init_params(
        torch.Generator().manual_seed(0),
        tl.llama_tiny(dtype=torch.float32), device="cpu"))
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    mesh = _jax_mesh(1, 1, 2)
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

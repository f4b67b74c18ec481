"""Serving over an ``expert`` axis (``KFT_MESH=expert=E[,tensor=T]``): each
rank holds its E/expert experts (and, beside ``tensor``, its ``mlp``
slice of each), routes every token with the whole router, and the MoE
output is summed over the whole mesh; a dense model is replicated over
``expert``. Against the JAX package on the CPU, in float32, on the same
weights (``interop.params_from_jax``).

The JAX side runs as tests/test_torch_tp.py runs it: conftest's host
devices cut to the mesh (``build_mesh(MeshConfig(expert=2[, tensor=2]),
devices[:n])``), its engine synchronous with kernel "pallas" in
interpret mode. The port's ranks are processes that talk over gloo,
rendezvousing under the test's temporary directory.

Tolerances, each with its reason:

- shards (``shard_tree``, drawn under a mesh, loaded from a
  Mixtral-layout checkpoint): EXACT (slices of the same values);
- engine streams: token for token against JAX's engine on the same
  mesh, and every rank's digest of the tokens it sampled equal;
- the ``expert=2 x tensor=2`` engine's held payload: every KV head once,
  within 1e-5 of JAX's ``tensor=2`` engine's over the prompt's rows (two
  float32 programs summing in different orders).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import hf_llama as j_hf
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.parallel.sharding import tree_shardings
from kubeflow_tpu.serving.llm import LLMEngine as JEngine
from kubeflow_tpu.serving.llm import SamplingParams as JSampling
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import hf_llama as t_hf
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel import TensorMesh, shard_tree
from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams

from test_torch_flash_attention import warm_up_cpu_exp

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

LAYOUTS = {"expert=2": (2, 1), "expert=2,tensor=2": (2, 2)}
PROMPTS = [[5, 6, 7], [9, 10, 11, 12, 13],
           [(7 * i) % 250 + 1 for i in range(40)]]
KW = dict(max_batch=3, max_seq=96, prefill_buckets=(8, 16), decode_chunk=3)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _jmesh(ep, tp):
    return build_mesh(MeshConfig(expert=ep, tensor=tp),
                      devices=jax.devices()[:ep * tp])


def _rank(ep, tp, rank):
    """A mesh description standing as rank ``rank`` (no groups: what a
    drawing or a load reads of it)."""
    mesh = TensorMesh(tp, ["cpu"] * (ep * tp), expert=ep)
    mesh.rank = rank
    return mesh


def _device_of(jmesh, rank, tp):
    """The JAX device at the port rank's coordinates (expert index
    rank // tp, tensor index rank % tp; every other axis 0)."""
    idx = tuple(rank // tp if a == "expert" else rank % tp if a == "tensor"
                else 0 for a in jmesh.axis_names)
    return jmesh.devices[idx]


@pytest.fixture(scope="module")
def tiny_moe():
    jcfg = jl.llama_tiny(n_experts=4, dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shards_equal_jax_shards(layout):
    """(a) Each rank's ``shard_tree`` slice equals the shard JAX's
    ``tree_shardings`` places on the device at the rank's coordinates,
    and the rank's draw under the mesh (``init_params(mesh=)``) equals
    it too: the rank's experts (and ``mlp`` slice), the router whole."""
    ep, tp = LAYOUTS[layout]
    jcfg = dataclasses.replace(jl.llama_tiny(n_experts=4, dtype=jnp.float32),
                               tie_embeddings=False)
    tcfg = interop.config_from_jax(jcfg)
    axes = tl.param_logical_axes(tcfg)
    jm = _jmesh(ep, tp)
    jp = jl.init_params(jax.random.key(1), jcfg)
    placed = jax.device_put(jp, tree_shardings(jm, axes))
    full = interop.params_from_jax(jax.device_get(jp), device="cpu")
    whole = tl.init_params(torch.Generator().manual_seed(5), tcfg,
                           device="cpu")
    for rank in range(ep * tp):
        dev = _device_of(jm, rank, tp)
        ours = dict(_leaves(shard_tree(full, axes, rank, tp, ep)))
        theirs = {name: next(s.data for s in arr.addressable_shards
                             if s.device == dev)
                  for name, arr in _leaves(placed)}
        assert sorted(ours) == sorted(theirs)
        for name, mine in ours.items():
            np.testing.assert_array_equal(mine.numpy(),
                                          np.asarray(theirs[name]),
                                          err_msg=f"{rank} {name}")
        assert ours["/layers/w_gate"].shape == (2, 4 // ep, 64, 128 // tp)
        assert ours["/layers/moe_router"].shape == (2, 64, 4)
        drawn = dict(_leaves(tl.init_params(
            torch.Generator().manual_seed(5), tcfg, device="cpu",
            mesh=_rank(ep, tp, rank))))
        want = dict(_leaves(shard_tree(whole, axes, rank, tp, ep)))
        assert list(drawn) == list(want)
        for name in drawn:
            assert torch.equal(drawn[name], want[name]), (rank, name)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mixtral_load_reads_only_the_ranks_experts(tmp_path, monkeypatch,
                                                    layout):
    """(b) A Mixtral-layout checkpoint (the JAX package's
    ``save_pretrained``) loaded under the mesh: each rank's tree is its
    slice of the unsharded load, EXACTLY, and the rank reads no tensor of
    another rank's experts."""
    ep, tp = LAYOUTS[layout]
    jcfg = jl.llama_tiny(n_experts=4, dtype=jnp.float32)
    d = str(tmp_path / "mixtral")
    j_hf.save_pretrained(d, jcfg, jl.init_params(jax.random.key(4), jcfg))
    cfg, whole = t_hf.load_params(d, dtype=torch.float32, device="cpu")
    axes = tl.param_logical_axes(cfg)
    read = []
    get = t_hf.CheckpointIndex.get
    monkeypatch.setattr(t_hf.CheckpointIndex, "get",
                        lambda self, name, index=None: (
                            read.append(name), get(self, name, index))[1])
    for rank in range(ep * tp):
        read.clear()
        _, part = t_hf.load_params(d, cfg, dtype=torch.float32,
                                   device="cpu", mesh=_rank(ep, tp, rank))
        want = dict(_leaves(shard_tree(whole, axes, rank, tp, ep)))
        got = dict(_leaves(part))
        assert list(got) == list(want)
        for name in got:
            assert torch.equal(got[name], want[name]), (rank, name)
        experts = {int(m.group(1)) for m in (
            re.search(r"experts\.(\d+)\.", n) for n in read) if m}
        mine = rank // tp
        assert experts == {2 * mine, 2 * mine + 1}
        assert any("block_sparse_moe.gate" in n for n in read)


def _jax_engine(jcfg, jp, ep, tp):
    jm = _jmesh(ep, tp)
    return JEngine(jax.device_put(jp, tree_shardings(
        jm, jl.param_logical_axes(jcfg))), jcfg, mesh=jm, kernel="pallas",
        decode_pipeline=False, **KW)


def _mesh(ep, tp, tmp_path):
    return TensorMesh(tp, ["cpu"] * (ep * tp), expert=ep, timeout_s=120.0,
                      rendezvous_dir=str(tmp_path))


def _held(eng, prompt, sampling):
    req = eng.add_request(prompt, sampling, hold_after_prefill=True)
    while req.t_first_token == 0 and eng.has_work():
        eng.step()
    payload = eng.export_held_kv(req)
    assert eng.release_held(req)
    return payload


@pytest.mark.parametrize("cf", [0.0, 1.25])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_expert_engine_matches_jax_engine(tiny_moe, tmp_path, layout, cf):
    """(c) llama_tiny with 4 experts under ``expert=2`` (two processes)
    and ``expert=2 x tensor=2`` (four): the port's engine against JAX's on
    the same mesh, dropless and on the capacity path, through ragged
    prompts, a mid-flight join and a chunked prompt, token for token;
    every rank sampled the same tokens and holds 2 of the 4 experts.
    (d) Under ``expert=2 x tensor=2`` a held prompt's payload holds every
    KV head once, in tensor order: JAX's ``tensor=2`` engine's payload
    (within 1e-5), and the ranks' blocks all freed after release."""
    ep, tp = LAYOUTS[layout]
    jcfg, jp, tcfg, tparams = tiny_moe
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    je = _jax_engine(jcfg, jp, ep, tp)
    theirs = je.generate(PROMPTS, JSampling(max_tokens=7))
    [jlate] = je.generate([[3, 4]], JSampling(max_tokens=4))
    te = LLMEngine(tparams, tcfg, mesh=_mesh(ep, tp, tmp_path), **KW)
    try:
        ours = te.generate(PROMPTS, SamplingParams(max_tokens=7))
        late = te.add_request([3, 4], SamplingParams(max_tokens=4))
        while te.has_work():
            te.step()
        chunked = te.sched.chunked_admitted
        payload = (_held(te, PROMPTS[2], SamplingParams(max_tokens=4))
                   if (tp, cf) == (2, 0.0) else None)
        status = te.tp_status()
    finally:
        te.close()
    assert [r.generated for r in ours] == [r.generated for r in theirs]
    assert late.generated == jlate.generated
    assert chunked == 1
    assert len({(s["samples"], s["token_digest"]) for s in status}) == 1
    assert status[0]["samples"] > 0
    assert [(s["expert_index"], s["tensor_index"]) for s in status] == \
        [(r // tp, r % tp) for r in range(ep * tp)]
    assert [s["blocks_in_use"] for s in status] == [0] * (ep * tp)
    assert te.params["layers"]["w_gate"].shape == (2, 2, 64, 128 // tp)
    assert torch.equal(te.params["layers"]["moe_router"],
                       tparams["layers"]["moe_router"])
    if payload is not None:
        jpay = _held(_jax_engine(jcfg, jp, 1, 2), PROMPTS[2],
                     JSampling(max_tokens=4))
        n = len(PROMPTS[2])
        for key in ("k", "v"):
            mine, want = payload["blocks"][key], np.asarray(
                jpay["blocks"][key])
            assert mine.shape == want.shape
            assert mine.shape[3] == tcfg.n_kv_heads
            rows = lambda a: a.reshape(a.shape[0], -1, *a.shape[3:])[:, :n]
            np.testing.assert_allclose(rows(mine), rows(want), rtol=0,
                                       atol=1e-5, err_msg=key)


def test_dense_model_under_expert_matches_jax(tmp_path):
    """(d) A dense llama_tiny under ``expert=2`` (replicated on both
    ranks, no collective in a layer) against JAX's engine on
    ``MeshConfig(expert=2)``: token for token, digests equal."""
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    theirs = _jax_engine(jcfg, jp, 2, 1).generate(
        PROMPTS, JSampling(max_tokens=6))
    tcfg = interop.config_from_jax(jcfg)
    tparams = interop.params_from_jax(jax.device_get(jp), device="cpu")
    te = LLMEngine(tparams, tcfg, mesh=_mesh(2, 1, tmp_path), **KW)
    try:
        ours = te.generate(PROMPTS, SamplingParams(max_tokens=6))
        status = te.tp_status()
    finally:
        te.close()
    assert [r.generated for r in ours] == [r.generated for r in theirs]
    assert len({(s["samples"], s["token_digest"]) for s in status}) == 1
    assert [s["kv_heads"] for s in status] == [tcfg.n_kv_heads] * 2
    assert torch.equal(te.params["layers"]["w_gate"],
                       tparams["layers"]["w_gate"])


def test_runtime_serves_moe_under_expert_mesh_over_http(tmp_path):
    """(e) ``KFT_MESH=expert=2`` with ``KFT_FORCE_PLATFORM=cpu`` on a
    Mixtral-layout ``KFT_MODEL_DIR``: the runtime builds a 2-rank model
    (dropless) whose ranks load their own experts, and one V2 request
    over HTTP returns the unsharded JAX runtime's tokens."""
    from kubeflow_tpu.serving.runtime import (
        build_model_from_env as j_build,
    )
    from kubeflow_tpu_torch.serving import (
        InferenceClient, InferRequest, InferTensor, ModelRepository,
        ModelServer,
    )
    from kubeflow_tpu_torch.serving.runtime import build_model_from_env

    jcfg = jl.llama_tiny(n_experts=4, dtype=jnp.float32)
    model_dir = str(tmp_path / "ckpt")
    j_hf.save_pretrained(model_dir, jcfg,
                         jl.init_params(jax.random.key(3), jcfg))
    env = {"KFT_MODEL_NAME": "moe", "KFT_MODEL_DIR": model_dir,
           "KFT_DTYPE": "float32", "KFT_MAX_BATCH": "2",
           "KFT_MAX_SEQ": "64", "KFT_FORCE_PLATFORM": "cpu"}
    ids = np.array([[5, 6, 7, 8], [9, 3, 1, 2]], np.int32)
    params = {"max_tokens": 6}
    jmodel = j_build(env)
    jmodel.load()
    try:
        want = jmodel.predict(InferRequest(
            "moe", [InferTensor.from_numpy("ids", ids)],
            parameters=dict(params))).as_numpy("tokens")
    finally:
        jmodel.unload()
    model = build_model_from_env(dict(env, KFT_MESH="expert=2"))
    assert (model.mesh.ep, model.mesh.tp) == (2, 1)
    assert model.cfg.moe_capacity_factor == 0.0
    repo = ModelRepository()
    repo.register(model)
    srv = ModelServer(repo).start()
    try:
        out = InferenceClient(srv.url).infer(InferRequest(
            "moe", [InferTensor.from_numpy("ids", ids)],
            parameters=dict(params)))
        np.testing.assert_array_equal(out.as_numpy("tokens"), want)
        assert model.stats()["mesh"]["expert"] == 2
        ranks = model.engine.tp_status()
        assert ranks[0]["samples"] > 0
        assert len({(r["samples"], r["token_digest"]) for r in ranks}) == 1
        assert model.engine.params["layers"]["w_up"].shape[1] == 2
    finally:
        srv.stop()
        model.unload()


def test_indivisible_experts_raise_naming_n_experts(tiny_moe, tmp_path):
    """(f) 4 experts over ``expert=3``: the engine (before any rank is
    spawned) and the sharded load raise ValueError naming
    ``n_experts``."""
    _, _, tcfg, tparams = tiny_moe
    mesh = TensorMesh(1, ["cpu"] * 3, expert=3)
    with pytest.raises(ValueError, match="n_experts=4 not divisible by "
                                         "expert=3"):
        LLMEngine(tparams, tcfg, mesh=mesh, **KW)
    d = str(tmp_path / "mixtral")
    jcfg = jl.llama_tiny(n_experts=4, dtype=jnp.float32)
    j_hf.save_pretrained(d, jcfg, jl.init_params(jax.random.key(4), jcfg))
    with pytest.raises(ValueError, match="n_experts=4"):
        t_hf.load_params(d, dtype=torch.float32, device="cpu", mesh=mesh)


def test_scratch_writes_land_as_the_last_write():
    """Replicas of a rank over ``expert`` agree bit for bit only if every
    row reads the same bytes on every device. Rows that are not live read
    the scratch block 0 (an idle slot, a slot stepping past its blocks)
    and on the capacity path still take an expert's slot; several rows of
    one scatter write the same scratch row, and which write lands is not
    fixed on a card. So every scatter into the pool gives each duplicate
    the last one's values (``paged_kv._last_writes``): any landing order
    leaves the last write's bytes. In a decode step, three idle slots
    leave block 0 as the last of them alone does."""
    from kubeflow_tpu_torch.serving.paged_kv import (
        _last_writes, init_paged_cache, paged_decode_step,
    )

    keys = torch.tensor([3, 0, 3, 1, 0, 3, 2])
    vals = torch.arange(7.0) * 10
    last = _last_writes(keys)
    assert last.tolist() == [5, 4, 5, 3, 4, 5, 6]
    landed = []
    for order in (range(7), reversed(range(7))):
        out = torch.zeros(4)
        for i in order:
            out[keys[i]] = vals[last[i]]
        landed.append(out)
    sequential = torch.zeros(4)
    for i in range(7):
        sequential[keys[i]] = vals[i]
    assert torch.equal(landed[0], sequential)
    assert torch.equal(landed[1], sequential)

    cfg = tl.llama_tiny(dtype=torch.float32)
    params = tl.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    token = torch.tensor([5, 7, 9], dtype=torch.int32)
    pools = []
    for tables in ([[0, 0], [0, 0], [0, 0]], [[1, 0], [2, 0], [0, 0]]):
        cache = init_paged_cache(cfg, 3, 16, 8, 4, device="cpu")
        paged_decode_step(params, token, cfg, cache,
                          torch.tensor(tables, dtype=torch.int32),
                          kernel="paged")
        pools.append(cache)
    for key in ("k", "v"):
        assert torch.equal(pools[0][key][:, 0], pools[1][key][:, 0])

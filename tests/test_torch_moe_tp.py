"""Mixture-of-Experts served under a tensor mesh (``KFT_MESH=tensor=N``):
each rank holds the ``mlp`` slice of every expert and the whole router,
routes as every rank does, and the MoE output is all-reduced, against
the JAX package's tensor-parallel engine on the CPU, in float32, on the
same weights (``interop.params_from_jax``).

The JAX side runs on conftest's host devices cut to the ``tensor`` axis
(``build_mesh(MeshConfig(tensor=2), devices[:2])``), its engine
synchronous with kernel "pallas" (tests/test_torch_tp.py's reasons); the
port's ranks are processes that talk over gloo.

Tolerances, each with its reason:
- engine streams: token for token against the JAX TP engine, and every
  rank's digest of the tokens it sampled equal;
- the shards (drawn under a mesh, loaded from a Mixtral-layout
  checkpoint): EXACT (slices of the same values).
"""

import dataclasses

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

TP = 2

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def tiny_moe():
    jcfg = jl.llama_tiny(n_experts=4, dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


def _rank(rank):
    """A TensorMesh description standing as rank ``rank`` (no groups:
    what a drawing or a load reads of it)."""
    mesh = TensorMesh(TP, ["cpu"] * TP)
    mesh.rank = rank
    return mesh


@pytest.mark.parametrize("cf", [0.0, 1.25])
def test_moe_tp_engine_matches_jax_tp_engine(tiny_moe, tmp_path, cf):
    """tensor=2, llama_tiny with 4 experts: the port's TP engine (2
    processes, gloo) against the JAX TP engine, dropless and on the
    capacity path, through ragged prompts, a mid-flight join and a
    chunked prompt, token for token; every rank sampled the same
    tokens, and each holds half of every expert's mlp dim."""
    jcfg, jp, tcfg, tp = tiny_moe
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    kw = dict(max_batch=3, max_seq=96, prefill_buckets=(8, 16),
              decode_chunk=3)
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13],
               [(7 * i) % 250 + 1 for i in range(40)]]
    mesh = build_mesh(MeshConfig(tensor=TP), devices=jax.devices()[:TP])
    je = JEngine(jax.device_put(jp, tree_shardings(
        mesh, jl.param_logical_axes(jcfg))), jcfg, mesh=mesh,
        kernel="pallas", decode_pipeline=False, **kw)
    theirs = je.generate(prompts, JSampling(max_tokens=7))
    te = LLMEngine(tp, tcfg, mesh=TensorMesh(
        TP, ["cpu"] * TP, timeout_s=120.0, rendezvous_dir=str(tmp_path)),
        **kw)
    try:
        ours = te.generate(prompts, SamplingParams(max_tokens=7))
        late = te.add_request([3, 4], SamplingParams(max_tokens=4))
        while te.has_work():
            te.step()
        status = te.tp_status()
    finally:
        te.close()
    [jlate] = je.generate([[3, 4]], JSampling(max_tokens=4))
    assert [r.generated for r in ours] == [r.generated for r in theirs]
    assert late.generated == jlate.generated
    assert te.sched.chunked_admitted == 1
    assert len({(s["samples"], s["token_digest"]) for s in status}) == 1
    assert status[0]["samples"] > 0
    assert te.params["layers"]["w_gate"].shape == (2, 4, 64, 64)
    assert te.params["layers"]["w_down"].shape == (2, 4, 64, 64)
    assert torch.equal(te.params["layers"]["moe_router"],
                       tp["layers"]["moe_router"])


def test_moe_shards_drawn_under_a_mesh_are_the_whole_tree_sliced():
    """``init_params(mesh=)`` of an MoE config: each rank's shard equals
    the rank's ``shard_tree`` slice of the unsharded draw from the same
    seed (the experts' mlp dim; the router and the norms whole)."""
    cfg = dataclasses.replace(tl.llama_tiny(n_experts=4,
                                            dtype=torch.float32),
                              tie_embeddings=False)
    whole = tl.init_params(torch.Generator().manual_seed(5), cfg,
                           device="cpu")
    axes = tl.param_logical_axes(cfg)
    for rank in range(TP):
        part = tl.init_params(torch.Generator().manual_seed(5), cfg,
                              device="cpu", mesh=_rank(rank))
        want = dict(_leaves(shard_tree(whole, axes, rank, TP)))
        got = dict(_leaves(part))
        assert list(got) == list(want)
        for name in got:
            assert torch.equal(got[name], want[name]), name
        assert got["/layers/w_up"].shape == (2, 4, 64, 64)


def test_mixtral_checkpoint_loads_each_ranks_slice(tmp_path):
    """A Mixtral-layout checkpoint (written by the JAX package's
    ``hf_llama.save_pretrained``) loaded under a mesh: each rank's tree
    is its slice of the unsharded load, read expert by expert."""
    jcfg = jl.llama_tiny(n_experts=4, dtype=jnp.float32)
    d = str(tmp_path / "mixtral")
    j_hf.save_pretrained(d, jcfg, jl.init_params(jax.random.key(4), jcfg))
    cfg, whole = t_hf.load_params(d, dtype=torch.float32, device="cpu")
    assert cfg.n_experts == 4
    axes = tl.param_logical_axes(cfg)
    for rank in range(TP):
        _, part = t_hf.load_params(d, cfg, dtype=torch.float32,
                                   device="cpu", mesh=_rank(rank))
        want = dict(_leaves(shard_tree(whole, axes, rank, TP)))
        got = dict(_leaves(part))
        assert list(got) == list(want)
        for name in got:
            assert torch.equal(got[name], want[name]), name


def test_runtime_serves_moe_under_tensor_mesh_over_http(tmp_path):
    """KFT_MESH=tensor=2 with KFT_FORCE_PLATFORM=cpu on a Mixtral-layout
    KFT_MODEL_DIR: the runtime builds a 2-rank model (dropless, as
    ``from_pretrained`` serves MoE) whose ranks load their own slices, and
    one V2 request over HTTP returns the unsharded JAX runtime's
    tokens."""
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
    model = build_model_from_env(dict(env, KFT_MESH="tensor=2"))
    assert model.mesh.tp == 2 and model.cfg.n_experts == 4
    assert model.cfg.moe_capacity_factor == 0.0
    repo = ModelRepository()
    repo.register(model)
    srv = ModelServer(repo).start()
    try:
        out = InferenceClient(srv.url).infer(InferRequest(
            "moe", [InferTensor.from_numpy("ids", ids)],
            parameters=dict(params)))
        np.testing.assert_array_equal(out.as_numpy("tokens"), want)
        ranks = model.engine.tp_status()
        assert ranks[0]["samples"] > 0
        assert len({(r["samples"], r["token_digest"]) for r in ranks}) == 1
    finally:
        srv.stop()
        model.unload()

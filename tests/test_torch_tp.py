"""The port's tensor-parallel serving (``parallel/``, row 3 of the kernel
table, the TP engine and runtime) against the JAX package on the CPU, in
float32, on the same numpy-seeded inputs.

The JAX side runs on the 8-device CPU mesh of tests/conftest.py, cut to
the ``tensor`` axis alone (``build_mesh(MeshConfig(tensor=2),
devices[:2])``); the port's side spawns its ranks as processes that talk
over gloo, rendezvousing through a file under the test's tmp_path.

Tolerances, each with its reason:

- Row 3 against the JAX ``paged_decode_attention_sharded`` in interpret
  mode: 2e-5 (two softmax implementations summing in different orders,
  the unsharded parity limit); against the port's unsharded call:
  BITWISE (each head's arithmetic is the same; only slicing differs).
- ``shard_tree`` and the sharded loader: EXACT (slices of the same
  values; int8 trees quantize the full tensor first).
- Engine streams: token for token against the JAX TP engine (synchronous
  decode, kernel "pallas": its pipelined engine is nondeterministic on
  the CPU, ROADMAP queue 3).
"""

import dataclasses
import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import hf_llama as j_hf
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.ops.pallas_paged_attention import (
    paged_decode_attention_sharded as j_sharded, shard_unsupported_reason,
)
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.parallel.sharding import tree_shardings
from kubeflow_tpu.serving import quant as j_quant
from kubeflow_tpu.serving.llm import LLMEngine as JEngine
from kubeflow_tpu.serving.llm import SamplingParams as JSampling
from kubeflow_tpu.serving.scheduler import QuantConfig as JQuant
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import hf_llama as t_hf
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.ops import paged_attention as pa
from kubeflow_tpu_torch.parallel import (
    TensorMesh, mesh_from_topology_env, shard_tree,
)
from kubeflow_tpu_torch.serving import quant as t_quant
from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serving.scheduler import QuantConfig

from test_torch_paged_attention import _pool_case

TP = 2


def _jmesh(tp=TP):
    return build_mesh(MeshConfig(tensor=tp), devices=jax.devices()[:tp])


def _tmesh(tmp_path, tp=TP, timeout_s=120.0):
    return TensorMesh(tp, ["cpu"] * tp, timeout_s=timeout_s,
                      rendezvous_dir=str(tmp_path))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


# ------------------------------------------------------------------ row 3 --

def _quantized(pool):
    """Per-block per-KV-head int8 quantization (numpy) -> (int8, scale)."""
    amax = np.abs(pool).max(axis=(1, 3))
    scale = np.maximum(amax / 127.0, 1e-30).astype(np.float32)
    q = np.clip(np.round(pool / scale[:, None, :, None]), -127, 127)
    return q.astype(np.int8), scale


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_sharded_kernel_matches_jax(kv):
    """Row 3 at tensor=2 on whole arrays: the JAX shard_map'd kernel in
    interpret mode within 2e-5, the port's unsharded call bitwise."""
    q, kp, vp, tables, kvl = _pool_case(14, b=6, h=8, kvh=4, d=32, bs=8,
                                        nbp=3, kv_len=[0, 1, 7, 16, 17, 24])
    jsc, tsc = {}, {}
    if kv == "int8":
        (kp, ks), (vp, vs) = _quantized(kp), _quantized(vp)
        jsc = {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
        tsc = {"k_scale": torch.tensor(ks), "v_scale": torch.tensor(vs)}
    ref = np.asarray(j_sharded(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(kvl), mesh=_jmesh(), interpret=True, **jsc))
    args = tuple(torch.tensor(x) for x in (q, kp, vp, tables, kvl))
    out = pa.paged_decode_attention_sharded(
        *args, mesh=TensorMesh(TP, ["cpu"] * TP), **tsc)
    live = kvl > 0
    np.testing.assert_allclose(out.numpy()[live], ref[live], rtol=2e-5,
                               atol=2e-5)
    assert torch.equal(out, pa.paged_decode_attention(*args, **tsc))


def test_sharded_kernel_rejects_indivisible_heads(tiny):
    """KV_H=2 over tensor=4: the JAX reason, word for word, from row 3
    and from the engine (before any rank is spawned)."""
    reason = shard_unsupported_reason(_jmesh(4), 2)
    assert reason == "n_kv_heads=2 not divisible by tensor=4"
    q, kp, vp, tables, kvl = (torch.tensor(x) for x in _pool_case(
        0, b=2, h=4, kvh=2, d=16, bs=8, nbp=2, kv_len=[3, 9]))
    mesh4 = TensorMesh(4, ["cpu"] * 4)
    with pytest.raises(ValueError, match=re.escape(reason)):
        pa.paged_decode_attention_sharded(q, kp, vp, tables, kvl,
                                          mesh=mesh4)
    _, _, tcfg, tp = tiny
    with pytest.raises(ValueError, match=re.escape(reason)):
        LLMEngine(tp, tcfg, max_seq=64, prefill_buckets=(8,), mesh=mesh4)


# ------------------------------------------------------------ the shards --

@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_shard_tree_matches_jax_shards(kind):
    """Each rank's shard_tree slice equals the shard the JAX sharded tree
    holds on that rank's device (the JAX rule table placing the same
    logical axes). int8: the JAX package's quantization of its sharded
    tree, placed by the int8 tree's axes, against the port's full tree
    quantized, then sliced."""
    jcfg = dataclasses.replace(jl.llama_tiny(dtype=jnp.float32),
                               tie_embeddings=False)
    jp = jl.init_params(jax.random.key(1), jcfg)
    tcfg = interop.config_from_jax(jcfg)
    mesh = _jmesh()
    axes = tl.param_logical_axes(tcfg)
    assert axes == jl.param_logical_axes(jcfg)
    if kind == "bf16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    full = interop.params_from_jax(jax.device_get(jp), device="cpu")
    if kind == "int8":
        jp = j_quant.quantize_weights(
            jax.device_put(jp, tree_shardings(mesh, axes)), jcfg)
        full = t_quant.quantize_weights(full, tcfg)
        axes = t_quant.quant_logical_axes(tcfg)
    placed = jax.device_put(jp, tree_shardings(mesh, axes))
    devs = list(mesh.devices.flat)
    for rank in range(TP):
        ours = dict(_leaves(shard_tree(full, axes, rank, TP)))
        theirs = {name: next(s.data for s in arr.addressable_shards
                             if s.device == devs[rank])
                  for name, arr in _leaves(placed)}
        assert sorted(ours) == sorted(theirs)
        for name, mine in ours.items():
            want = np.asarray(theirs[name])
            if mine.dtype == torch.bfloat16:
                mine, want = mine.float(), want.astype(np.float32)
            np.testing.assert_array_equal(mine.numpy(), want, err_msg=name)
    # the sharded dims are the rule table's: wo on its heads, scale whole
    shard0 = dict(_leaves(shard_tree(full, axes, 0, TP)))
    wo = shard0["/layers/wo_q" if kind == "int8" else "/layers/wo"]
    assert wo.shape[1] == jcfg.n_heads // TP


def test_sharded_load_reads_each_ranks_slice(tmp_path):
    """hf_llama.load_params(mesh=) gives each rank exactly its slice of
    the unsharded load (tied and untied heads)."""
    for tie in (True, False):
        jcfg = dataclasses.replace(jl.llama_tiny(dtype=jnp.float32),
                                   tie_embeddings=tie)
        d = str(tmp_path / f"ckpt{tie}")
        j_hf.save_pretrained(d, jcfg, jl.init_params(jax.random.key(2),
                                                     jcfg))
        cfg, whole = t_hf.load_params(d, dtype=torch.float32, device="cpu")
        axes = tl.param_logical_axes(cfg)
        for rank in range(TP):
            mesh = TensorMesh(TP, ["cpu"] * TP)
            mesh.rank = rank
            _, part = t_hf.load_params(d, cfg, dtype=torch.float32,
                                       device="cpu", mesh=mesh)
            want = dict(_leaves(shard_tree(whole, axes, rank, TP)))
            got = dict(_leaves(part))
            assert list(got) == list(want)
            for name in got:
                assert torch.equal(got[name], want[name]), name


# ------------------------------------------------------------ the engine --

def _churn(eng, sampling):
    """Three requests, two steps, then a mid-flight join; drained."""
    reqs = [eng.add_request([3 + i, 4 + i], sampling(5 + (i % 2)))
            for i in range(3)]
    for _ in range(2):
        eng.step()
    late = eng.add_request([9, 10, 11], sampling(4))
    chunked = eng.add_request([(7 * i) % 250 + 1 for i in range(20)],
                              sampling(3))
    while eng.has_work():
        eng.step()
    return [r.generated for r in reqs + [late, chunked]]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_tp_engine_matches_jax_tp_engine(tiny, tmp_path, quant):
    """tensor=2, llama_tiny: the port's TP engine (2 processes, gloo)
    against the JAX TP engine (kernel "pallas", synchronous decode)
    through churn, a mid-flight join and a chunked prompt, token for
    token, full-precision weights and int8 KV + int8 weights. Every rank
    ran every sampling dispatch and sampled the same tokens (equal
    digests); each rank holds one KV head; rank 0's int8 shard equals the full tree's
    quantization, sliced."""
    jcfg, jp, tcfg, tp = tiny
    kw = dict(max_batch=2, max_seq=64, prefill_buckets=(8, 16),
              decode_chunk=3)
    jq = tq = None
    if quant == "int8":
        jq = JQuant(kv_dtype="int8", weight_dtype="int8")
        tq = QuantConfig(kv_dtype="int8", weight_dtype="int8")
    mesh = _jmesh()
    je = JEngine(jax.device_put(jp, tree_shardings(
        mesh, jl.param_logical_axes(jcfg))), jcfg, mesh=mesh,
        kernel="pallas", decode_pipeline=False, quant=jq, **kw)
    theirs = _churn(je, lambda n: JSampling(max_tokens=n))
    te = LLMEngine(tp, tcfg, mesh=_tmesh(tmp_path), quant=tq, **kw)
    try:
        ours = _churn(te, lambda n: SamplingParams(max_tokens=n))
        status = te.tp_status()
    finally:
        te.close()
    assert ours == theirs
    sampled = (te.sched.decode_dispatches + te.prefill_dispatches
               + te.sched.chunked_admitted)
    assert sampled > 0
    assert [s["samples"] for s in status] == [sampled] * TP
    assert len({s["token_digest"] for s in status}) == 1
    assert [s["rank"] for s in status] == [0, 1]
    assert [s["kv_heads"] for s in status] == [1, 1]
    assert te.cache["k"].shape[3] == tcfg.n_kv_heads // TP
    if quant == "int8":
        want = dict(_leaves(shard_tree(
            t_quant.quantize_weights(tp, tcfg),
            t_quant.quant_logical_axes(tcfg), 0, TP)))
        for name, leaf in _leaves(te.params):
            assert torch.equal(leaf, want[name]), name


@pytest.mark.parametrize("where", [(0, 0, 0), (1, 1, 1), (2, 0, 1)])
def test_token_digest_tells_one_token_apart(where):
    """The running digest that ``tp_status`` reports per rank: the same
    dispatches give the same digest; one token changed anywhere in the
    run (dispatch, row, slot) gives another, whatever follows it."""
    def digest(dispatches):
        rank = types.SimpleNamespace(
            _token_digest=torch.zeros((), dtype=torch.int64),
            tp_samples=0)
        for toks in dispatches:
            LLMEngine._note_tokens(rank, torch.tensor(toks))
        return int(rank._token_digest), rank.tp_samples

    run = [[[5, 128000], [7, 8]], [[9, 10], [11, 1]], [[0, 3], [4, 2]]]
    other = [[row[:] for row in d] for d in run]
    d, r, c = where
    other[d][r][c] += 1
    assert digest(run) == digest([[row[:] for row in d] for d in run])
    assert digest(run)[0] != digest(other)[0]
    assert digest(run)[1] == digest(other)[1] == len(run)


def test_dead_rank_makes_rank0_raise(tiny, tmp_path):
    """A rank killed mid-service: rank 0's next dispatch raises (within
    the mesh's timeout), naming the rank, instead of hanging."""
    _, _, tcfg, tp = tiny
    eng = LLMEngine(tp, tcfg, max_seq=64, prefill_buckets=(8,),
                    mesh=_tmesh(tmp_path, timeout_s=20.0))
    try:
        eng.generate([[5, 6, 7]], SamplingParams(max_tokens=2))
        eng.tp.ping()
        eng.tp.procs[0].kill()
        eng.tp.procs[0].join()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank"):
            eng.generate([[5, 6, 7]], SamplingParams(max_tokens=2))
        assert time.monotonic() - t0 < 20.0
    finally:
        eng.close()


# ----------------------------------------------------------- the runtime --

def test_runtime_serves_tensor_parallel_over_http(tmp_path):
    """KFT_MESH=tensor=2 with KFT_FORCE_PLATFORM=cpu: the runtime builds
    a 2-rank model whose ranks load their own checkpoint slices, and one
    V2 request over HTTP returns the unsharded JAX model's tokens."""
    from kubeflow_tpu.serving.runtime import (
        build_model_from_env as j_build,
    )
    from kubeflow_tpu_torch.serving import (
        InferenceClient, InferRequest, InferTensor, ModelRepository,
        ModelServer,
    )
    from kubeflow_tpu_torch.serving.runtime import build_model_from_env

    jcfg = jl.llama_tiny(dtype=jnp.float32)
    model_dir = str(tmp_path / "ckpt")
    j_hf.save_pretrained(model_dir, jcfg, jl.init_params(jax.random.key(3),
                                                         jcfg))
    env = {"KFT_MODEL_NAME": "tiny", "KFT_MODEL_DIR": model_dir,
           "KFT_DTYPE": "float32", "KFT_MAX_BATCH": "2",
           "KFT_MAX_SEQ": "64", "KFT_FORCE_PLATFORM": "cpu"}
    ids = np.array([[5, 6, 7, 8]], np.int32)
    params = {"max_tokens": 6}
    jmodel = j_build(env)
    jmodel.load()
    try:
        want = jmodel.predict(InferRequest(
            "tiny", [InferTensor.from_numpy("ids", ids)],
            parameters=dict(params))).as_numpy("tokens")
    finally:
        jmodel.unload()
    model = build_model_from_env(dict(env, KFT_MESH="tensor=2"))
    assert model.mesh.tp == 2 and model.mesh.backend == "gloo"
    repo = ModelRepository()
    repo.register(model)
    srv = ModelServer(repo).start()
    try:
        out = InferenceClient(srv.url).infer(InferRequest(
            "tiny", [InferTensor.from_numpy("ids", ids)],
            parameters=dict(params)))
        np.testing.assert_array_equal(out.as_numpy("tokens"), want)
        mesh_stats = model.stats()["mesh"]
        assert mesh_stats["tensor"] == 2
        assert mesh_stats["backend"] == "gloo"
        ranks = model.engine.tp_status()
        assert ranks[0]["samples"] > 0
        assert len({(r["samples"], r["token_digest"]) for r in ranks}) == 1
    finally:
        srv.stop()
        model.unload()


@pytest.mark.parametrize("env", [
    {"KFT_MESH": "data=2,tensor=2"}, {"KFT_MESH": "fsdp=2"},
    {"KFT_MESH": "tensor=2", "KFT_DCN": "data=2"},
    {"KFT_MESH": "context=2"}, {"KFT_MESH": "pipeline=2,tensor=2"}])
def test_mesh_axes_other_than_tensor_raise(env):
    with pytest.raises(NotImplementedError, match="parallel/ slice"):
        mesh_from_topology_env(dict(env, KFT_FORCE_PLATFORM="cpu"))


def test_mesh_env_parse_and_device_lists():
    """tensor=1 is no mesh; the CPU when asked; distinct cards use NCCL,
    a card listed twice (or the CPU) gloo; unknown axes raise as in JAX."""
    assert mesh_from_topology_env({"KFT_MESH": "tensor=1"}) is None
    m = mesh_from_topology_env({"KFT_MESH": "tensor=4",
                                "KFT_FORCE_PLATFORM": "cpu"})
    assert (m.tp, m.backend, m.shared) == (4, "gloo", True)
    assert TensorMesh(2, ["cuda:0", "cuda:1"]).backend == "nccl"
    shared = TensorMesh(4, ["cuda:0"] * 4)
    assert shared.backend == "gloo" and shared.describe()["shared_card"]
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh_from_topology_env({"KFT_MESH": "bogus=2"})
    with pytest.raises(ValueError, match="needs 2 devices"):
        TensorMesh(2, ["cpu"])


def test_validate_divisibility_names_the_param(tiny):
    """A mesh whose tensor size does not divide a sharded dim raises with
    the JAX package's message, naming the first such param."""
    from kubeflow_tpu_torch.parallel import validate_divisibility

    _, _, tcfg, _ = tiny
    with pytest.raises(ValueError, match=re.escape(
            "param ['embed']: dim 256 not divisible by mesh axes "
            "('tensor',) (product 3)")):
        validate_divisibility(TensorMesh(3, ["cpu"] * 3),
                              tl.param_logical_axes(tcfg),
                              tl.param_shapes(tcfg))
    validate_divisibility(TensorMesh(2, ["cpu"] * 2),
                          tl.param_logical_axes(tcfg), tl.param_shapes(tcfg))

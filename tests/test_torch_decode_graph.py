"""The port's decode program (``serving/decode_graph.py``, the engine's
static-buffer decode body ``LLMEngine._decode_steps`` and
``LLMEngine.precompile``) on the CPU, and its CUDA-graph replay on the
card.

- The KV cache's tensors keep their addresses through every engine
  operation (a captured graph holds them): exact ``data_ptr`` equality.
- The static-buffer body, run eagerly (the CPU has no graph), against the
  JAX engine on ``llama_tiny`` in float32 on the same weights: greedy
  streams token for token (a true tie at a divergence tolerated as in
  tests/test_torch_serving.py), logprobs within 1e-4 (float32 layers
  summed in another order).
- ``precompile``'s contract: "no_depot", and the errors of the slices it
  does not take.
- The ``cuda``-marked case runs on the card only: replayed streams equal
  the eager engine's token for token, logprobs bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serving.llm import LLMEngine as JEngine
from kubeflow_tpu.serving.llm import SamplingParams as JSampling
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.ops import paged_attention as pa
from kubeflow_tpu_torch.parallel import TensorMesh
from kubeflow_tpu_torch.serving.decode_graph import DecodeBuffers
from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serving.scheduler import QuantConfig, SchedulerConfig
from kubeflow_tpu_torch.tools.decode_profile import gap_breakdown

from test_torch_flash_attention import warm_up_cpu_exp

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

TOL = dict(rtol=1e-4, atol=1e-4)
INT8 = dict(kv_dtype="int8", weight_dtype="int8")


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


# ------------------------------------------------ the cache stays in place --

def _addresses(eng) -> dict:
    return {k: t.data_ptr() for k, t in eng.cache.items()}


def _held_payload(params, cfg, quant, prompt):
    """A prefill tier's migration payload for ``prompt`` (hold, export)."""
    pre = LLMEngine(params, cfg, device="cpu", max_batch=2, max_seq=64,
                    prefill_buckets=(8, 16), quant=quant)
    req = pre.add_request(prompt, SamplingParams(max_tokens=6),
                          hold_after_prefill=True)
    while not pre.held_requests():
        pre.step()
    return req, pre.export_held_kv(req)


@pytest.mark.parametrize("quant", [None, INT8], ids=["bf16", "int8"])
def test_cache_tensors_keep_their_addresses(quant):
    """Every engine operation writes the pool, its scales and ``len`` in
    place: bucketed and chunked admission, pipelined decode, speculative
    verify with ``_body_set_lens``, ``inject_request``, abort and
    retirement. A bf16 ``llama_tiny`` (the serving dtype), unquantized
    and with int8 KV + int8 weights."""
    cfg = tl.llama_tiny(dtype=torch.bfloat16)
    params = tl.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    q = QuantConfig(**quant) if quant else None
    eng = LLMEngine(params, cfg, device="cpu", max_batch=4, max_seq=64,
                    prefill_buckets=(8, 16), decode_chunk=3, quant=q,
                    scheduler=SchedulerConfig(spec_decode=True, spec_k=2))
    ptrs, cache = _addresses(eng), eng.cache
    assert eng.paged.cache is cache

    def same(what):
        assert eng.cache is cache and _addresses(eng) == ptrs, what

    repeat = [1, 2, 3, 1, 2, 3, 1, 2]                  # the drafter's case
    long_prompt = [(7 * i) % 250 + 1 for i in range(40)]   # > bucket 16
    a = eng.add_request(repeat, SamplingParams(max_tokens=20))
    b = eng.add_request(long_prompt, SamplingParams(max_tokens=20))
    eng.step()
    same("bucketed admission, first chunk of a chunked prefill")
    while b.slot is None or eng._chunked:
        eng.step()
    same("chunked admission")
    c = eng.add_request([9, 10, 11], SamplingParams(max_tokens=20,
                                                    temperature=0.7))
    eng.step()
    same("decode of a sampled batch (the eager body)")
    eng.abort([c])
    for _ in range(3):
        eng.step()
    same("abort, then decode and verify")
    held, payload = _held_payload(params, cfg, q, [4, 5, 6, 7, 8])
    inj = eng.inject_request(
        held.prompt, held.sampling, first_token=payload["first_token"],
        first_lp=payload["first_lp"], blocks=payload["blocks"],
        n_blocks=payload["n_blocks"], kv_dtype=payload["kv_dtype"])
    assert inj is not None
    same("inject_request")
    while eng.has_work():
        eng.step()
    same("retirement")
    st = eng.scheduler_stats()
    assert st["spec_dispatches_total"] > 0          # _body_set_lens ran
    assert st["decode_dispatches_total"] > 0
    assert a.done and b.done and inj.done and len(inj.generated) == 6
    assert sorted(eng._free) == list(range(4))


def test_decode_buffers_stage_packs_one_copy():
    """``DecodeBuffers.stage`` lands every host input in its static view,
    float32 fields bit for bit."""
    buf = DecodeBuffers(3, 4, 2, torch.device("cpu"))
    tables = np.arange(12, dtype=np.int32).reshape(3, 4)
    buf.stage(np.array([7, 8, 9]), np.array([True, False, True]),
              np.array([False, True, True]), tables,
              np.array([0.0, 0.5, 1.25], np.float32), np.array([0, 5, 0]),
              np.array([1.0, 0.9, 0.25], np.float32))
    assert buf.tokens.tolist() == [7, 8, 9]
    assert buf.fresh.tolist() == [1, 0, 1]
    assert buf.active.tolist() == [0, 1, 1]
    assert buf.top_k.tolist() == [0, 5, 0]
    assert buf.temperature.tolist() == [0.0, 0.5, 1.25]
    assert buf.top_p.tolist() == [1.0, 0.8999999761581421, 0.25]
    assert buf.tables.tolist() == tables.tolist()
    assert buf.tables.is_contiguous()


# ------------------------------------------ the static-buffer body vs JAX --

@pytest.mark.parametrize("kernel", ["auto", "gather"])
def test_static_buffer_body_matches_jax(tiny, kernel):
    """Pipelined decode over the static buffers, four requests of ragged
    budgets, then a fifth admitted mid-stream into a freed slot (fresh
    host tokens, a new table row), and one sampled request making its
    dispatches the non-greedy variant: every greedy stream equals the
    JAX engine's (synchronous, as tests/test_torch_serving.py runs it),
    logprobs within 1e-4; the sampled stream runs its full budget."""
    jcfg, jp, tcfg, tp = tiny
    kw = dict(max_batch=4, max_seq=64, prefill_buckets=(8, 16),
              decode_chunk=3)
    je = JEngine(jp, jcfg, decode_pipeline=False,
                 kernel="pallas" if kernel == "auto" else "gather", **kw)
    te = LLMEngine(tp, tcfg, device="cpu", kernel=kernel, **kw)
    assert te.decode_graph is None               # no graph on the CPU
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [3] * 12,
               [(7 * i) % 250 + 1 for i in range(20)]]
    fifth = [40, 41, 42, 43]
    streams = {}
    for name, eng, sp in (("jax", je, JSampling),
                          ("port", te, SamplingParams)):
        reqs = [eng.add_request(p, sp(max_tokens=4 + 3 * i))
                for i, p in enumerate(prompts)]
        sampled = eng.add_request([60, 61], sp(max_tokens=9,
                                               temperature=0.8, top_k=5))
        for _ in range(2):
            eng.step()
        reqs.append(eng.add_request(fifth, sp(max_tokens=7)))
        while eng.has_work():
            eng.step()
        assert all(r.done for r in reqs) and len(sampled.generated) == 9
        streams[name] = reqs
    for p, a, b in zip(prompts + [fifth], streams["port"], streams["jax"]):
        assert len(a.generated) == len(b.generated)
        if a.generated != b.generated:
            i = next(k for k, (x, y) in enumerate(zip(a.generated,
                                                      b.generated)) if x != y)
            logits = np.asarray(jl.forward(
                jp, jnp.asarray([p + a.generated[:i]]), jcfg)[0, -1])
            top = logits.max()
            assert logits[a.generated[i]] >= top - 1e-4 and \
                logits[b.generated[i]] >= top - 1e-4, (p, i)
            continue
        np.testing.assert_allclose(a.logprobs, b.logprobs, **TOL)
    assert te.sched.decode_dispatches > 0 and te._fresh.sum() == 0
    assert sorted(te._free) == list(range(4))


# -------------------------------------------------------------- precompile --

def test_precompile_contract_on_the_cpu(tiny):
    """No graph and no stand-in on the CPU: ValueError, and the engine
    keeps decoding eagerly; the model's stats report nothing captured."""
    from kubeflow_tpu_torch.serving import LLMModel

    _, _, tcfg, tp = tiny
    eng = LLMEngine(tp, tcfg, device="cpu", max_seq=64, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="CUDA graph"):
        eng.precompile()
    assert eng.decode_graph is None and eng.depot_outcome is None
    [r] = eng.generate([[5, 6, 7]], SamplingParams(max_tokens=5))
    assert len(r.generated) == 5
    model = LLMModel("m", tp, tcfg, max_seq=64, prefill_buckets=(8,),
                     device="cpu")
    model.load()
    try:
        st = model.stats()
        assert st["depot_outcome"] == "none"
        assert st["precompile_seconds"] is None and st["load_seconds"] >= 0
        assert "decode_graph" not in st
    finally:
        model.unload()


@pytest.mark.parametrize("case", ["depot", "prefill", "mesh"])
def test_precompile_raises_naming_its_slice(tiny, case):
    """A depot, the prefill tier's program and a tensor mesh are later
    slices: NotImplementedError naming each, before anything is staged.
    The mesh engine is rank 1's (its own shard, no ranks spawned)."""
    from kubeflow_tpu_torch.serving.llm import GRAPH_SLICE

    _, _, tcfg, tp = tiny
    mesh = None
    if case == "mesh":
        mesh = TensorMesh(2, ["cpu", "cpu"])
        mesh.rank = 1
    eng = LLMEngine(tp, tcfg, device="cpu" if mesh is None else None,
                    max_seq=64, prefill_buckets=(8,), mesh=mesh)
    kw = {"depot": dict(depot=object()), "prefill": dict(tier="prefill"),
          "mesh": {}}[case]
    with pytest.raises(NotImplementedError) as err:
        eng.precompile(**kw)
    assert str(err.value) == GRAPH_SLICE[case]
    assert "later slice" in str(err.value)
    assert eng.decode_graph is None


def test_jax_precompile_returns_no_depot(tiny):
    """The contract the port keeps: the JAX engine's ``precompile()``
    without a depot returns "no_depot" and keeps it as
    ``depot_outcome``."""
    jcfg, jp, _, _ = tiny
    je = JEngine(jp, jcfg, max_batch=2, max_seq=32, prefill_buckets=(8,),
                 decode_chunk=2, kernel="gather")
    assert je.precompile() == je.depot_outcome == "no_depot"


def test_inv_freq_is_made_once_per_device(tiny):
    """The RoPE table a decode step reads is one kept tensor (no host copy
    per step), equal to a fresh one."""
    _, _, tcfg, _ = tiny
    a = tl.inv_freq_for(tcfg, "cpu")
    assert tl.inv_freq_for(tcfg, torch.device("cpu")) is a
    fresh = torch.as_tensor(tl.rope_frequencies(
        tcfg.head_dim, tcfg.rope_theta, tcfg.rope_scaling,
        original_max_seq=tcfg.max_seq))
    assert torch.equal(a, fresh)


def test_gap_breakdown_attributes_each_gap():
    """Idle gaps between device activities go to the innermost host call
    spanning them, the rest to Python between ops."""
    device = [(0, 10), (20, 30), (25, 40), (50, 60)]
    host = [(8, 22, "aten::mm"), (9, 21, "cudaLaunchKernel"),
            (41, 45, "cudaStreamSynchronize"), (46, 48, "aten::add"),
            (46.5, 47, "cudaMemcpyAsync")]
    got = gap_breakdown(device, host)
    assert got == {"cudaLaunchKernel": 10.0, "synchronize": 4.0,
                   "aten dispatch": 1.5, "cudaMemcpyAsync": 0.5,
                   "Python between ops": 4.0, "gaps": 2}


# --------------------------------------------------------------- the card --

@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, INT8], ids=["bf16", "int8"])
def test_cuda_replay_matches_eager(quant):
    """On the card: an engine whose decode program ``precompile`` captured
    serves the same greedy streams as an eager engine on the same
    weights, token for token with bitwise logprobs, a fifth request
    admitted mid-stream included; each replay adds n_layers x
    decode_chunk launches; a cache tensor replaced after capture makes
    the next replay raise. llama_tiny in float32 widened to head_dim 64,
    the paged kernel's smallest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg = dataclasses.replace(tl.llama_tiny(dtype=torch.float32), dim=256,
                              mlp_dim=512)
    params = tl.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
    q = QuantConfig(**quant) if quant else None
    kw = dict(max_batch=4, max_seq=128, prefill_buckets=(16, 32),
              decode_chunk=4, device="cuda", quant=q)
    eager, graph = LLMEngine(params, cfg, **kw), LLMEngine(params, cfg, **kw)
    assert graph.precompile() == graph.depot_outcome == "no_depot"
    g = graph.decode_graph
    kern = "paged_decode_attention_quant" if quant else \
        "paged_decode_attention"
    assert g.launches[kern] == cfg.n_layers * graph.decode_chunk
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [3] * 12,
               [(7 * i) % 250 + 1 for i in range(40)]]
    out = {}
    for name, eng in (("eager", eager), ("graph", graph)):
        counter = getattr(pa, kern)
        counter.launches = 0
        steps0 = eng.sched.decode_device_steps
        reqs = [eng.add_request(p, SamplingParams(max_tokens=20))
                for p in prompts]
        for _ in range(2):
            eng.step()
        reqs.append(eng.add_request([40, 41, 42],
                                    SamplingParams(max_tokens=12)))
        while eng.has_work():
            eng.step()
        assert counter.launches == cfg.n_layers * (
            eng.sched.decode_device_steps - steps0)
        out[name] = [(r.generated, r.logprobs) for r in reqs]
    assert g.replays > 0
    assert out["graph"] == out["eager"]
    graph.cache["len"] = graph.cache["len"].clone()
    graph.add_request([5, 6, 7], SamplingParams(max_tokens=20))
    with pytest.raises(RuntimeError, match="in place"):
        while graph.has_work():
            graph.step()

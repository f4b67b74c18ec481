"""The port's serving path (paged KV, LLMEngine, LLMModel + ModelServer,
the runtime's env contract) against the JAX package's on the CPU, in
float32, on the same weights (converted by ``interop.params_from_jax``).

Tolerances: 1e-4 on logits and pools (a few float32 layers summed in
another order). Greedy streams must match token for token; where two
logits tie within 1e-4 at a divergence point, ``_assert_same_stream``
accepts either maximizer (the ``assert_greedy_consistent`` idea of
tests/test_llm_engine.py) and stops comparing there.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import hf_llama as j_hf
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serving import paged_kv as j_kv
from kubeflow_tpu.serving import tokenizer as j_tok
from kubeflow_tpu.serving.llm import LLMEngine as JEngine
from kubeflow_tpu.serving.llm import SamplingParams as JSampling
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.serving import paged_kv as t_kv
from kubeflow_tpu_torch.serving.llm import (
    LLMEngine, SamplingParams, greedy_argmax, sample_logits,
)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


def _assert_same_stream(jp, jcfg, prompt, ours, theirs):
    """Token-for-token equality, tolerant only of a true tie at the first
    divergence (both tokens within 1e-4 of the JAX forward's maximum)."""
    assert len(ours) == len(theirs), (ours, theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if a == b:
            continue
        logits = np.asarray(jl.forward(
            jp, jnp.asarray([list(prompt) + list(ours[:i])]), jcfg)[0, -1])
        top = logits.max()
        assert logits[a] >= top - 1e-4 and logits[b] >= top - 1e-4, \
            (prompt, i, ours, theirs)
        return


# --------------------------------------------------------- paged_kv steps --

def _paged_pair(jcfg, tcfg, max_batch=3, max_seq=32, bs=8, nb=13):
    jpk = j_kv.PagedKV(cfg=jcfg, max_batch=max_batch, max_seq=max_seq,
                       block_size=bs, num_blocks=nb)
    tpk = t_kv.PagedKV(cfg=tcfg, max_batch=max_batch, max_seq=max_seq,
                       block_size=bs, num_blocks=nb, device="cpu")
    return jpk, tpk


@pytest.mark.parametrize("kernel", ["gather", "auto"])
def test_paged_decode_step_matches_jax(tiny, kernel):
    """Several decode steps over a pool with random resident KV: one slot
    crosses a block boundary (7 -> 8 -> 9 with block 8) while another
    sits idle at len 0. Logits of live slots and every pool block but the
    scratch block 0 stay within tolerance of the JAX step."""
    jcfg, jp, tcfg, tp = tiny
    jpk, tpk = _paged_pair(jcfg, tcfg)
    for pk in (jpk, tpk):
        assert pk.reserve(0, 7, 8) is not None
        assert pk.reserve(2, 3, 8) is not None     # slot 1 stays idle
    np.testing.assert_array_equal(jpk.tables, tpk.tables)
    rng = np.random.default_rng(0)
    k0 = rng.standard_normal(jpk.cache["k"].shape).astype(np.float32)
    v0 = rng.standard_normal(jpk.cache["v"].shape).astype(np.float32)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
              "len": jnp.asarray([7, 0, 3], jnp.int32)}
    tcache = {"k": torch.tensor(k0), "v": torch.tensor(v0),
              "len": torch.tensor([7, 0, 3], dtype=torch.int32)}
    jtab, ttab = jnp.asarray(jpk.tables), torch.tensor(tpk.tables)
    tok = np.array([5, 0, 9], np.int32)
    live = [0, 2]
    for _ in range(3):
        jlog, jcache = j_kv.paged_decode_step(
            jp, jnp.asarray(tok), jcfg, jcache, jtab,
            kernel="pallas" if kernel == "auto" else "gather")
        tlog, tcache = t_kv.paged_decode_step(
            tp, torch.tensor(tok), tcfg, tcache, ttab, kernel=kernel)
        np.testing.assert_allclose(tlog.numpy()[live],
                                   np.asarray(jlog)[live], **TOL)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy()[:, 1:],
                                   np.asarray(jcache[key])[:, 1:], **TOL)


def test_paged_insert_batch_drops_pad_rows(tiny):
    """Pad rows (slot -1) write the scratch block and their length write
    is dropped — never clamped onto a real slot."""
    _, _, tcfg, _ = tiny
    cache = t_kv.init_paged_cache(tcfg, max_batch=4, max_seq=16,
                                  block_size=4, num_blocks=9, device="cpu")
    cache["len"][:] = torch.tensor([3, 3, 3, 3], dtype=torch.int32)
    L, kvh, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    k_new = torch.randn((L, 2, 8, kvh, hd))
    blk = torch.tensor([[5, 6], [0, 0]], dtype=torch.int32)
    t_kv.paged_insert_batch(cache, k_new, k_new * 2, blk,
                            torch.tensor([7, 0], dtype=torch.int32),
                            torch.tensor([2, -1], dtype=torch.int32))
    assert cache["len"].tolist() == [3, 3, 7, 3]
    torch.testing.assert_close(cache["k"][:, 5], k_new[:, 0, :4])
    torch.testing.assert_close(cache["v"][:, 6], 2 * k_new[:, 0, 4:])


def test_paged_prefill_chunk_matches_jax(tiny):
    """Two chunks of a long prompt straight into the pool, the second
    with a radix-shared prefix masked to scratch: the hidden row and the
    slot's blocks match the JAX chunk."""
    jcfg, jp, tcfg, tp = tiny
    jpk, tpk = _paged_pair(jcfg, tcfg, max_batch=2, max_seq=32, bs=4, nb=17)
    for pk in (jpk, tpk):
        assert pk.reserve(1, 13, 4) is not None
    prompt = np.random.default_rng(1).integers(1, 250, 13).astype(np.int32)
    jcache, tcache = jpk.cache, tpk.cache
    jtab, ttab = jnp.asarray(jpk.tables), torch.tensor(tpk.tables)
    for offset, share in ((0, 0), (8, 4)):
        piece = np.zeros((1, 8), np.int32)
        part = prompt[offset:offset + 8]
        piece[0, :len(part)] = part
        jx, jcache = j_kv.paged_prefill_chunk(
            jp, jnp.asarray(piece), jcfg, jcache, jtab, 1, offset, 13, share)
        tx, tcache = t_kv.paged_prefill_chunk(
            tp, torch.tensor(piece), tcfg, tcache, ttab, 1, offset, 13,
            share)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    blocks = tpk.slot_blocks(1)
    np.testing.assert_allclose(tcache["k"].numpy()[:, blocks],
                               np.asarray(jcache["k"])[:, blocks], **TOL)


def test_resolve_decode_kernel_keeps_switch_values():
    assert t_kv.resolve_decode_kernel("gather") == "gather"
    assert t_kv.resolve_decode_kernel("auto") == "paged"
    assert t_kv.resolve_decode_kernel("pallas") == "paged"
    with pytest.raises(ValueError, match="kernel"):
        t_kv.resolve_decode_kernel("vortex")


# ------------------------------------------------------------- the engine --

def _engines(tiny, **kw):
    """The JAX engine and the port's on the same weights; the port's
    kernel="auto" (the paged kernel's plain version on the CPU) faces the
    JAX Pallas kernel in interpret mode, "gather" faces "gather".

    The JAX engine runs with synchronous decode here: on the CPU its
    pipelined decode with radix-shared prefixes gives run-to-run
    different streams (ROADMAP queue 3). The port's pipelined decode is
    held against its own synchronous mode and the JAX engine in
    test_pipelined_decode_matches_synchronous_and_jax."""
    jcfg, jp, tcfg, tp = tiny
    jkw = dict(kw, decode_pipeline=False,
               kernel="pallas" if kw.get("kernel", "auto") == "auto"
               else "gather")
    return (JEngine(jp, jcfg, **jkw),
            LLMEngine(tp, tcfg, device="cpu", **kw))


def _run_both(tiny, prompts, jsampling, tsampling, **kw):
    je, te = _engines(tiny, **kw)
    jr = je.generate(prompts, jsampling)
    tr = te.generate(prompts, tsampling)
    return je, te, jr, tr


@pytest.mark.parametrize("kernel", ["auto", "gather"])
def test_engine_streams_match_jax_mixed_and_chunked(tiny, kernel):
    """A batch of mixed prompt lengths (two buckets) plus prompts longer
    than the largest bucket (chunked prefill, interleaved with decode)."""
    jcfg, jp, _, _ = tiny
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [3] * 12,
               [(7 * i) % 250 + 1 for i in range(40)],
               [(3 * i) % 250 + 1 for i in range(33)]]
    je, te, jr, tr = _run_both(
        tiny, prompts, JSampling(max_tokens=7), SamplingParams(max_tokens=7),
        max_batch=4, max_seq=64, prefill_buckets=(8, 16), decode_chunk=3,
        kernel=kernel)
    assert te.sched.chunked_admitted == je.sched.chunked_admitted == 2
    assert te.sched.prefill_chunks == je.sched.prefill_chunks
    for p, a, b in zip(prompts, tr, jr):
        assert a.finish_reason == b.finish_reason == "length"
        _assert_same_stream(jp, jcfg, p, a.generated, b.generated)
        np.testing.assert_allclose(a.logprobs, b.logprobs, **TOL)
    assert sorted(te._free) == list(range(4))
    assert te.paged.reclaimable_blocks == je.paged.reclaimable_blocks


def test_http_stream_matches_predict(tiny):
    """The SSE generate_stream route of the port's ModelServer yields, in
    chunks, exactly the tokens V2 predict returns, then a done record."""
    from kubeflow_tpu_torch.serving import (
        InferenceClient, InferRequest, InferTensor, LLMModel,
        ModelRepository, ModelServer,
    )

    _, _, tcfg, tp = tiny
    model = LLMModel("s", tp, tcfg, max_batch=2, max_seq=64,
                     prefill_buckets=(8,), device="cpu")
    repo = ModelRepository()
    repo.register(model)
    srv = ModelServer(repo).start()
    try:
        cli = InferenceClient(srv.url)
        events = list(cli.generate_stream("s", [5, 6, 7], max_tokens=20))
        assert events[-1]["done"] and events[-1]["length"] == 20
        streamed = [t for e in events if "tokens" in e for t in e["tokens"]]
        assert len([e for e in events if "tokens" in e]) >= 2
        out = cli.infer(InferRequest("s", [InferTensor.from_numpy(
            "ids", np.array([[5, 6, 7]], np.int32))],
            parameters={"max_tokens": 20}))
        assert out.as_numpy("tokens")[0].tolist() == streamed
    finally:
        srv.stop()
        model.unload()


def test_engine_prefix_sharing_matches_jax(tiny):
    """Prompts sharing a block-aligned 16-token prefix share pool blocks
    (prefix hits > 0, same count as JAX), for bucketed and chunked
    prompts alike, with unchanged streams."""
    jcfg, jp, _, _ = tiny
    common = list(range(10, 26))
    prompts = [common + [30], common + [40, 41],
               common + list(range(60, 80)), common + list(range(90, 110))]
    je, te, jr, tr = _run_both(
        tiny, prompts, JSampling(max_tokens=5), SamplingParams(max_tokens=5),
        max_batch=4, max_seq=64, prefill_buckets=(32,), kv_block_size=8,
        kv_num_blocks=33)
    assert te.paged.prefix_hits > 0
    assert te.paged.prefix_hits == je.paged.prefix_hits
    for p, a, b in zip(prompts, tr, jr):
        _assert_same_stream(jp, jcfg, p, a.generated, b.generated)


def test_engine_eos_and_stop_ids_match_jax(tiny):
    jcfg, jp, _, _ = tiny
    _, te = _engines(tiny, max_batch=2, max_seq=64, prefill_buckets=(8,))
    prompt = [9, 10, 11, 12, 13]
    ref = te.generate([prompt], SamplingParams(max_tokens=6))[0].generated
    for field, value in (("eos_id", ref[2]), ("stop_token_ids", (ref[3],))):
        je, te = _engines(tiny, max_batch=2, max_seq=64,
                          prefill_buckets=(8,))
        [a] = te.generate([prompt], SamplingParams(max_tokens=50,
                                                   **{field: value}))
        [b] = je.generate([prompt], JSampling(max_tokens=50,
                                              **{field: value}))
        assert a.generated == b.generated
        assert a.finish_reason == b.finish_reason == "stop"
        stop = value if field == "eos_id" else value[0]
        assert a.generated[-1] == stop and stop not in a.generated[:-1]


def test_engine_abort_frees_the_slot(tiny):
    _, te = _engines(tiny, max_batch=1, max_seq=64, prefill_buckets=(8,))
    a = te.add_request([5, 6, 7], SamplingParams(max_tokens=1000))
    te.step()
    assert not te._free
    te.abort([a])
    assert a.done and a.finish_reason == "abort"
    b = te.add_request([9, 10], SamplingParams(max_tokens=4))
    while te.has_work():
        te.step()
    assert b.done and len(b.generated) == 4 and te._free == [0]
    assert te.paged.reclaimable_blocks == te.paged.num_blocks - 1


def test_pipelined_decode_matches_synchronous_and_jax(tiny):
    """Double-buffered decode (dispatch chunk N+1 before reading chunk N)
    is invisible to outputs: identical streams to synchronous mode and to
    the JAX engine, through slot churn and a mid-flight join."""
    jcfg, jp, tcfg, tp = tiny
    outs = {}
    for name, make in (
            ("jax", lambda: JEngine(jp, jcfg, max_batch=2, max_seq=64,
                                    prefill_buckets=(8,), decode_chunk=3,
                                    kernel="gather")),
            ("sync", lambda: LLMEngine(tp, tcfg, max_batch=2, max_seq=64,
                                       prefill_buckets=(8,), decode_chunk=3,
                                       decode_pipeline=False, device="cpu")),
            ("pipelined", lambda: LLMEngine(tp, tcfg, max_batch=2,
                                            max_seq=64, prefill_buckets=(8,),
                                            decode_chunk=3, device="cpu"))):
        eng = make()
        sp = JSampling if name == "jax" else SamplingParams
        reqs = [eng.add_request([3 + i, 4 + i], sp(max_tokens=5 + (i % 3)))
                for i in range(4)]
        for _ in range(2):
            eng.step()
        late = eng.add_request([40, 41, 42], sp(max_tokens=6))
        while eng.has_work():
            eng.step()
        assert all(r.done for r in reqs + [late])
        outs[name] = [r.generated for r in reqs + [late]]
    assert outs["pipelined"] == outs["sync"] == outs["jax"]


def test_engine_rejects_later_slices(tiny):
    """Speculative decoding is served now: spec_decode=True builds the
    drafter and serves (its parity cases are in
    tests/test_torch_spec_decode.py). The exact-parity hatch serves
    unquantized; quantized serving's cases are in
    tests/test_torch_quant.py."""
    from kubeflow_tpu_torch.serving.scheduler import (
        QuantConfig, SchedulerConfig,
    )
    from kubeflow_tpu_torch.serving.spec_decode import NgramDrafter

    _, _, tcfg, tp = tiny
    spec = LLMEngine(tp, tcfg, device="cpu", max_seq=64,
                     prefill_buckets=(8,),
                     scheduler=SchedulerConfig(spec_decode=True, spec_k=2))
    assert isinstance(spec.spec, NgramDrafter) and spec.spec.k == 2
    [req] = spec.generate([[1, 2, 3, 1, 2, 3, 1, 2]],
                          SamplingParams(max_tokens=6))
    assert len(req.generated) == 6
    st = spec.scheduler_stats()          # every round ran the spec branch
    assert st["spec_dispatches_total"] + st["spec_undrafted_steps_total"] > 0
    eng = LLMEngine(tp, tcfg, device="cpu", max_seq=64, prefill_buckets=(8,),
                    quant=QuantConfig(kv_dtype="int8", exact_parity=True))
    assert eng.quant.tag() == "quant=off"


# --------------------------------------------------------------- sampling --

def test_sample_logits_controls():
    logits = torch.tensor([[1.0, 2.0, 5.0, 0.5]] * 2)
    gen = torch.Generator().manual_seed(0)
    zeros_i = torch.zeros(2, dtype=torch.int32)
    greedy = sample_logits(logits, gen, torch.zeros(2), zeros_i,
                           torch.ones(2))
    assert greedy.tolist() == [2, 2]
    forced = sample_logits(logits, gen, torch.full((2,), 10.0),
                           torch.ones(2, dtype=torch.int32), torch.ones(2))
    assert forced.tolist() == [2, 2]
    nucleus = sample_logits(logits, gen, torch.ones(2), zeros_i,
                            torch.full((2,), 0.5))
    assert nucleus.tolist() == [2, 2]
    # a hot temperature with no filter does sample other tokens
    wide = sample_logits(logits.repeat(64, 1), gen, torch.full((128,), 50.0),
                         torch.zeros(128, dtype=torch.int32),
                         torch.ones(128))
    assert len(set(wide.tolist())) > 1


def test_topp_applied_after_topk():
    """probs [0.4, 0.3, 0.2, 0.1]: top_k=2 renormalizes to [0.571, 0.429];
    top_p=0.5 then keeps ONLY the argmax."""
    logits = torch.log(torch.tensor([[0.4, 0.3, 0.2, 0.1]]))
    gen = torch.Generator().manual_seed(0)
    for _ in range(64):
        tok = sample_logits(logits, gen, torch.ones(1),
                            torch.full((1,), 2, dtype=torch.int32),
                            torch.full((1,), 0.5))
        assert int(tok[0]) == 0


def test_greedy_argmax_lowest_index_tie_break():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [7.0, 7.0, 7.0, 7.0]])
    assert greedy_argmax(logits).tolist() == [1, 0]
    assert greedy_argmax(logits).dtype == torch.int32


# ------------------------------------------------------ HTTP + runtime env --

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box with five dozen liquor jugs",
    "hello world hello serving hello port",
]


def _fixture_checkpoint(tmp_path):
    """An HF-layout checkpoint written by the JAX package, with a trained
    byte-level BPE tokenizer (the tests/test_real_weights.py fixture)."""
    cfg = dataclasses.replace(jl.llama_tiny(dtype=jnp.float32),
                              vocab_size=512)
    params = jl.init_params(jax.random.key(0), cfg)
    model_dir = str(tmp_path / "ckpt")
    j_hf.save_pretrained(model_dir, cfg, params)
    tok = j_tok.train_bpe(TEXTS, vocab_size=cfg.vocab_size)
    tok.save(os.path.join(model_dir, "tokenizer.json"))
    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    c["bos_token_id"], c["eos_token_id"] = tok.bos_id, tok.eos_id
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(c, f)
    return model_dir


def test_runtime_http_text_matches_jax(tmp_path):
    """build_model_from_env (KFT_FORCE_PLATFORM=cpu) over an HF checkpoint
    + tokenizer: the port's ModelServer predicts the same text as the JAX
    LLMModel on the same files."""
    from kubeflow_tpu.serving.runtime import (
        build_model_from_env as j_build,
    )
    from kubeflow_tpu_torch.serving import (
        InferenceClient, InferRequest, InferTensor, ModelRepository,
        ModelServer,
    )
    from kubeflow_tpu_torch.serving.runtime import build_model_from_env

    model_dir = _fixture_checkpoint(tmp_path)
    env = {"KFT_MODEL_NAME": "tiny", "KFT_MODEL_DIR": model_dir,
           "KFT_DTYPE": "float32", "KFT_MAX_BATCH": "2",
           "KFT_MAX_SEQ": "64", "KFT_FORCE_PLATFORM": "cpu"}
    texts = ["the quick brown fox", "hello world"]
    params = {"max_tokens": 6}

    jmodel = j_build(env)
    jmodel.load()
    try:
        jout = jmodel.predict(InferRequest(
            "tiny", [InferTensor("text", [2], "BYTES", texts)],
            parameters=dict(params)))
    finally:
        jmodel.unload()

    model = build_model_from_env(env)
    assert model.device.type == "cpu"
    repo = ModelRepository()
    repo.register(model)
    srv = ModelServer(repo).start()
    try:
        out = InferenceClient(srv.url).infer(InferRequest(
            "tiny", [InferTensor("text", [2], "BYTES", texts)],
            parameters=dict(params)))
        assert out.as_numpy("text").tolist() == \
            jout.as_numpy("text").tolist()
        np.testing.assert_array_equal(out.as_numpy("tokens"),
                                      jout.as_numpy("tokens"))
        assert model.stats()["generated_tokens_total"] == \
            int(out.as_numpy("lengths").sum())
    finally:
        srv.stop()
        model.unload()


@pytest.mark.parametrize("key", ["KFT_MESH", "KFT_TIER", "KFT_DEPOT",
                                 "KFT_MODELS_CONFIG_DIR"])
def test_runtime_raises_for_later_slices(tmp_path, key):
    """KFT_MESH: the expert and tensor axes are served now
    (tests/test_torch_tp.py, tests/test_torch_moe_expert_serving.py); a
    mesh over another axis is the later slice that raises. KFT_TIER:
    disaggregated serving is served now, beside an expert or tensor mesh
    too (tests/test_torch_disagg.py, tests/test_torch_disagg_mesh.py); a
    tier beside a mesh over another axis raises that mesh's slice.
    KFT_DEPOT no longer raises: the depot is a fast path that never
    fails a load (the reference's rule), and on the CPU, where nothing
    is captured, it changes nothing: the runtime loads and serves, the
    depot is never touched and the outcome stays "none"."""
    from kubeflow_tpu_torch.serving.runtime import build_model_from_env

    if key == "KFT_DEPOT":
        from kubeflow_tpu_torch.serving import InferRequest, InferTensor

        depot = tmp_path / "depot"
        model = build_model_from_env({
            "KFT_MODEL_NAME": "tiny", "KFT_DTYPE": "float32",
            "KFT_MODEL_DIR": _fixture_checkpoint(tmp_path),
            "KFT_MAX_SEQ": "64", "KFT_FORCE_PLATFORM": "cpu",
            "KFT_DEPOT": str(depot)})
        model.load()
        try:
            out = model.predict(InferRequest(
                "tiny", [InferTensor("text", [1], "BYTES", ["hello"])],
                parameters={"max_tokens": 3}))
            assert int(out.as_numpy("lengths")[0]) == 3
            st = model.stats()
            assert st["depot_outcome"] == "none" and "depot" not in st
        finally:
            model.unload()
        assert not depot.exists()
        return
    env = {"KFT_MODEL_DIR": str(tmp_path), "KFT_FORCE_PLATFORM": "cpu",
           key: "data=2,tensor=2" if key == "KFT_MESH" else "x"}
    if key == "KFT_TIER":
        env.update(KFT_TIER="decode", KFT_MESH="context=2,tensor=2")
    with pytest.raises(NotImplementedError,
                       match="KFT_MESH" if key == "KFT_TIER" else key):
        build_model_from_env(env)


def test_runtime_rejects_an_unknown_tier(tmp_path):
    """KFT_TIER names prefill or decode, as the JAX TierRuntime insists."""
    from kubeflow_tpu_torch.serving.runtime import build_model_from_env

    with pytest.raises(ValueError, match="KFT_TIER"):
        build_model_from_env({"KFT_MODEL_DIR": str(tmp_path),
                              "KFT_FORCE_PLATFORM": "cpu", "KFT_TIER": "x"})


def test_runtime_env_parsing():
    from kubeflow_tpu_torch.serving import runtime

    assert runtime.scheduler_from_env({}) is None
    sc = runtime.scheduler_from_env({"KFT_PREFILL_QUOTA": "32",
                                     "KFT_RADIX_CACHE": "0"})
    assert sc.prefill_tokens_per_step == 32 and not sc.radix_cache
    assert runtime.quant_from_env({}) is None
    assert runtime.quant_from_env(
        {"KFT_QUANT_KV": "int8"}).kv_dtype == "int8"
    with pytest.raises(ValueError, match="KFT_FORCE_PLATFORM"):
        runtime.build_model_from_env({"KFT_FORCE_PLATFORM": "tpu",
                                      "KFT_MODEL_DIR": "/nonexistent"})

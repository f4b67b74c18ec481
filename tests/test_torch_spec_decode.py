"""The port's speculative decoding (``serving/spec_decode.py``,
``paged_kv.paged_verify_step``, the engine's draft+verify round, its
counters and env plumbing) against the JAX package on the CPU, in
float32, on the same weights (converted by ``interop.params_from_jax``)
and the same numpy-seeded inputs.

Tolerances, each with its reason:

- ``NgramDrafter``: EXACT (the same integer algorithm).
- ``paged_verify_step`` logits: 1e-5 (float32 layers summed in another
  order); the pools: 1e-5 for float pools, ONE quantization step for
  int8 pools (a K/V value a last-ulp from a rounding boundary may land
  on the neighbouring step, as tests/test_torch_quant.py allows).
- Engine streams: token for token against the JAX engine with
  ``spec_decode=True`` (synchronous decode; its pipelined decode is
  nondeterministic on the CPU) and against the port's own non-speculative
  engine; logprobs within 1e-4 (the decode and verify programs sum in
  other orders).
- The ``cuda``-marked case runs on the card only: verify logits against
  four sequential decode steps through the paged kernel, f32 within
  2e-4 (the kernel's split walk against dense attention).
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serving import paged_kv as j_kv
from kubeflow_tpu.serving.llm import LLMEngine as JEngine
from kubeflow_tpu.serving.llm import SamplingParams as JSampling
from kubeflow_tpu.serving.runtime import scheduler_from_env as j_sched_env
from kubeflow_tpu.serving.scheduler import QuantConfig as JQuant
from kubeflow_tpu.serving.scheduler import SchedulerConfig as JSched
from kubeflow_tpu.serving.spec_decode import NgramDrafter as JDrafter
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.serving import paged_kv as t_kv
from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serving.scheduler import QuantConfig, SchedulerConfig
from kubeflow_tpu_torch.serving.spec_decode import NgramDrafter, make_drafter

from test_torch_flash_attention import warm_up_cpu_exp

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


# ---------------------------------------------------------------- drafter --

@pytest.mark.parametrize("k,max_ngram,min_ngram", [(3, 3, 1), (4, 2, 1),
                                                   (2, 4, 2)])
def test_ngram_drafter_matches_jax(k, max_ngram, min_ngram):
    """Random contexts over small vocabularies (so n-grams repeat) and
    lengths 0..60: the port's proposals equal JAX's."""
    rng = np.random.default_rng(k * 100 + max_ngram)
    ours = NgramDrafter(k=k, max_ngram=max_ngram, min_ngram=min_ngram)
    theirs = JDrafter(k=k, max_ngram=max_ngram, min_ngram=min_ngram)
    hits = 0
    for _ in range(200):
        ctx = rng.integers(1, int(rng.integers(2, 12)),
                           int(rng.integers(0, 60))).tolist()
        got = ours.draft(ctx)
        assert got == theirs.draft(ctx), ctx
        hits += bool(got)
    assert hits > 50                     # matches really happened


def test_drafter_cases_and_registry():
    """The JAX package's own drafter cases, and its registry errors."""
    d = NgramDrafter(k=3, max_ngram=3, min_ngram=1)
    assert d.draft([1, 2, 9, 1, 2, 8, 7, 1, 2]) == [8, 7, 1]
    assert d.draft([5, 6, 7, 8, 3, 7, 5, 6, 7]) == [8, 3, 7]
    d = NgramDrafter(k=2)
    assert d.draft([1, 2, 3, 4]) == [] and d.draft([7]) == []
    assert d.draft([1, 2, 3, 1, 2, 3, 1, 2]) == [3, 1]
    assert make_drafter("ngram", 4).k == 4
    assert make_drafter("prompt_lookup", 2).k == 2
    with pytest.raises(ValueError, match="spec_drafter"):
        make_drafter("medusa", 3)
    with pytest.raises(ValueError, match="spec_k"):
        NgramDrafter(k=0)


# ------------------------------------------------------------ verify step --

def _pool_pair(jcfg, tcfg, pool, nb=9, bs=8, max_batch=3, max_seq=32):
    """A JAX cache and the port's with the same random resident KV: f32,
    bf16 (the pool dtype; compute stays f32) or int8 (quantized by the
    JAX package, bytes carried over exactly)."""
    rng = np.random.default_rng(5)
    shape = (jcfg.n_layers, nb, bs, jcfg.n_kv_heads, jcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    if pool == "int8":
        jc = j_kv.init_paged_cache(jcfg, max_batch, max_seq, bs, nb,
                                   quant_kv="int8")
        for name, x in (("k", k0), ("v", v0)):
            amax = np.abs(x).max(axis=(2, 4))               # [L, NB, KV]
            sc = (amax / 127.0).astype(np.float32)
            q = np.clip(np.round(x / sc[:, :, None, :, None]), -127, 127)
            jc[name] = jnp.asarray(q.astype(np.int8))
            jc[name + "_scale"] = jnp.asarray(sc)
    else:
        dt = jnp.bfloat16 if pool == "bf16" else jnp.float32
        jc = {"k": jnp.asarray(k0).astype(dt), "v": jnp.asarray(v0).astype(dt)}
    jc["len"] = jnp.asarray([6, 0, 13], jnp.int32)
    tc = {}
    for key, val in jc.items():
        arr = np.asarray(jax.device_get(val))
        if arr.dtype == jnp.bfloat16:
            tc[key] = torch.from_numpy(arr.view(np.uint16).astype(
                np.int16)).view(torch.bfloat16)
        else:
            tc[key] = torch.tensor(arr)
    return jc, tc


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_verify_step_matches_jax(tiny, pool):
    """One width-4 verify over a pool with random resident KV: slot 0 runs
    past its reservation (rows 8, 9 at/after limit 8 go to scratch),
    slot 1 is idle (limit 0), slot 2 crosses a block boundary. Logits of
    the live rows, every pool block but scratch block 0 and the
    unadvanced lengths match the JAX step."""
    jcfg, jp, tcfg, tp = tiny
    jc, tc = _pool_pair(jcfg, tcfg, pool)
    tables = np.array([[1, 0, 0, 0], [0, 0, 0, 0], [3, 4, 5, 0]], np.int32)
    limit = np.array([8, 0, 24], np.int32)
    tokens = np.array([[5, 6, 7, 8], [0, 0, 0, 0], [9, 10, 11, 12]],
                      np.int32)
    before = {k: v.clone() for k, v in tc.items()}
    jlog, jc = j_kv.paged_verify_step(jp, jnp.asarray(tokens), jcfg, jc,
                                      jnp.asarray(tables),
                                      jnp.asarray(limit))
    tlog, tc = t_kv.paged_verify_step(tp, torch.tensor(tokens), tcfg, tc,
                                      torch.tensor(tables),
                                      torch.tensor(limit))
    assert tlog.shape == (3, 4, tcfg.vocab_size)
    assert tlog.dtype == torch.float32
    jlog = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy()[0, :2], jlog[0, :2], **TOL)
    np.testing.assert_allclose(tlog.numpy()[2], jlog[2], **TOL)
    assert tc["len"].tolist() == [6, 0, 13]
    for key in ("k", "v"):
        ours = tc[key][:, 1:].float().numpy()
        theirs = np.asarray(jc[key][:, 1:].astype(jnp.float32))
        if pool == "int8":
            assert np.abs(ours - theirs).max() <= 1
            np.testing.assert_allclose(tc[key + "_scale"][:, 1:].numpy(),
                                       np.asarray(jc[key + "_scale"])[:, 1:],
                                       rtol=1e-6)
        else:
            np.testing.assert_allclose(ours, theirs, **TOL)
        # the tail past slot 0's reservation left every other block alone
        for blk in (2, 6, 7, 8):
            assert torch.equal(tc[key][:, blk], before[key][:, blk])


def test_verify_step_matches_sequential_decode(tiny):
    """Feeding the greedy chain through ONE verify yields the logits the
    decode path produces one step at a time (same KV writes, same
    masks), for the gather oracle and the paged kernel's plain version."""
    _, _, tcfg, tp = tiny
    pk = t_kv.PagedKV(cfg=tcfg, max_batch=2, max_seq=32, block_size=8,
                      num_blocks=9, device="cpu")
    assert pk.reserve(0, 3, 8) is not None
    assert pk.reserve(1, 5, 8) is not None
    tables = torch.tensor(pk.tables)
    rng = np.random.default_rng(2)
    for key in ("k", "v"):
        pk.cache[key].copy_(torch.tensor(rng.standard_normal(
            pk.cache[key].shape).astype(np.float32)))
    pk.cache["len"] = torch.tensor([3, 5], dtype=torch.int32)
    for kernel in ("gather", "auto"):
        cache_d = {k: v.clone() for k, v in pk.cache.items()}
        cache_v = {k: v.clone() for k, v in pk.cache.items()}
        tok = torch.tensor([11, 7], dtype=torch.int32)
        chain, dec = [tok], []
        for _ in range(4):
            lg, cache_d = t_kv.paged_decode_step(tp, tok, tcfg, cache_d,
                                                 tables, kernel=kernel)
            dec.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
            chain.append(tok)
        vlog, _ = t_kv.paged_verify_step(
            tp, torch.stack(chain[:4], 1), tcfg, cache_v, tables,
            torch.tensor([16, 16], dtype=torch.int32))
        for s in range(4):
            torch.testing.assert_close(vlog[:, s], dec[s], rtol=1e-4,
                                       atol=1e-4)


# ---------------------------------------------------------------- streams --

def _jax_engine(tiny, quant=None, **kw):
    jcfg, jp, _, _ = tiny
    jq = JQuant(**quant) if quant else None
    return JEngine(jp, jcfg, decode_pipeline=False, kernel="pallas",
                   quant=jq, scheduler=JSched(spec_decode=True, spec_k=3),
                   **kw)


def _port_engines(tiny, quant=None, **kw):
    """The port's speculative engine and its non-speculative twin."""
    _, _, tcfg, tp = tiny
    tq = QuantConfig(**quant) if quant else None
    return (LLMEngine(tp, tcfg, device="cpu", quant=tq,
                      scheduler=SchedulerConfig(spec_decode=True, spec_k=3),
                      **kw),
            LLMEngine(tp, tcfg, device="cpu", quant=tq, **kw))


def _ragged(eng, sp):
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [3] * 12,
               [1, 2, 3, 1, 2, 3, 1, 2], [42, 17]]
    reqs = [eng.add_request(p, sp(max_tokens=6 + (i % 3)))
            for i, p in enumerate(prompts)]
    while eng.has_work():
        eng.step()
    return reqs


def _prefix_shared(eng, sp):
    rng = np.random.default_rng(7)
    system = rng.integers(1, 256, 16).tolist()
    prompts = [system + rng.integers(1, 256, 6).tolist() for _ in range(6)]
    return eng.generate(prompts, sp(max_tokens=12))


def _chunked(eng, sp):
    """A prompt past every bucket streams through chunked prefill while a
    repeating one verifies: the mid-prefill slot's table row must mask to
    scratch in the verify dispatch as in decode."""
    long_prompt = [(7 * i) % 250 + 1 for i in range(40)]   # > bucket 16
    return eng.generate([[1, 2, 3, 1, 2, 3, 1, 2], long_prompt],
                        sp(max_tokens=12))


STREAM_CASES = {
    # name: (request pattern, engine kwargs, quant)
    "ragged": (_ragged, dict(max_batch=2, max_seq=64,
                             prefill_buckets=(8, 16), decode_chunk=3), None),
    "prefix_shared": (_prefix_shared, dict(max_batch=4, max_seq=64,
                                           prefill_buckets=(24,),
                                           kv_block_size=8, decode_chunk=4),
                      None),
    "chunked": (_chunked, dict(max_batch=2, max_seq=128,
                               prefill_buckets=(16,)), None),
    "int8": (_ragged, dict(max_batch=2, max_seq=64, prefill_buckets=(8, 16),
                           decode_chunk=3),
             dict(kv_dtype="int8", weight_dtype="int8")),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_spec_streams_match_jax(tiny, case):
    """Greedy streams through draft+verify: token for token the JAX
    speculative engine's and the port's own non-speculative engine's,
    with matching verify counters (the same drafts were scored)."""
    drive, kw, quant = STREAM_CASES[case]
    je = _jax_engine(tiny, quant, **kw)
    te, base = _port_engines(tiny, quant, **kw)
    theirs = drive(je, JSampling)
    ours = drive(te, SamplingParams)
    plain = drive(base, SamplingParams)
    assert all(r.done for r in ours)
    assert [r.generated for r in ours] == [r.generated for r in theirs]
    assert [r.generated for r in ours] == [r.generated for r in plain]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=1e-4,
                                   atol=1e-4)
    st, jst = te.scheduler_stats(), je.scheduler_stats()
    for key in ("spec_dispatches_total", "spec_draft_tokens_total",
                "spec_accepted_draft_tokens_total",
                "spec_committed_tokens_total", "spec_undrafted_steps_total"):
        assert st[key] == jst[key], key
    assert st["spec_dispatches_total"] > 0
    assert st["accepted_tokens_per_step"] >= 1.0
    if case == "prefix_shared":
        assert te.paged.prefix_hits == je.paged.prefix_hits > 0
    if case == "chunked":
        assert te.sched.chunked_admitted == 1
    assert sorted(te._free) == list(range(kw["max_batch"]))


def test_spec_abort_midflight_matches_jax(tiny):
    """Aborting one stream mid-spec frees its slot; the survivor and a
    late joiner match the JAX engine token for token."""
    kw = dict(max_batch=2, max_seq=64, prefill_buckets=(8,))
    outs = []
    for eng, sp in ((_jax_engine(tiny, **kw), JSampling),
                    (_port_engines(tiny, **kw)[0], SamplingParams)):
        a = eng.add_request([5, 6, 7], sp(max_tokens=1000))
        b = eng.add_request([9, 10, 11], sp(max_tokens=10))
        for _ in range(2):
            eng.step()
        eng.abort([a])
        late = eng.add_request([3, 1, 2], sp(max_tokens=6))
        while eng.has_work():
            eng.step()
        assert a.finish_reason == "abort"
        assert sorted(eng._free) == [0, 1]
        outs.append([b.generated, late.generated])
    assert outs[0] == outs[1]


def test_spec_always_wrong_drafter_matches_jax(tiny):
    """A drafter that only proposes wrong tokens: every verify still
    commits the target's own token (accepted_tokens_per_step == 1.0),
    and the streams equal JAX's."""

    class WrongDrafter:
        k = 3

        def draft(self, context):
            return [0, 0, 0]

    kw = dict(max_batch=2, max_seq=64, prefill_buckets=(8,))
    prompts = [[5, 6, 7], [9, 10]]
    je = _jax_engine(tiny, **kw)
    te = _port_engines(tiny, **kw)[0]
    je.spec = WrongDrafter()
    te.spec = WrongDrafter()
    theirs = je.generate(prompts, JSampling(max_tokens=8))
    ours = te.generate(prompts, SamplingParams(max_tokens=8))
    assert [r.generated for r in ours] == [r.generated for r in theirs]
    st = te.scheduler_stats()
    assert st["spec_slot_rounds_total"] > 0
    assert st["spec_accepted_draft_tokens_total"] == 0
    assert st["accepted_tokens_per_step"] == 1.0
    assert st["spec_dispatches_total"] == \
        je.scheduler_stats()["spec_dispatches_total"]


def test_spec_nongreedy_batch_falls_back(tiny):
    """A non-greedy request disables speculation for the dispatch
    (counted in stats); with top_k=1 the sampled stream still equals
    greedy, and JAX's."""
    kw = dict(max_batch=2, max_seq=64, prefill_buckets=(8,))
    prompts = [[5, 6, 7], [9, 10]]
    te = _port_engines(tiny, **kw)[0]
    ours = te.generate(prompts, SamplingParams(max_tokens=6, temperature=0.7,
                                               top_k=1))
    st = te.scheduler_stats()
    assert st["spec_fallbacks_total"] > 0
    assert st["spec_dispatches_total"] == 0
    theirs = _jax_engine(tiny, **kw).generate(prompts,
                                              JSampling(max_tokens=6))
    assert [r.generated for r in ours] == [r.generated for r in theirs]


def test_spec_tensor_parallel_matches_one_card(tiny, tmp_path):
    """tensor=2 over gloo (two processes): the speculative engine's
    streams and counters equal the one-card speculative engine's, every
    rank ran every verify and sampled the same tokens (equal digests)."""
    from kubeflow_tpu_torch.parallel import TensorMesh

    _, _, tcfg, tp = tiny
    kw = dict(max_batch=2, max_seq=64, prefill_buckets=(8, 16),
              decode_chunk=3,
              scheduler=SchedulerConfig(spec_decode=True, spec_k=3))
    one = LLMEngine(tp, tcfg, device="cpu", **kw)
    ref = _ragged(one, SamplingParams)
    te = LLMEngine(tp, tcfg, mesh=TensorMesh(2, ["cpu", "cpu"],
                                             timeout_s=120.0,
                                             rendezvous_dir=str(tmp_path)),
                   **kw)
    try:
        ours = _ragged(te, SamplingParams)
        status = te.tp_status()
    finally:
        te.close()
    assert [r.generated for r in ours] == [r.generated for r in ref]
    st = te.scheduler_stats()
    assert st["spec_dispatches_total"] == \
        one.scheduler_stats()["spec_dispatches_total"] > 0
    sampled = (te.sched.decode_dispatches + te.prefill_dispatches
               + te.sched.chunked_admitted + st["spec_dispatches_total"])
    assert [s["samples"] for s in status] == [sampled] * 2
    assert len({s["token_digest"] for s in status}) == 1


# --------------------------------------------------------------- plumbing --

@pytest.mark.parametrize("env", [
    {"KFT_SPEC_DECODE": "1", "KFT_SPEC_K": "7", "KFT_SPEC_DRAFTER": "ngram"},
    {"KFT_SPEC_DECODE": "1"},
    {"KFT_RADIX_CACHE": "1"},
    {},
])
def test_spec_env_plumbing_matches_jax(env):
    from kubeflow_tpu_torch.serving.runtime import scheduler_from_env

    ours, theirs = scheduler_from_env(env), j_sched_env(env)
    if theirs is None:
        assert ours is None
        return
    for field in ("spec_decode", "spec_k", "spec_drafter", "radix_cache"):
        assert getattr(ours, field) == getattr(theirs, field), field


def test_spec_counters_ride_model_stats_and_metrics(tiny):
    """LLMModel(spec_decode=True) serves; stats()["sched"] carries the
    spec counter family and /metrics renders it as kft_model_sched_*."""
    from kubeflow_tpu_torch.serving import (
        InferenceClient, LLMModel, ModelRepository, ModelServer,
    )

    _, _, tcfg, tp = tiny
    model = LLMModel("m", tp, tcfg, max_batch=2, max_seq=64,
                     prefill_buckets=(8,), device="cpu",
                     scheduler=SchedulerConfig(spec_decode=True))
    repo = ModelRepository()
    repo.register(model)
    srv = ModelServer(repo).start()
    try:
        cli = InferenceClient(srv.url)
        events = list(cli.generate_stream("m", [1, 2, 3, 1, 2, 3, 1, 2],
                                          max_tokens=12))
        assert events[-1]["done"] and events[-1]["length"] == 12
        stats = model.stats()
        assert stats["kernel_downgrades_total"] == 0
        for key in ("spec_dispatches_total", "spec_committed_tokens_total",
                    "spec_fallbacks_total", "spec_undrafted_steps_total",
                    "accepted_tokens_per_step"):
            assert key in stats["sched"]
        assert stats["sched"]["spec_dispatches_total"] > 0
        text = srv._render_metrics()
        assert 'kft_model_sched_spec_dispatches_total{model="m"}' in text
        assert 'kft_model_sched_accepted_tokens_per_step{model="m"}' in text
    finally:
        srv.stop()
        model.unload()


# ----------------------------------------------------------------- on card --

@pytest.mark.cuda
def test_cuda_verify_logits_match_sequential_decode():
    """On the card, f32: one verify (dense attention over the gathered
    view) against four decode steps through the paged kernel (row 1)
    over the same tokens; the kernel really ran."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops import paged_attention as pa

    # llama_tiny at head_dim 64, the paged kernel's smallest
    cfg = dataclasses.replace(llama.llama_tiny(dtype=torch.float32),
                              dim=256, mlp_dim=512, max_seq=256)
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
    pk = t_kv.PagedKV(cfg=cfg, max_batch=2, max_seq=64, block_size=16,
                      num_blocks=9, device="cuda")
    assert pk.reserve(0, 13, 16) is not None
    assert pk.reserve(1, 30, 16) is not None
    gen = torch.Generator(device="cuda").manual_seed(1)
    for key in ("k", "v"):
        pk.cache[key].normal_(generator=gen)
    pk.cache["len"] = torch.tensor([13, 30], dtype=torch.int32,
                                   device="cuda")
    tables = torch.tensor(pk.tables, device="cuda")
    cache_d = {k: v.clone() for k, v in pk.cache.items()}
    cache_v = {k: v.clone() for k, v in pk.cache.items()}
    tok = torch.tensor([11, 7], dtype=torch.int32, device="cuda")
    chain, dec = [tok], []
    pa.paged_decode_attention.launches = 0
    for _ in range(4):
        lg, cache_d = t_kv.paged_decode_step(params, tok, cfg, cache_d,
                                             tables, kernel="auto")
        dec.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        chain.append(tok)
    assert pa.paged_decode_attention.launches == 4 * cfg.n_layers
    vlog, _ = t_kv.paged_verify_step(
        params, torch.stack(chain[:4], 1), cfg, cache_v, tables,
        torch.tensor([48, 64], dtype=torch.int32, device="cuda"))
    for s in range(4):
        torch.testing.assert_close(vlog[:, s], dec[s], rtol=2e-4, atol=2e-4)

"""The port's disaggregated prefill/decode serving (``serving/disagg.py``,
``paged_kv.gather_kv_blocks`` / ``scatter_kv_blocks``, the engine's hold,
export and inject, the tier runtime and the ``/disagg`` routes) against
the JAX package on the CPU, in float32, on the same weights (converted
by ``interop.params_from_jax``). The engine- and wire-level half of
tests/test_disagg.py; its controller, autoscaler and router cases are
control plane, which the port does not carry.

Tolerances, each with its reason:

- The migration payload and the framing: BIT-EQUAL to the JAX package's
  (the same bytes gathered, the same pickle framing). bf16 pools compare
  as their uint16 bit patterns, fp8 as uint8.
- Migrated streams: token for token against the JAX engine's greedy
  stream on the same prompt (synchronous decode, kernel "pallas" facing
  the port's "auto"), and against the port's own co-located engine.
- The ``cuda``-marked case runs on the card only: a decode over blocks
  scattered in from another engine against the same decode over blocks
  written locally, through rows 1-2's kernels: token for token.
"""

import dataclasses
import json
import socket
import time
from urllib import request as urlrequest

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.mpmd import _encode as j_encode
from kubeflow_tpu.serving import paged_kv as j_kv
from kubeflow_tpu.serving.llm import LLMEngine as JEngine
from kubeflow_tpu.serving.llm import SamplingParams as JSampling
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.serving import disagg as t_disagg
from kubeflow_tpu_torch.serving import paged_kv as t_kv
from kubeflow_tpu_torch.serving.disagg import (
    KVMigrator, MigrationStats, TierRuntime,
)
from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serving.scheduler import QuantConfig

from test_torch_flash_attention import warm_up_cpu_exp

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

PROMPT = [5, 6, 7, 9, 10, 11, 12, 13, 3, 4, 2, 8]


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def jax_greedy(tiny):
    """The JAX co-located engine's greedy stream for a prompt and budget
    (synchronous decode, kernel "pallas"), memoized."""
    jcfg, jp, _, _ = tiny
    eng = JEngine(jp, jcfg, max_batch=4, max_seq=64, prefill_buckets=(8, 16),
                  decode_pipeline=False, kernel="pallas")
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            [r] = eng.generate([list(prompt)], JSampling(max_tokens=n))
            memo[key] = list(r.generated)
        return memo[key]
    return run


def _eng(tiny, **kw):
    _, _, tcfg, tp = tiny
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return LLMEngine(tp, tcfg, device="cpu", **kw)


def _step_until(eng, pred, max_steps=300):
    for _ in range(max_steps):
        if pred():
            return True
        if not eng.has_work():
            break
        eng.step()
    return pred()


def _held_payload(tiny, max_tokens, prompt=PROMPT, **kw):
    """Prefill ``prompt`` on a fresh engine, hold, export and release:
    the migration payload."""
    src = _eng(tiny, **kw)
    req = src.add_request(prompt, SamplingParams(max_tokens=max_tokens),
                          hold_after_prefill=True)
    assert _step_until(src, lambda: req.t_first_token > 0)
    payload = src.export_held_kv(req)
    assert src.release_held(req)
    return payload


def _inject(eng, payload):
    sd = dict(payload["sampling"])
    sd["stop_token_ids"] = tuple(sd["stop_token_ids"])
    return eng.inject_request(
        payload["prompt"], SamplingParams(**sd),
        first_token=payload["first_token"], first_lp=payload["first_lp"],
        blocks=payload["blocks"], n_blocks=payload["n_blocks"],
        kv_dtype=payload["kv_dtype"])


# ------------------------------------------------------ block movers --

POOLS = {"bf16": (jnp.bfloat16, None), "int8": (jnp.float32, "int8"),
         "fp8_e4m3": (jnp.float32, "fp8_e4m3")}


def _jax_pool(jcfg, pool, nb=11, bs=8):
    """A JAX pool with random content in the given storage (and random
    positive scales when quantized)."""
    dtype, quant = POOLS[pool]
    cache = j_kv.init_paged_cache(jcfg, 2, 16, bs, nb, dtype=dtype,
                                  quant_kv=quant or "none")
    rng = np.random.default_rng(3)
    for key in ("k", "v"):
        x = rng.standard_normal(cache[key].shape).astype(np.float32)
        if quant == "int8":
            x = np.clip(np.round(x * 40), -127, 127)
        cache[key] = jnp.asarray(x).astype(cache[key].dtype)
        if quant:
            cache[key + "_scale"] = jnp.asarray(rng.uniform(
                0.01, 1.0, cache[key + "_scale"].shape).astype(np.float32))
    return cache


def _to_port(jcache):
    """The JAX cache's bytes as the port's pool (bf16 through uint16,
    fp8 through uint8)."""
    out = {}
    for key, val in jcache.items():
        arr = np.array(jax.device_get(val))          # a writable copy
        if arr.dtype == ml_dtypes.bfloat16:
            out[key] = torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16)
        elif arr.dtype == ml_dtypes.float8_e4m3fn:
            out[key] = torch.from_numpy(arr.view(np.uint8)).view(
                torch.float8_e4m3fn)
        else:
            out[key] = torch.from_numpy(arr)
    return out


def _bits(arr):
    arr = np.asarray(arr)
    if arr.dtype.itemsize == 2 and arr.dtype != np.int16:
        return arr.view(np.uint16)
    if arr.dtype == ml_dtypes.float8_e4m3fn:
        return arr.view(np.uint8)
    return arr


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_gather_payload_bit_equal_to_jax(tiny, pool):
    """The port's payload over the same pool bytes equals JAX's
    ``gather_kv_blocks`` bit for bit: same keys, layouts [L, n, bs, KV,
    D] / [L, n, KV], pow-2 padding dropped."""
    jcfg = tiny[0]
    jcache = _jax_pool(jcfg, pool)
    tcache = _to_port(jcache)
    ids = [7, 2, 9]                          # padded to 4 with block 0
    theirs = j_kv.gather_kv_blocks(jcache, ids)
    ours = t_kv.gather_kv_blocks(tcache, ids)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert isinstance(ours[key], np.ndarray)
        assert ours[key].shape == theirs[key].shape
        np.testing.assert_array_equal(ours[key], _bits(theirs[key]))
    want = {"bf16": np.uint16, "int8": np.int8, "fp8_e4m3": np.uint8}[pool]
    assert ours["k"].dtype == want
    assert t_kv.wire_dtype(tcache) == {"bf16": "bfloat16", "int8": "int8",
                                       "fp8_e4m3": "float8_e4m3fn"}[pool]


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_scatter_matches_jax_and_round_trips(tiny, pool):
    """Scatter a payload into other blocks, in place: the pool equals the
    JAX ``scatter_kv_blocks`` result bit for bit (a JAX payload scattered
    straight into the port's pool), and gathering those blocks back gives
    the payload."""
    jcfg = tiny[0]
    jcache = _jax_pool(jcfg, pool)
    tcache = _to_port(jcache)
    payload = j_kv.gather_kv_blocks(jcache, [1, 4, 6])
    dest = [10, 3, 5]
    ours = t_kv.scatter_kv_blocks(tcache, dest, payload)
    assert ours is tcache
    theirs = _to_port(j_kv.scatter_kv_blocks(
        {k: jnp.copy(v) for k, v in jcache.items()}, dest, payload))
    for key in theirs:
        if key == "len":
            continue
        raw = lambda t: t.view(torch.uint8) if t.element_size() == 1 \
            else t.view(torch.int16) if t.element_size() == 2 else t
        assert torch.equal(raw(ours[key])[:, 1:], raw(theirs[key])[:, 1:])
    back = t_kv.gather_kv_blocks(tcache, dest)
    for key in payload:
        np.testing.assert_array_equal(back[key], _bits(payload[key]))
    with pytest.raises(ValueError, match="does not fit"):
        t_kv.scatter_kv_blocks(tcache, [2, 3], back)


# ------------------------------------------------- engine-level hooks --

def test_hold_export_release_lifecycle(tiny, jax_greedy):
    eng = _eng(tiny)
    req = eng.add_request(PROMPT, SamplingParams(max_tokens=8),
                          hold_after_prefill=True)
    assert _step_until(eng, lambda: req.t_first_token > 0)
    # parked, not decoding: the slot left the active map but stays owned
    assert req in eng.held_requests() and not req.done
    assert not eng._active
    payload = eng.export_held_kv(req)
    n_expect = t_kv.blocks_for(len(PROMPT), eng.paged.block_size)
    assert payload["n_blocks"] == n_expect
    assert payload["blocks"]["k"].shape[1] == n_expect
    assert isinstance(payload["blocks"]["k"], np.ndarray)
    assert payload["prompt"] == PROMPT
    assert payload["kv_dtype"] == "float32"
    assert payload["first_token"] == jax_greedy(PROMPT, 1)[0]
    assert payload["t_enqueue"] == req.t_enqueue
    # the exported bytes are the held slot's prompt blocks
    ids = eng.paged.slot_blocks(req.slot)[:n_expect]
    np.testing.assert_array_equal(payload["blocks"]["k"],
                                  eng.cache["k"][:, ids].numpy())
    # ownership edge: release drops the held slot; a second export is None
    assert eng.release_held(req)
    assert req not in eng.held_requests()
    assert eng.export_held_kv(req) is None
    assert sorted(eng._free) == [0, 1, 2, 3]


def test_held_blocks_survive_other_streams_decoding(tiny, jax_greedy):
    """A held request's prompt blocks are not written while other streams
    decode beside it: decode and verify dispatches zero a held slot's
    table row, so its idle scatter lands in scratch. (The JAX engine keeps
    the row: from the second decode step its slot's position 0, in the
    held prompt's first block, takes the idle write.) The migrated stream
    still equals JAX's greedy stream."""
    eng = _eng(tiny, decode_pipeline=False)
    req = eng.add_request(PROMPT, SamplingParams(max_tokens=8),
                          hold_after_prefill=True)
    assert _step_until(eng, lambda: req.t_first_token > 0)
    before = eng.export_held_kv(req)["blocks"]
    other = eng.add_request([3, 4, 5], SamplingParams(max_tokens=20))
    for _ in range(4):
        eng.step()
    assert len(other.generated) > 2
    payload = eng.export_held_kv(req)
    for key in ("k", "v"):
        np.testing.assert_array_equal(payload["blocks"][key], before[key])
    eng.release_held(req)
    dec = _eng(tiny)
    inj = _inject(dec, payload)
    assert _step_until(dec, lambda: inj.done)
    assert inj.generated == jax_greedy(PROMPT, 8)


def test_abort_before_export_releases_prefill_side(tiny):
    """An abort while PREFILL_OWNED drains the held slot on the next
    step; export then refuses, and the freed slot readmits."""
    eng = _eng(tiny)
    req = eng.add_request(PROMPT, SamplingParams(max_tokens=8),
                          hold_after_prefill=True)
    assert _step_until(eng, lambda: req.t_first_token > 0)
    eng.abort([req])
    eng.step()
    assert req not in eng.held_requests()
    assert req.done and req.finish_reason == "abort"
    assert eng.export_held_kv(req) is None
    req2 = eng.add_request(PROMPT, SamplingParams(max_tokens=4))
    assert _step_until(eng, lambda: req2.done)
    assert eng.paged.reclaimable_blocks == eng.paged.num_blocks - 1


def test_inject_pins_blocks_against_eviction(tiny, jax_greedy):
    """Decode-side eviction pressure never reclaims a migrated request's
    blocks (inject refcounts them at reserve), and the stream decodes to
    the JAX engine's greedy stream."""
    payload = _held_payload(tiny, 8)
    dec = _eng(tiny)
    inj = _inject(dec, payload)
    assert inj is not None
    # the imported full prompt block is published to this pool's tree
    assert dec.paged.radix.match(PROMPT) == dec.paged.slot_blocks(
        inj.slot)[:1]
    ids = set(dec.paged.slot_blocks(inj.slot))
    assert all(dec.paged._ref.get(b, 0) >= 1 for b in ids)
    evicted = dec.paged.radix.evict_lru(10_000, dec.paged._ref)
    assert not (set(evicted) & ids)
    assert _step_until(dec, lambda: inj.done)
    assert inj.generated == jax_greedy(PROMPT, 8)


def test_inject_refuses_a_payload_of_another_pool(tiny):
    payload = _held_payload(tiny, 8)
    dec = _eng(tiny, quant=QuantConfig(kv_dtype="int8"))
    with pytest.raises(ValueError, match="KV dtype"):
        _inject(dec, payload)
    assert sorted(dec._free) == [0, 1, 2, 3]


# ------------------------------------------------- wire-level handoff --

@pytest.fixture(scope="module")
def tier_pair(tiny):
    """A model-backed prefill/decode replica pair joined by a live TCP
    KV listener: the in-process version of two tier replicas."""
    from kubeflow_tpu_torch.serving import LLMModel

    _, _, tcfg, tp = tiny

    def mk(tier):
        m = LLMModel(f"m-{tier}", tp, tcfg, max_batch=4, max_seq=64,
                     prefill_buckets=(8, 16), tier=tier, device="cpu")
        m.load()
        m.disagg = TierRuntime(m.engine, tier, model=m)
        return m, m.disagg

    mp, rp = mk("prefill")
    md, rd = mk("decode")
    rd.attach_receiver()
    yield rp, rd
    rd.receiver.close()
    mp.unload()
    md.unload()


def test_migration_end_to_end_matches_jax(tier_pair, jax_greedy):
    rp, rd = tier_pair
    out = rp.prefill_and_migrate(PROMPT, SamplingParams(max_tokens=8),
                                 rd.kv_addr, "e2e-1")
    assert out["status"] == "migrated", out
    assert out["migrated_blocks"] == 2
    assert out["timings"]["prefill_s"] > 0
    assert out["timings"]["export_s"] >= 0
    res = rd.collect("e2e-1")
    assert res["finish_reason"] == "length"
    assert res["tokens"] == jax_greedy(PROMPT, 8)
    assert res["timings"]["inject_to_first_commit_s"] > 0
    assert rp.stats.get("migrations_total") >= 1
    assert rp.stats.get("migrated_blocks_total") >= 2
    assert rp.stats.get("migration_failures_total") == 0
    assert rd.stats.get("handoffs_injected_total") >= 1
    assert not rp.engine.held_requests()


def test_duplicate_delivery_is_idempotent(tiny, tier_pair, jax_greedy):
    """The same kv frame delivered twice injects ONCE; the second
    delivery replays the stored ack."""
    _, rd = tier_pair
    payload = _held_payload(tiny, 6)
    injected0 = rd.stats.get("handoffs_injected_total")
    dup0 = rd.stats.get("duplicate_deliveries_total")
    mig = KVMigrator(MigrationStats())
    ok1, _ = mig.send(rd.kv_addr, "dup-1", payload)
    ok2, _ = mig.send(rd.kv_addr, "dup-1", payload)
    assert ok1 and ok2
    assert rd.stats.get("handoffs_injected_total") == injected0 + 1
    assert rd.stats.get("duplicate_deliveries_total") == dup0 + 1
    assert rd.collect("dup-1")["tokens"] == jax_greedy(PROMPT, 6)


def test_release_frame_drops_injected_handoff(tiny, tier_pair):
    """A release frame aborts the injected request, frees its blocks on
    the decode side, and collect then refuses the handoff."""
    _, rd = tier_pair
    payload = _held_payload(tiny, 48)
    eng = rd.engine
    mig = KVMigrator(MigrationStats())
    ok, _ = mig.send(rd.kv_addr, "rel-1", payload)
    assert ok
    rel0 = rd.stats.get("releases_total")
    assert mig.release(rd.kv_addr, "rel-1")
    deadline = time.monotonic() + 10
    while ((rd.stats.get("releases_total") == rel0 or eng._active)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert rd.stats.get("releases_total") == rel0 + 1
    assert "error" in rd.collect("rel-1", timeout_s=1.0)
    assert not eng._active and sorted(eng._free) == [0, 1, 2, 3]
    assert eng.paged.reclaimable_blocks == eng.paged.num_blocks - 1


def test_receiver_close_ends_its_accept_thread():
    """``close`` wakes the accept thread blocked in ``accept()`` (closing
    the socket alone leaves it blocked, and through the sink it would
    keep the decode engine and its weights alive): the thread ends and
    the port refuses connections."""
    rcv = t_disagg.KVReceiver(lambda hid, payload: (True, ""),
                              lambda hid: None)
    thread, addr = rcv._accept_thread, rcv.addr
    assert thread.is_alive()
    rcv.close()
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    with pytest.raises(OSError):
        socket.create_connection(addr, timeout=1.0).close()


def test_decode_death_falls_back_to_local_generation(tier_pair, jax_greedy):
    """Decode replica dead at send time: the prefill replica serves the
    request locally and counts the failure."""
    rp, _ = tier_pair
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()
    s.close()
    fail0 = rp.stats.get("migration_failures_total")
    out = rp.prefill_and_migrate(PROMPT, SamplingParams(max_tokens=8),
                                 dead, "dead-1")
    assert out["status"] == "fallback", out
    assert out["tokens"] == jax_greedy(PROMPT, 8)
    assert rp.stats.get("migration_failures_total") == fail0 + 1


def test_framing_bytes_equal_jax_encode():
    payload = {"prompt": [1, 2, 3], "first_lp": -0.5, "n_blocks": 2,
               "blocks": {"k": np.arange(24, dtype=np.uint16).reshape(
                   1, 2, 3, 4), "k_scale": np.ones((1, 2, 1), np.float32)}}
    for key in (("kv", "h-1"), ("release", "h-2"), ("ack", "h-3")):
        assert t_disagg._encode(key, payload) == j_encode(key, payload)
    assert t_disagg.PREFILL_SCALE_METRIC == "token_backlog"
    assert t_disagg.DECODE_SCALE_METRIC == "occupancy_slots"


# --------------------------------------------------------- HTTP routes --

def _post(url, body, timeout=120.0):
    req = urlrequest.Request(url, data=json.dumps(body).encode(),
                             headers={"Content-Type": "application/json"},
                             method="POST")
    try:
        with urlrequest.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urlrequest.HTTPError as e:
        return e.code, json.loads(e.read())


def test_disagg_routes_over_http(tiny, jax_greedy):
    """Two tier replicas built as the runtime builds them (KFT_TIER,
    KFT_KV_BIND) behind their own ModelServers: /disagg/prefill migrates
    to the decode replica's listener, /disagg/collect returns the JAX
    greedy stream, /disagg/probe reports the radix hit and the listener,
    /disagg/release of an unknown handoff is a no-op, /metrics carries
    tier="..." and the kft_disagg_* families; a co-located model answers
    400."""
    from kubeflow_tpu_torch.serving import (
        LLMModel, ModelRepository, ModelServer,
    )
    from kubeflow_tpu_torch.serving.runtime import attach_tier

    _, _, tcfg, tp = tiny
    servers, models = {}, {}
    for tier in ("prefill", "decode", ""):
        m = LLMModel(f"m-{tier or 'co'}", tp, tcfg, max_batch=2, max_seq=64,
                     prefill_buckets=(8, 16), tier=tier, device="cpu")
        repo = ModelRepository()
        repo.register(m)
        addr = attach_tier(m, {"KFT_TIER": tier,
                               "KFT_KV_BIND": "127.0.0.1:0"})
        assert (addr is not None) == (tier == "decode")
        servers[tier], models[tier] = ModelServer(repo).start(), m
    try:
        kv_addr = list(models["decode"].disagg.kv_addr)
        code, out = _post(f"{servers['prefill'].url}/v2/models/m-prefill/"
                          "disagg/prefill",
                          {"inputs": PROMPT, "decode_addr": kv_addr,
                           "handoff_id": "http-1",
                           "parameters": {"max_tokens": 8}})
        assert code == 200 and out["status"] == "migrated", out
        code, res = _post(f"{servers['decode'].url}/v2/models/m-decode/"
                          "disagg/collect", {"handoff_id": "http-1"})
        assert code == 200 and res["tokens"] == jax_greedy(PROMPT, 8)
        code, probe = _post(f"{servers['decode'].url}/v2/models/m-decode/"
                            "disagg/probe", {"inputs": PROMPT})
        assert code == 200 and probe["tier"] == "decode"
        assert probe["cached_blocks"] == 1 and probe["block_size"] == 8
        assert probe["kv_addr"] == kv_addr
        code, rel = _post(f"{servers['decode'].url}/v2/models/m-decode/"
                          "disagg/release", {"handoff_id": "nope"})
        assert code == 200 and rel == {"released": False}
        code, _ = _post(f"{servers['decode'].url}/v2/models/m-decode/"
                        "disagg/collect", {"handoff_id": "nope"})
        assert code == 409
        code, _ = _post(f"{servers[''].url}/v2/models/m-co/disagg/probe",
                        {"inputs": PROMPT})
        assert code == 400
        text = servers["decode"]._render_metrics()
        assert ('kft_disagg_handoffs_injected_total{model="m-decode",'
                'tier="decode"} 1.0') in text
        assert 'kft_model_sched_queue_depth{model="m-decode",tier="decode"}' \
            in text
        assert "kv_addr" not in text
        ptext = servers["prefill"]._render_metrics()
        assert ('kft_disagg_migrations_total{model="m-prefill",'
                'tier="prefill"} 1.0') in ptext
        assert ('kft_disagg_migration_failures_total'
                '{model="m-prefill",tier="prefill"}') not in ptext
        stats = models["decode"].stats()
        assert stats["tier"] == "decode"
        assert stats["disagg"]["kv_addr"] == kv_addr
    finally:
        for srv in servers.values():
            srv.stop()
        models["decode"].disagg.receiver.close()
        for m in models.values():
            m.unload()


# ----------------------------------------------------------------- on card --

@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["none", "int8"])
def test_cuda_decode_over_scattered_blocks_equals_local(kv):
    """On the card: a request prefilled on one engine, exported, and
    injected into another decodes through rows 1-2's kernels to the same
    tokens as the same request served on one engine: the kernels read
    migrated bytes as they read their own."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops import paged_attention as pa

    # llama_tiny at head_dim 64, the paged kernel's smallest
    cfg = dataclasses.replace(llama.llama_tiny(dtype=torch.float32),
                              dim=256, mlp_dim=512, max_seq=256)
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
    quant = QuantConfig(kv_dtype="int8") if kv == "int8" else None
    kw = dict(max_batch=2, max_seq=128, prefill_buckets=(16, 64),
              device="cuda", quant=quant)
    prompt = [(5 * i) % 200 + 3 for i in range(37)]
    [local] = LLMEngine(params, cfg, **kw).generate(
        [prompt], SamplingParams(max_tokens=24))
    src = LLMEngine(params, cfg, **kw)
    req = src.add_request(prompt, SamplingParams(max_tokens=24),
                          hold_after_prefill=True)
    assert _step_until(src, lambda: req.t_first_token > 0)
    payload = src.export_held_kv(req)
    src.release_held(req)
    dec = LLMEngine(params, cfg, **kw)
    kernel = (pa.paged_decode_attention_quant if kv == "int8"
              else pa.paged_decode_attention)
    kernel.launches = 0
    inj = _inject(dec, payload)
    assert _step_until(dec, lambda: inj.done)
    assert kernel.launches > 0
    assert inj.generated == local.generated

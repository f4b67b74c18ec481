"""Disaggregated prefill/decode serving over a serving mesh (``KFT_TIER``
beside ``KFT_MESH=tensor=N``): the payload's head slices gathered from
and scattered to ``tensor`` ranks (``paged_kv.payload_heads`` /
``join_heads``, the engine's ``_body_export`` / ``_body_inject``), the
tier pairs across layouts, the pool bookkeeping every rank replays, and
the runtime over HTTP, against the JAX package on the CPU, in float32,
on the same weights (``interop.params_from_jax``).

The JAX side runs as tests/test_torch_tp.py runs it: conftest's host
devices cut to the ``tensor`` axis (``build_mesh(MeshConfig(tensor=2),
devices[:2])``), its engines synchronous with kernel "pallas" in
interpret mode, and its pools sharded on their KV heads. The port's
ranks are processes that talk over gloo, rendezvousing under the test's
temporary directory. One launched mesh per process: the port's
``tensor=2`` engine plays both tiers of the mesh-to-mesh layout (its
own payload injected into its own pool), as two JAX engines on the same
devices do.

Tolerances, each with its reason:

- Payloads gathered from rank pools, and pools scattered to: BIT-EQUAL
  to the JAX package's on the same pool bytes sharded over ``tensor``
  (the same bytes moved; bf16 as uint16, fp8 as uint8), for every pool
  kind of ``test_torch_disagg.POOLS``; scatter then gather through the
  engine's ranks round-trips bitwise.
- Tier pairs: token for token against JAX's tier pair on the same
  layout; the held prompt's payload within 1e-5 of JAX's over the
  prompt's rows (two float32 programs summing in different orders; rows
  past the prompt in its last block are not written by either).
- Blocks in use: EQUAL on every rank to the one-card engine's after the
  same hold, release, abort and duplicate delivery (integer
  bookkeeping).
- The runtime over HTTP: streams equal to the co-located model's.
"""

import json
from urllib import request as urlrequest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kubeflow_tpu.models import hf_llama as j_hf
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.parallel.sharding import tree_shardings
from kubeflow_tpu.serving import paged_kv as j_kv
from kubeflow_tpu.serving.llm import LLMEngine as JEngine
from kubeflow_tpu.serving.llm import SamplingParams as JSampling
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.parallel import TensorMesh
from kubeflow_tpu_torch.serving import paged_kv as t_kv
from kubeflow_tpu_torch.serving.disagg import (
    KVMigrator, MigrationStats, TierRuntime,
)
from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams

from test_torch_disagg import POOLS, _bits, _jax_pool, _to_port
from test_torch_flash_attention import warm_up_cpu_exp

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

TP = 2
PROMPT = [5, 6, 7, 9, 10, 11, 12, 13, 3, 4, 2, 8]
KW = dict(max_batch=4, max_seq=64, prefill_buckets=(8, 16))


def _jmesh():
    return build_mesh(MeshConfig(tensor=TP), devices=jax.devices()[:TP])


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


def _rank_pools(tcache, n=TP):
    """The pools the ``tensor`` ranks of a mesh hold for ``tcache``'s
    contents: rank r's KV-head slice, a tensor of its own."""
    pools = []
    for r in range(n):
        pool = {}
        for key, t in tcache.items():
            if key == "len":
                continue
            axis = 3 if t.dim() == 5 else 2
            kv = t.shape[axis] // n
            pool[key] = t.narrow(axis, r * kv, kv).contiguous()
        pools.append(pool)
    return pools


def _raw(t):
    """A pool's bytes as integers (bf16 as int16, fp8 as uint8)."""
    return (t.view(torch.uint8) if t.element_size() == 1
            else t.view(torch.int16) if t.element_size() == 2 else t)


def _sharded(jcache):
    """The JAX pool placed as its engine places it under a tensor mesh:
    pools and scales cut on their KV heads."""
    mesh = _jmesh()
    out = {}
    for key, val in jcache.items():
        spec = (P(None, None, None, "tensor", None) if val.ndim == 5
                else P(None, None, "tensor") if val.ndim == 3 else P())
        out[key] = jax.device_put(val, NamedSharding(mesh, spec))
    return out, list(mesh.devices.flat)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_rank_gathers_join_to_jax_payload_bit_for_bit(tiny, pool):
    """(a) The same pool contents, gathered from the ``tensor=2`` ranks'
    head slices and joined in tensor order, give JAX's
    ``gather_kv_blocks`` of that pool sharded over ``tensor=2`` bit for
    bit."""
    jcache, _ = _sharded(_jax_pool(tiny[0], pool))
    ids = [7, 2, 9]
    theirs = j_kv.gather_kv_blocks(jcache, ids)
    parts = [t_kv.gather_kv_blocks(p, ids)
             for p in _rank_pools(_to_port(_jax_pool(tiny[0], pool)))]
    assert [p["k"].shape[3] for p in parts] == [1, 1]
    ours = t_kv.join_heads(parts)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].shape == theirs[key].shape
        np.testing.assert_array_equal(ours[key], _bits(theirs[key]))


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_rank_scatters_round_trip_bitwise(tiny, pool):
    """(b) A full-head payload scattered to each rank's pool (the rank's
    heads of it, ``payload_heads``) leaves each rank's pool equal to the
    shard of JAX's scattered pool on that rank's device, bit for bit, and
    gathering the blocks back from every rank gives the payload."""
    jcfg = tiny[0]
    payload = j_kv.gather_kv_blocks(_jax_pool(jcfg, pool), [1, 4, 6])
    dest = [10, 3, 5]
    jcache, devs = _sharded(_jax_pool(jcfg, pool))
    theirs = j_kv.scatter_kv_blocks(jcache, dest, payload)
    pools = _rank_pools(_to_port(_jax_pool(jcfg, pool)))
    for r, rank_pool in enumerate(pools):
        t_kv.scatter_kv_blocks(rank_pool, dest,
                               t_kv.payload_heads(payload, r, TP))
        for key, arr in theirs.items():
            if key == "len":
                continue
            shard = np.asarray(next(s.data for s in arr.addressable_shards
                                    if s.device == devs[r]))
            mine = _to_port({key: shard})[key]
            assert torch.equal(_raw(rank_pool[key])[:, 1:],
                               _raw(mine)[:, 1:]), (r, key)
    back = t_kv.join_heads([t_kv.gather_kv_blocks(p, dest) for p in pools])
    for key in payload:
        np.testing.assert_array_equal(back[key], _bits(payload[key]))


# ---------------------------------------------------------- over HTTP --

def _post(url, body, timeout=120.0):
    req = urlrequest.Request(url, data=json.dumps(body).encode(),
                             headers={"Content-Type": "application/json"},
                             method="POST")
    with urlrequest.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_runtime_mesh_prefill_tier_migrates_over_http(tmp_path):
    """(f) ``KFT_MESH=tensor=2`` with ``KFT_TIER=prefill`` (two CPU ranks)
    builds through the runtime and migrates through ``/disagg/prefill``
    to a one-card decode tier built the same way; the collected streams
    equal a co-located one-card model's."""
    from kubeflow_tpu_torch.serving import ModelRepository, ModelServer
    from kubeflow_tpu_torch.serving.runtime import (
        attach_tier, build_model_from_env,
    )

    jcfg = jl.llama_tiny(dtype=jnp.float32)
    model_dir = str(tmp_path / "ckpt")
    j_hf.save_pretrained(model_dir, jcfg,
                         jl.init_params(jax.random.key(3), jcfg))
    base = {"KFT_MODEL_NAME": "tiny", "KFT_MODEL_DIR": model_dir,
            "KFT_DTYPE": "float32", "KFT_MAX_BATCH": "2",
            "KFT_MAX_SEQ": "64", "KFT_FORCE_PLATFORM": "cpu",
            "KFT_KV_BIND": "127.0.0.1:0"}
    envs = {"prefill": dict(base, KFT_TIER="prefill", KFT_MESH="tensor=2"),
            "decode": dict(base, KFT_TIER="decode"), "co": base}
    models, servers = {}, {}
    try:
        for name, env in envs.items():
            m = build_model_from_env(env)
            repo = ModelRepository()
            repo.register(m)
            attach_tier(m, env)
            models[name], servers[name] = m, ModelServer(repo).start()
        assert models["prefill"].mesh.tp == TP
        assert models["prefill"].tier == "prefill"
        kv_addr = list(models["decode"].disagg.kv_addr)
        prompts = [PROMPT, [9, 3, 1, 2, 7, 7, 4, 8, 2, 1, 6, 5, 3, 2, 9, 1,
                            4, 4, 2, 3]]
        for i, prompt in enumerate(prompts):
            code, out = _post(f"{servers['prefill'].url}/v2/models/tiny/"
                              "disagg/prefill",
                              {"inputs": prompt, "decode_addr": kv_addr,
                               "handoff_id": f"h-{i}",
                               "parameters": {"max_tokens": 6}})
            assert code == 200 and out["status"] == "migrated", out
            _, res = _post(f"{servers['decode'].url}/v2/models/tiny/"
                           "disagg/collect", {"handoff_id": f"h-{i}"})
            _, co = _post(f"{servers['co'].url}/v2/models/tiny/infer", {
                "inputs": [{"name": "ids", "shape": [1, len(prompt)],
                            "datatype": "INT32", "data": prompt}],
                "parameters": {"max_tokens": 6}})
            want = {t["name"]: t for t in co["outputs"]}["tokens"]["data"]
            assert res["tokens"] == want[:6]
        ranks = models["prefill"].engine.tp_status()
        assert [r["blocks_in_use"] for r in ranks] == [0, 0]
        assert len({(r["samples"], r["token_digest"]) for r in ranks}) == 1
    finally:
        for srv in servers.values():
            srv.stop()
        if "decode" in models:
            models["decode"].disagg.receiver.close()
        for m in models.values():
            m.unload()


# ------------------------------------------------------ the tier pairs --

@pytest.fixture(scope="module")
def engines(tiny, tmp_path_factory):
    """The port's ``tensor=2`` engine (two gloo ranks) and one-card
    engine, and JAX's tier engines: two one-device engines and two on the
    ``tensor=2`` mesh."""
    jcfg, jp, tcfg, tp = tiny
    mesh = TensorMesh(TP, ["cpu"] * TP, timeout_s=120.0,
                      rendezvous_dir=str(tmp_path_factory.mktemp("rdv")))
    ours = {"mesh": LLMEngine(tp, tcfg, mesh=mesh, **KW),
            "one": LLMEngine(tp, tcfg, device="cpu", **KW)}
    jm = _jmesh()
    placed = jax.device_put(jp, tree_shardings(
        jm, jl.param_logical_axes(jcfg)))
    jkw = dict(KW, kernel="pallas", decode_pipeline=False)
    theirs = {"mesh": [JEngine(placed, jcfg, mesh=jm, **jkw)
                       for _ in range(2)],
              "one": [JEngine(jp, jcfg, **jkw) for _ in range(2)]}
    yield ours, theirs
    ours["mesh"].close()


def _drain(eng, pred=lambda: False, max_steps=300):
    for _ in range(max_steps):
        if pred() or not eng.has_work():
            break
        eng.step()


def _hold(eng, prompt, sampling):
    req = eng.add_request(prompt, sampling, hold_after_prefill=True)
    _drain(eng, lambda: req.t_first_token > 0)
    assert req in eng.held_requests()
    return req


def _inject(eng, payload, sampling_cls):
    sd = dict(payload["sampling"])
    sd["stop_token_ids"] = tuple(sd["stop_token_ids"])
    return eng.inject_request(
        payload["prompt"], sampling_cls(**sd),
        first_token=payload["first_token"], first_lp=payload["first_lp"],
        blocks=payload["blocks"], n_blocks=payload["n_blocks"])


def _prompt_rows(blocks, n):
    """A payload's pools over the prompt's ``n`` rows: [L, n, ...]."""
    return {k: v.reshape(v.shape[0], -1, *v.shape[3:])[:, :n]
            for k, v in blocks.items() if v.ndim == 5}


@pytest.mark.parametrize("layout", ["mesh->mesh", "mesh->one", "one->mesh"])
def test_tier_pairs_match_jax_tier_pairs(engines, layout):
    """(c) llama_tiny: a prompt held on the prefill tier, exported,
    released and injected into the decode tier, on the port and on JAX
    with the same layout: streams token for token, payloads within 1e-5
    over the prompt's rows. Injected into the mesh, the blocks gathered
    back from its ranks (before any decode step writes the last block)
    are the payload's, bit for bit."""
    ours, theirs = engines
    src, dst = layout.split("->")
    prompt = PROMPT if src == "mesh" else PROMPT[:7] + [1, 1, 2, 3]

    pre = _hold(ours[src], prompt, SamplingParams(max_tokens=8))
    payload = ours[src].export_held_kv(pre)
    assert ours[src].release_held(pre)
    jsrc, jdst = theirs[src][0], theirs[dst][1]
    jpre = _hold(jsrc, prompt, JSampling(max_tokens=8))
    jpay = jsrc.export_held_kv(jpre)
    assert jsrc.release_held(jpre)

    assert payload["n_blocks"] == jpay["n_blocks"]
    assert payload["first_token"] == jpay["first_token"]
    assert payload["blocks"]["k"].shape == jpay["blocks"]["k"].shape
    assert payload["blocks"]["k"].shape[3] == ours["one"].cfg.n_kv_heads
    mine, want = (_prompt_rows(p["blocks"], len(prompt))
                  for p in (payload, jpay))
    for key in want:
        np.testing.assert_allclose(mine[key], np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)

    inj = _inject(ours[dst], payload, SamplingParams)
    assert inj is not None
    if dst == "mesh":
        ids = ours[dst].paged.slot_blocks(inj.slot)[:payload["n_blocks"]]
        back = t_kv.join_heads([p for p in ours[dst]._run(
            "export", answers=True, ids=np.asarray(ids)) if p is not None])
        for key, arr in payload["blocks"].items():
            np.testing.assert_array_equal(back[key], arr)
    _drain(ours[dst], lambda: inj.done)
    jinj = _inject(jdst, jpay, JSampling)
    _drain(jdst, lambda: jinj.done)
    assert inj.done and inj.generated == jinj.generated
    assert len(inj.generated) == 8


def test_every_ranks_blocks_follow_one_card(engines):
    """(e) Hold, release; hold, abort before export; a duplicate kv frame
    and a release frame: after each, every rank's blocks in use (its own
    bookkeeping, read through ``status()``) equal the one-card engine's,
    and end at zero; each rank stands at its expert and tensor index."""
    ours, _ = engines
    mesh, one = ours["mesh"], ours["one"]

    def same(want_zero=False):
        ranks = mesh.tp_status()
        n = one.paged.blocks_in_use
        assert [r["blocks_in_use"] for r in ranks] == [n] * TP
        assert ({r["reclaimable_blocks"] for r in ranks}
                == {one.paged.reclaimable_blocks})
        if want_zero:
            assert n == 0
        return ranks, n

    sampling = SamplingParams(max_tokens=8)
    held = [_hold(e, PROMPT, sampling) for e in (mesh, one)]
    ranks, n = same()
    assert n == 3
    assert [(r["expert_index"], r["tensor_index"]) for r in ranks] == \
        [(0, 0), (0, 1)]
    for e, req in zip((mesh, one), held):
        assert e.export_held_kv(req) is not None and e.release_held(req)
    same(want_zero=True)
    held = [_hold(e, PROMPT, sampling) for e in (mesh, one)]
    for e, req in zip((mesh, one), held):
        e.abort([req])
        e.step()
        assert req.done and e.export_held_kv(req) is None
    same(want_zero=True)

    payload = _held_payload(one, SamplingParams(max_tokens=40))
    rts = [TierRuntime(e, "decode") for e in (mesh, one)]
    mig = KVMigrator(MigrationStats())
    try:
        for rt in rts:
            rt.attach_receiver()
            ok = [mig.send(rt.kv_addr, "dup-1", payload)[0]
                  for _ in range(2)]
            assert all(ok)
            assert rt.stats.get("handoffs_injected_total") == 1
            assert rt.stats.get("duplicate_deliveries_total") == 1
        same()
        for rt in rts:
            assert mig.release(rt.kv_addr, "dup-1")
            rt.engine.step()
            _drain(rt.engine)
            assert rt.stats.get("releases_total") == 1
        same(want_zero=True)
    finally:
        for rt in rts:
            rt.receiver.close()


def _held_payload(eng, sampling):
    req = _hold(eng, PROMPT, sampling)
    payload = eng.export_held_kv(req)
    assert eng.release_held(req)
    return payload

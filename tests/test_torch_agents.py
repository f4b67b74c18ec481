"""The port's agent roles (``serving/agents.py``: request batcher,
payload logger, model puller) on the CPU: tests/test_serving_agents.py's
six cases on the port's classes, the payload logger's records against
the JAX logger's field for field, and the puller hot-loading two port
``LLMModel``s from one checkpoint the JAX package wrote, one with an
int8 KV pool from its descriptor's ``env``, whose greedy tokens in f32
equal the JAX ``LLMModel``'s on the same checkpoint and env, token for
token.
"""

import dataclasses
import gc
import json
import os
import threading
import weakref

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import hf_llama as j_hf
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serving.agents import LoggingModel as JLoggingModel
from kubeflow_tpu.serving.model import Model as JModel
from kubeflow_tpu.serving.protocol import InferRequest as JRequest
from kubeflow_tpu.serving.protocol import InferResponse as JResponse
from kubeflow_tpu.serving.runtime import build_model_from_env as j_build
from kubeflow_tpu_torch.serving import (
    InferRequest, InferResponse, InferTensor, Model, ModelRepository,
)
from kubeflow_tpu_torch.serving.agents import (
    BatchingModel, LoggingModel, ModelPuller,
)
from kubeflow_tpu_torch.serving.runtime import puller_factory


class Scaler(Model):
    """y = 3x; records the batch sizes it actually saw."""

    def __init__(self, name="scale"):
        super().__init__(name)
        self.seen_batches = []

    def predict(self, request):
        x = request.as_numpy()
        self.seen_batches.append(x.shape[0])
        return InferResponse.from_numpy(self.name, {"output-0": x * 3.0},
                                        id=request.id)


class JScaler(JModel):
    def predict(self, request):
        return JResponse.from_numpy(self.name,
                                    {"output-0": request.as_numpy() * 3.0},
                                    id=request.id)


def _req(vals, rid=None):
    return InferRequest(model_name="scale", id=rid, inputs=[
        InferTensor.from_numpy("x", np.asarray(vals, np.float32))])


def test_batcher_coalesces_concurrent_requests():
    inner = Scaler()
    batched = BatchingModel(inner, max_batch_size=8, max_latency_ms=50.0)
    batched.load()
    results = {}

    def call(i):
        out = batched(_req([[float(i)]], rid=str(i)))
        results[i] = float(out.as_numpy()[0, 0])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert results == {i: 3.0 * i for i in range(8)}
    # coalescing happened: fewer inner calls than outer requests
    assert len(inner.seen_batches) < 8 and batched.batches < 8
    assert sum(inner.seen_batches) == 8
    batched.unload()


def test_batcher_propagates_inner_errors():
    class Boom(Model):
        def predict(self, request):
            raise RuntimeError("boom")

    batched = BatchingModel(Boom("b"), max_latency_ms=1.0)
    batched.load()
    with pytest.raises(RuntimeError, match="boom"):
        batched(_req([[1.0]]))
    batched.unload()


def test_batcher_reload_after_unload():
    """The repository exposes hot load/unload: a batcher survives the
    unload->load cycle (fresh worker thread) and keeps serving."""
    batched = BatchingModel(Scaler(), max_latency_ms=1.0)
    batched.load()
    assert float(batched(_req([[1.0]])).as_numpy()[0, 0]) == 3.0
    batched.unload()
    batched.load()
    assert float(batched(_req([[2.0]])).as_numpy()[0, 0]) == 6.0
    batched.unload()


def test_payload_logger_writes_jsonl(tmp_path):
    sink = str(tmp_path / "payloads.jsonl")
    logged = LoggingModel(Scaler(), sink)
    logged.load()
    logged(_req([[2.0]], rid="r-7"))
    logged(_req([[4.0]], rid="r-8"))
    logged.flush()
    with open(sink) as f:
        recs = [json.loads(line) for line in f]
    assert [r["id"] for r in recs] == ["r-7", "r-8"]
    assert np.asarray(recs[0]["request"]["inputs"][0]["data"]
                      ).flatten().tolist() == [2.0]
    assert np.asarray(recs[0]["response"]["outputs"][0]["data"]
                      ).flatten().tolist() == [6.0]
    logged.unload()


@pytest.mark.parametrize("mode", ["all", "request", "response"])
def test_payload_logger_records_match_jax(tmp_path, mode):
    """The same requests through the JAX logger and the port's: the same
    records, field for field, but the clock's (ts, latency_ms)."""
    sinks = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "port")}
    ours = LoggingModel(Scaler("scale"), sinks["port"], mode=mode)
    theirs = JLoggingModel(JScaler("scale"), sinks["jax"], mode=mode)
    for m in (ours, theirs):
        m.load()
    for i, vals in enumerate(([[1.0, 2.0]], [[0.5], [-3.0]])):
        req = _req(vals, rid=f"r-{i}")
        ours(req)
        theirs(JRequest.from_dict("scale", req.to_dict()))
    recs = {}
    for k, m in (("port", ours), ("jax", theirs)):
        m.flush()
        m.unload()
        with open(sinks[k]) as f:
            recs[k] = [json.loads(line) for line in f]

    def strip(rec):
        rec = {k: v for k, v in rec.items() if k not in ("ts", "latency_ms")}
        if "response" in rec:
            rec["response"].get("parameters", {}).pop("latency_ms", None)
        return rec

    assert len(recs["port"]) == 2
    assert [strip(r) for r in recs["port"]] == \
        [strip(r) for r in recs["jax"]]


def test_mounted_bucket_storage(tmp_path, monkeypatch):
    """gs:// resolves through the FUSE mounted-bucket convention (no cloud
    SDK in the image); unmounted buckets fail with an actionable error."""
    from kubeflow_tpu_torch.serving.storage import download

    root = tmp_path / "gcs-mounts"
    (root / "my-bucket" / "models" / "llm").mkdir(parents=True)
    (root / "my-bucket" / "models" / "llm" / "weights.bin").write_text("w")
    monkeypatch.setenv("KFT_BUCKET_MOUNT_ROOT", str(root))

    out = download("gs://my-bucket/models/llm", str(tmp_path / "dest"))
    assert out == str(root / "my-bucket" / "models" / "llm")
    with pytest.raises(RuntimeError, match="not mounted"):
        download("gs://other-bucket/x", str(tmp_path / "dest2"))
    # tenant-supplied uri must never traverse out of the mount root
    (tmp_path / "secret.txt").write_text("s")
    with pytest.raises(ValueError, match="escapes"):
        download("gs://../secret.txt", str(tmp_path / "dest3"))
    with pytest.raises(ValueError, match="escapes"):
        download("gs://my-bucket/../../secret.txt", str(tmp_path / "dest4"))


def test_model_puller_syncs_config_dir(tmp_path):
    cfg_dir = str(tmp_path / "models-config")
    os.makedirs(cfg_dir)
    repo = ModelRepository()
    pulls = []

    def factory(desc, local):
        pulls.append((desc["name"], local))
        return Scaler(desc["name"])

    def fake_download(uri, dest):
        # the puller role: artifacts land locally before load
        os.makedirs(dest, exist_ok=True)
        with open(os.path.join(dest, "weights.bin"), "w") as f:
            f.write(uri)
        return dest

    puller = ModelPuller(repo, cfg_dir, factory, download=fake_download)
    assert puller.sync() == {"loaded": [], "unloaded": [], "errors": {}}

    with open(os.path.join(cfg_dir, "m1.json"), "w") as f:
        json.dump({"name": "m1", "storage_uri": "file:///fake"}, f)
    out = puller.sync()
    assert out["loaded"] == ["m1"]
    assert repo.get("m1").ready
    assert os.path.exists(os.path.join(pulls[0][1], "weights.bin"))
    assert puller.sync()["loaded"] == []                     # idempotent

    os.remove(os.path.join(cfg_dir, "m1.json"))
    assert puller.sync()["unloaded"] == ["m1"]
    assert "m1" not in repo.names()


def test_model_puller_isolates_and_remembers_bad_descriptors(tmp_path):
    """A descriptor whose factory fails does not stop the others of the
    pass, is not retried while unchanged, and is retried once edited."""
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    calls = []

    def factory(desc, local):
        calls.append(desc["name"])
        if desc.get("bad"):
            raise ValueError("broken checkpoint")
        return Scaler(desc["name"])

    repo = ModelRepository()
    puller = ModelPuller(repo, str(cfg_dir), factory,
                         model_dir=str(tmp_path / "models"))
    (cfg_dir / "a.json").write_text(json.dumps({"name": "a", "bad": 1}))
    (cfg_dir / "b.json").write_text(json.dumps({"name": "b"}))
    out = puller.sync()
    assert out["loaded"] == ["b"] and "broken" in out["errors"]["a"]
    assert puller.sync() == {"loaded": [], "unloaded": [], "errors": {}}
    assert calls == ["a", "b"]
    (cfg_dir / "a.json").write_text(json.dumps({"name": "a"}))
    assert puller.sync()["loaded"] == ["a"]
    assert repo.names() == ["a", "b"]


def test_model_puller_watch_thread_hot_loads(tmp_path):
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    repo = ModelRepository()
    puller = ModelPuller(repo, str(cfg_dir), lambda d, p: Scaler(d["name"]),
                         model_dir=str(tmp_path / "models"))
    stop = threading.Event()
    t = puller.watch(period=0.02, stop=stop)
    try:
        (cfg_dir / "w.json").write_text(json.dumps({"name": "w"}))
        for _ in range(500):
            if "w" in repo.names() and repo.get("w").ready:
                break
            stop.wait(0.01)
        assert repo.get("w").ready
        (cfg_dir / "w.json").unlink()
        for _ in range(500):
            if "w" not in repo.names():
                break
            stop.wait(0.01)
        assert repo.names() == []
    finally:
        stop.set()
        t.join(timeout=5)
    assert t.daemon and not t.is_alive()


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """An HF-layout llama_tiny checkpoint in f32 that the JAX package's
    save_pretrained wrote (no tokenizer: requests carry token ids)."""
    cfg = dataclasses.replace(jl.llama_tiny(dtype=jax.numpy.float32),
                              vocab_size=512)
    params = jl.init_params(jax.random.key(0), cfg)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    j_hf.save_pretrained(path, cfg, params)
    return path


ENV = {"KFT_FORCE_PLATFORM": "cpu", "KFT_DTYPE": "float32",
       "KFT_MAX_BATCH": "2", "KFT_MAX_SEQ": "64"}
PROMPTS = [[5, 17, 33, 2, 9], [101, 7, 7, 250, 3, 44, 12]]


def _ids_request(name):
    ids = np.zeros((len(PROMPTS), max(map(len, PROMPTS))), np.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, :len(p)] = p
    return InferRequest(name, [InferTensor.from_numpy("ids", ids)],
                        parameters={"max_tokens": 6})


def test_puller_hot_loads_llms_with_per_model_env(tmp_path, jax_checkpoint):
    """Two descriptors over one JAX-written checkpoint, the second with
    {"KFT_QUANT_KV": "int8"} in its env: the runtime's factory builds
    both (on the CPU, as the env asks), each serves the tokens the JAX
    runtime's model serves from the same files and env, and the unloaded
    one is gone from the repository and from memory."""
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    uri = f"file://{jax_checkpoint}"
    descs = {"alpha": {"name": "alpha", "storage_uri": uri},
             "beta": {"name": "beta", "storage_uri": uri,
                      "env": {"KFT_QUANT_KV": "int8"}}}
    for name, desc in descs.items():
        (cfg_dir / f"{name}.json").write_text(json.dumps(desc))
    env = {**ENV, "KFT_MODEL_DIR": str(tmp_path / "models")}
    repo = ModelRepository()
    puller = ModelPuller(repo, str(cfg_dir), puller_factory(env),
                         model_dir=env["KFT_MODEL_DIR"])
    assert puller.sync()["loaded"] == ["alpha", "beta"]
    try:
        pools = {n: repo.get(n).engine.cache["k"].dtype for n in descs}
        assert pools == {"alpha": torch.float32, "beta": torch.int8}
        for name, desc in descs.items():
            got = repo.get(name)(_ids_request(name))
            jmodel = j_build({**env, "KFT_MODEL_NAME": name,
                              "KFT_MODEL_DIR": jax_checkpoint,
                              **desc.get("env", {})})
            jmodel.load()
            try:
                want = jmodel.predict(JRequest.from_dict(
                    name, _ids_request(name).to_dict()))
            finally:
                jmodel.unload()
            np.testing.assert_array_equal(got.as_numpy("tokens"),
                                          want.as_numpy("tokens"))
            np.testing.assert_array_equal(got.as_numpy("lengths"), [6, 6])
        gone = weakref.ref(repo.get("beta"))
        (cfg_dir / "beta.json").unlink()
        assert puller.sync()["unloaded"] == ["beta"]
        assert repo.names() == ["alpha"]
        gc.collect()
        assert gone() is None
    finally:
        for name in repo.names():
            repo.unload(name)

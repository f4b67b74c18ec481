"""The port's multi-model runtime on the CPU: ``python -m
kubeflow_tpu_torch.serving.runtime`` as a subprocess under
``KFT_FORCE_PLATFORM=cpu`` with ``KFT_MODELS_CONFIG_DIR`` and
``KFT_V2_SOCKET_BIND`` hot-loads a model from a descriptor written while
it runs, serves it over HTTP V2 and the V2 socket with the greedy f32
tokens of the JAX runtime's model on the same checkpoint, and unloads it
when the descriptor goes (the test holds itself to 120 s and kills the
process in any case). Also: the port's ``save_pretrained`` writes
checkpoints that the JAX package's loader reads back bit for bit, and a
graph capture's launch record is its own stream's.
"""

import dataclasses
import json
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import hf_llama as j_hf
from kubeflow_tpu.serving.protocol import InferRequest as JRequest
from kubeflow_tpu.serving.protocol import InferTensor as JTensor
from kubeflow_tpu.serving.runtime import build_model_from_env as j_build
from kubeflow_tpu_torch import cuda_graph
from kubeflow_tpu_torch.models import hf_llama, llama
from kubeflow_tpu_torch.serving import (
    InferenceClient, InferRequest, InferTensor, V2SocketClient,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120.0
PROMPTS = [[5, 17, 33, 2, 9], [101, 7, 7, 250, 3, 44, 12]]


def _tree(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


CASES = {
    "tied f32": dict(),
    "tied bf16": dict(dtype=torch.bfloat16),
    "untied llama3 rope f32": dict(tie_embeddings=False,
                                   rope_scaling="llama3"),
    "moe f32": dict(n_experts=4, moe_top_k=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_pretrained_reads_back_in_jax_bit_for_bit(tmp_path, case):
    kw = dict(CASES[case])
    dtype = kw.pop("dtype", torch.float32)
    cfg = dataclasses.replace(llama.llama_tiny(dtype=dtype), **kw)
    params = llama.init_params(torch.Generator().manual_seed(1), cfg,
                               device="cpu", dtype=dtype)
    hf_llama.save_pretrained(str(tmp_path), cfg, params)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jcfg, jparams = j_hf.load_params(str(tmp_path), dtype=jdtype)
    assert (jcfg.n_layers, jcfg.dim, jcfg.tie_embeddings, jcfg.n_experts,
            jcfg.rope_scaling) == (cfg.n_layers, cfg.dim, cfg.tie_embeddings,
                                   cfg.n_experts, cfg.rope_scaling)
    want = dict(_tree(params))
    got = dict(_tree(jax.device_get(jparams)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
    # and the port's own reader takes it back as the same tree
    _, back = hf_llama.load_pretrained(str(tmp_path), dtype=dtype,
                                       device="cpu")
    for k, v in _tree(back):
        assert torch.equal(v, want[k]), k


def test_capture_launch_record_is_the_capturing_streams():
    """While a graph is captured on a stream, a launch on that stream from
    any thread (autograd runs a backward on its own thread) goes to the
    capture's record; a launch on another stream (another engine
    replaying meanwhile) still counts."""
    def wrapper():
        pass

    wrapper.launches = 0
    capturing, other = 7, 0
    cuda_graph._records[capturing] = record = {}
    try:
        cuda_graph.count_launch(wrapper, capturing)
        worker = threading.Thread(target=cuda_graph.count_launch,
                                  args=(wrapper, capturing))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
        cuda_graph.count_launch(wrapper, other)
    finally:
        del cuda_graph._records[capturing]
    assert record == {"wrapper": 2} and wrapper.launches == 1
    cuda_graph.count_launch(wrapper, capturing)
    assert wrapper.launches == 2


def _ids_request(name, cls=InferRequest, tensor=InferTensor):
    ids = np.zeros((len(PROMPTS), max(map(len, PROMPTS))), np.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, :len(p)] = p
    return cls(name, [tensor.from_numpy("ids", ids)],
               parameters={"max_tokens": 6})


def _until(deadline, what, pred, period=0.05):
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(period)
    raise AssertionError(f"timed out waiting for {what}")


def _ready(client, name) -> bool:
    try:
        return client.model_ready(name)
    except RuntimeError:               # [404]: not registered (yet)
        return False


def _missing(client, name) -> bool:
    try:
        client.model_ready(name)
    except RuntimeError as e:
        return "[404]" in str(e)
    return False


def test_runtime_subprocess_hot_loads_serves_both_planes_and_unloads(
        tmp_path):
    deadline = time.monotonic() + DEADLINE_S
    cfg = dataclasses.replace(llama.llama_tiny(dtype=torch.float32),
                              vocab_size=512)
    ckpt = str(tmp_path / "ckpt")
    hf_llama.save_pretrained(ckpt, cfg, llama.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    cfg_dir = tmp_path / "models-config"
    cfg_dir.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(KFT_FORCE_PLATFORM="cpu", KFT_DTYPE="float32",
               KFT_MAX_BATCH="2", KFT_MAX_SEQ="64",
               KFT_MODELS_CONFIG_DIR=str(cfg_dir),
               KFT_MODEL_DIR=str(tmp_path / "models"),
               KFT_MODELS_SYNC_PERIOD="0.2", KFT_BIND="127.0.0.1:0",
               KFT_V2_SOCKET_BIND="127.0.0.1:0", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.runtime"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x)
                                              for x in proc.stdout],
                              daemon=True)
    reader.start()
    seen = []
    try:
        addr = url = None
        while addr is None:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            seen.append(line)
            if line.startswith("serving "):
                assert line.startswith("serving [] at ")   # starts empty
                url = line.split(" at ")[-1].strip()
            elif line.startswith("v2-socket at "):
                host, _, port = line.split()[-1].rpartition(":")
                addr = (host, int(port))
        assert url is not None and any(
            x.startswith("model-puller watching") for x in seen)
        sock = V2SocketClient(addr)
        http = InferenceClient(url)
        try:
            assert sock.server_live() and sock.server_ready()
            (cfg_dir / "m.json").write_text(json.dumps(
                {"name": "m", "storage_uri": f"file://{ckpt}"}))
            _until(deadline, "the hot load", lambda: _ready(sock, "m"))
            over_http = http.infer(_ids_request("m"))
            over_sock = sock.infer(_ids_request("m"))
            jmodel = j_build({"KFT_MODEL_NAME": "m", "KFT_MODEL_DIR": ckpt,
                              "KFT_DTYPE": "float32", "KFT_MAX_BATCH": "2",
                              "KFT_MAX_SEQ": "64"})
            jmodel.load()
            try:
                want = jmodel.predict(_ids_request("m", JRequest, JTensor))
            finally:
                jmodel.unload()
            for out in (over_http, over_sock):
                np.testing.assert_array_equal(out.as_numpy("tokens"),
                                              want.as_numpy("tokens"))
                np.testing.assert_array_equal(out.as_numpy("lengths"),
                                              [6, 6])
            (cfg_dir / "m.json").unlink()
            _until(deadline, "the unload", lambda: _missing(sock, "m"))
            with pytest.raises(urllib.error.HTTPError) as e:
                http.infer(_ids_request("m"))
            assert e.value.code == 404
        finally:
            sock.close()
        assert proc.poll() is None, "".join(seen)
    finally:
        proc.kill()
        proc.wait(timeout=30)
        reader.join(timeout=5)

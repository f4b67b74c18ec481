"""Predictor runtime entrypoint of the PyTorch port — env contract ->
storage init -> server (counterpart of ``kubeflow_tpu.serving.runtime``).

``python -m kubeflow_tpu_torch.serving.runtime`` builds the models the env
describes and serves V1+V2 HTTP (and the V2 socket when asked);
``--init-only`` runs the storage-initializer step and exits. ``start(env)``
does what the module does, in process, and returns what it started
(``Runtime``, whose ``stop()`` ends it). The env contract is the JAX
runtime's:

  KFT_MODEL_NAME    served name              (default "model")
  KFT_MODEL_FORMAT  "llama"                  (default "llama")
  KFT_STORAGE_URI   file:// pvc:// http(s):// hf://
  KFT_MODEL_DIR     materialization dir      (default /mnt/models)
  KFT_BIND          host:port to serve on    (default 127.0.0.1:8080)
  KFT_DTYPE         "bfloat16" | "float32"   (default bfloat16)
  KFT_MAX_BATCH / KFT_MAX_SEQ    engine sizing
  KFT_FORCE_PLATFORM  "cpu" serves on the CPU; unset serves on CUDA and
                      fails when no GPU is visible
  KFT_PREFILL_QUOTA / KFT_INTERLEAVE_PREFILL / KFT_ADAPTIVE_DECODE_CHUNK /
  KFT_RADIX_CACHE    step-scheduler knobs (as in the JAX runtime)
  KFT_QUANT_KV       "none" | "int8" | "fp8_e4m3": the paged-KV pool dtype
  KFT_QUANT_WEIGHTS  "none" | "int8": weights quantized once at load
  KFT_QUANT_EXACT_PARITY  forces both off (the unquantized program)
  KFT_SPEC_DECODE / KFT_SPEC_K / KFT_SPEC_DRAFTER
                     speculative decoding: "1" turns it on, with up to
                     KFT_SPEC_K draft tokens a verify (default 3) from
                     drafter KFT_SPEC_DRAFTER ("ngram", the default)
  KFT_COMPILE_CACHE  accepted and unused: the port compiles no programs
                     (its kernels build once per checkout, under _build/)
  KFT_MESH          "expert=E,tensor=T" (either alone): serving on E x T
                     ranks, one process and one card each (NCCL), or CPU
                     ranks (gloo) with KFT_FORCE_PLATFORM=cpu; fewer
                     cards than ranks raise. A rank holds its KV heads,
                     heads and MLP columns over tensor and its share of
                     an MoE model's experts over expert (a dense model is
                     replicated over expert). Other axes (data, fsdp,
                     context, pipeline, and KFT_DCN) set above 1 raise:
                     they are a later slice
  KFT_TIER          disaggregated serving: "prefill" | "decode" (unset =
                     co-located). Stamps tier="..." on /metrics and
                     attaches the KV-migration runtime (serving/disagg.py)
                     behind the /v2/models/{m}/disagg routes. Other
                     values raise ValueError. With KFT_MESH the tier
                     serves over the mesh; the payload holds every KV
                     head, so a tier of any mesh hands off to a tier of
                     any other
  KFT_KV_BIND       decode tier: host:port of the paged-KV migration
                     listener (default 127.0.0.1:0; the bound address is
                     printed and rides stats()["disagg"]["kv_addr"])
  KFT_DEPOT         the executable depot: on a card LLMModel.load()
                     captures as without it and reports the reference's
                     outcome for a program it cannot serialize,
                     "compiled", with its counters in stats()["depot"]
                     (a CUDA graph never leaves its process); where
                     nothing is captured it changes nothing
  KFT_MODELS_CONFIG_DIR  multi-model serving (the KServe agent /
                     TrainedModel role): a directory of JSON descriptors
                     {"name", "storage_uri", "env"}, reconciled by a
                     serving.agents.ModelPuller every
                     KFT_MODELS_SYNC_PERIOD seconds (default 2.0): a new
                     descriptor is downloaded under KFT_MODEL_DIR/<name>
                     (default /mnt/models) and hot-loaded, a removed one
                     unloaded. Each model is built by build_model_from_env
                     from this env with KFT_MODEL_NAME and KFT_MODEL_DIR
                     set to the descriptor's, KFT_STORAGE_URI emptied and
                     the descriptor's "env" merged over it (so one model
                     may quantize its KV pool and its neighbour not). The
                     single model of KFT_STORAGE_URI is built beside them
                     when that is set; without it the repository starts
                     empty
  KFT_V2_SOCKET_BIND host:port of the binary V2 data plane
                     (serving.v2_socket, the gRPC port's role) on the same
                     repository; unset serves HTTP only

KFT_MODEL_FORMAT takes the llama formats only, as the JAX runtime's
build_model_from_env does; the function predictor (serving.torch_model.
TorchModel, the JAX package's JAXModel) is built in code, in both
packages.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import threading
from typing import Mapping, Optional

import torch

from kubeflow_tpu_torch.device import platform_device
from kubeflow_tpu_torch.parallel.mesh import mesh_from_topology_env
from kubeflow_tpu_torch.serving import storage
from kubeflow_tpu_torch.serving.agents import ModelPuller
from kubeflow_tpu_torch.serving.disagg import TIERS, TierRuntime
from kubeflow_tpu_torch.serving.model import Model, ModelRepository
from kubeflow_tpu_torch.serving.server import ModelServer
from kubeflow_tpu_torch.serving.torch_model import LLMModel
from kubeflow_tpu_torch.serving.v2_socket import V2SocketServer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def check_tier(env: Mapping[str, str]) -> None:
    """Raise for a KFT_TIER that names no tier."""
    tier = env.get("KFT_TIER", "")
    if tier and tier not in TIERS:
        raise ValueError(f"KFT_TIER={tier!r} (want prefill|decode)")


def init_storage(env: Mapping[str, str]) -> Optional[str]:
    """The storage-initializer step: materialize KFT_STORAGE_URI into
    KFT_MODEL_DIR and return the local path (None when no uri is set)."""
    uri = env.get("KFT_STORAGE_URI") or ""
    if not uri:
        return env.get("KFT_MODEL_DIR") or None
    dest = env.get("KFT_MODEL_DIR") or "/mnt/models"
    return storage.download(uri, dest)


def scheduler_from_env(env: Mapping[str, str]):
    """KFT_PREFILL_QUOTA / KFT_INTERLEAVE_PREFILL /
    KFT_ADAPTIVE_DECODE_CHUNK / KFT_RADIX_CACHE / KFT_SPEC_DECODE /
    KFT_SPEC_K / KFT_SPEC_DRAFTER -> SchedulerConfig (None when nothing
    is set, keeping the engine defaults)."""
    from kubeflow_tpu_torch.serving.scheduler import SchedulerConfig

    keys = ("KFT_PREFILL_QUOTA", "KFT_INTERLEAVE_PREFILL",
            "KFT_ADAPTIVE_DECODE_CHUNK", "KFT_RADIX_CACHE",
            "KFT_SPEC_DECODE", "KFT_SPEC_K", "KFT_SPEC_DRAFTER")
    if not any(env.get(k) for k in keys):
        return None
    on = lambda k: env.get(k, "1") not in ("0", "false", "no", "")
    defaults = SchedulerConfig()
    return SchedulerConfig(
        prefill_tokens_per_step=int(env.get("KFT_PREFILL_QUOTA", "0") or 0),
        interleave_prefill=on("KFT_INTERLEAVE_PREFILL"),
        adaptive_decode_chunk=on("KFT_ADAPTIVE_DECODE_CHUNK"),
        radix_cache=on("KFT_RADIX_CACHE"),
        spec_decode=env.get("KFT_SPEC_DECODE", "") not in
            ("", "0", "false", "no"),
        spec_k=int(env.get("KFT_SPEC_K", "") or defaults.spec_k),
        spec_drafter=env.get("KFT_SPEC_DRAFTER", "")
            or defaults.spec_drafter)


def quant_from_env(env: Mapping[str, str]):
    """KFT_QUANT_KV / KFT_QUANT_WEIGHTS / KFT_QUANT_EXACT_PARITY ->
    QuantConfig (None when nothing is set)."""
    from kubeflow_tpu_torch.serving.scheduler import QuantConfig

    keys = ("KFT_QUANT_KV", "KFT_QUANT_WEIGHTS", "KFT_QUANT_EXACT_PARITY")
    if not any(env.get(k) for k in keys):
        return None
    return QuantConfig(
        kv_dtype=env.get("KFT_QUANT_KV", "") or "none",
        weight_dtype=env.get("KFT_QUANT_WEIGHTS", "") or "none",
        exact_parity=env.get("KFT_QUANT_EXACT_PARITY", "") not in
            ("", "0", "false", "no"))


def build_model_from_env(env: Mapping[str, str]) -> Model:
    """Construct the Model the env contract describes, on CUDA unless
    KFT_FORCE_PLATFORM=cpu asks for the CPU; KFT_MESH=tensor=N shards it
    over N ranks and KFT_MESH=expert=E,tensor=T over E x T (as the JAX
    runtime's mesh_from_topology_env)."""
    check_tier(env)
    name = env.get("KFT_MODEL_NAME", "model")
    fmt = (env.get("KFT_MODEL_FORMAT") or "llama").lower()
    if fmt not in ("llama", "llm", "huggingface"):
        raise ValueError(f"unsupported KFT_MODEL_FORMAT {fmt!r}")
    device = platform_device(env.get("KFT_FORCE_PLATFORM"))
    mesh = (mesh_from_topology_env(env)
            if env.get("KFT_MESH") or env.get("KFT_DCN") else None)
    if mesh is not None:
        device = None                # the mesh places every rank
    model_dir = init_storage(env)
    if not model_dir:
        raise ValueError("llama format needs KFT_STORAGE_URI/KFT_MODEL_DIR")
    return LLMModel.from_pretrained(
        name, model_dir, dtype=_DTYPES[env.get("KFT_DTYPE", "bfloat16")],
        device=device, mesh=mesh,
        max_batch=int(env.get("KFT_MAX_BATCH", 8)),
        max_seq=int(env.get("KFT_MAX_SEQ", 1024)),
        scheduler=scheduler_from_env(env),
        quant=quant_from_env(env),
        tier=env.get("KFT_TIER", ""))


def attach_tier(model, env: Mapping[str, str]):
    """A KFT_TIER replica's KV-migration runtime on its loaded engine
    (the server's /disagg routes dispatch to it); the decode tier also
    binds its KV listener at KFT_KV_BIND. Returns the listener's bound
    (host, port), or None."""
    tier = env.get("KFT_TIER", "")
    if not tier or getattr(model, "engine", None) is None:
        return None
    model.disagg = TierRuntime(model.engine, tier, model=model)
    if tier != "decode":
        return None
    return model.disagg.attach_receiver(env.get("KFT_KV_BIND")
                                        or "127.0.0.1:0")


def _address(bind: str) -> tuple:
    host, _, port = bind.rpartition(":")
    return host or "127.0.0.1", int(port)


def puller_factory(env: Mapping[str, str]):
    """The ModelPuller's ``factory(descriptor, local_path)``: the model
    build_model_from_env makes of ``env`` with the descriptor's name, its
    local path, no KFT_STORAGE_URI (the puller downloaded it) and the
    descriptor's "env" merged over it."""
    def factory(desc: dict, local: str) -> Model:
        sub = {**env, "KFT_MODEL_NAME": desc["name"],
               "KFT_MODEL_DIR": local, "KFT_STORAGE_URI": "",
               **{k: str(v) for k, v in desc.get("env", {}).items()}}
        return build_model_from_env(sub)
    return factory


@dataclasses.dataclass
class Runtime:
    """What ``start`` started: the repository, the HTTP server, and where
    set the model puller's watcher (its stop event) and the V2 socket
    server."""
    repository: ModelRepository
    server: ModelServer
    stop_watch: Optional[threading.Event] = None
    v2: Optional[V2SocketServer] = None

    def stop(self) -> None:
        """Stop the watcher and both servers, then unload every model."""
        if self.stop_watch is not None:
            self.stop_watch.set()
        if self.v2 is not None:
            self.v2.stop()
        self.server.stop()
        for name in self.repository.names():
            self.repository.unload(name)


def start(env: Mapping[str, str]) -> Runtime:
    """Build and start what the env describes (the JAX runtime's main):
    the single model unless only KFT_MODELS_CONFIG_DIR is set, the model
    puller over KFT_MODELS_CONFIG_DIR (one sync, then its watcher), the
    HTTP server at KFT_BIND and the V2 socket at KFT_V2_SOCKET_BIND, all
    on one repository. Prints the lines the JAX runtime prints."""
    repo = ModelRepository()
    if env.get("KFT_STORAGE_URI") or not env.get("KFT_MODELS_CONFIG_DIR"):
        model = build_model_from_env(env)
        repo.register(model)                   # load()s eagerly
        kv_addr = attach_tier(model, env)
        if kv_addr is not None:
            print(f"disagg decode kv listener at {kv_addr[0]}:{kv_addr[1]}",
                  flush=True)
    stop_watch = None
    watch_dir = env.get("KFT_MODELS_CONFIG_DIR")
    if watch_dir:
        puller = ModelPuller(repo, watch_dir, puller_factory(env),
                             model_dir=env.get("KFT_MODEL_DIR",
                                               "/mnt/models"))
        puller.sync()
        stop_watch = threading.Event()
        puller.watch(period=float(env.get("KFT_MODELS_SYNC_PERIOD", "2.0")),
                     stop=stop_watch)
        print(f"model-puller watching {watch_dir}", flush=True)
    server = ModelServer(repo, *_address(env.get("KFT_BIND",
                                                 "127.0.0.1:8080")))
    server.start()
    print(f"serving {repo.names()} at {server.url}", flush=True)
    v2 = None
    if env.get("KFT_V2_SOCKET_BIND"):
        v2 = V2SocketServer(repo, *_address(env["KFT_V2_SOCKET_BIND"]))
        v2.start()
        print(f"v2-socket at {v2.address[0]}:{v2.address[1]}", flush=True)
    return Runtime(repo, server, stop_watch, v2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubeflow_tpu_torch.serving.runtime")
    ap.add_argument("--init-only", action="store_true",
                    help="run the storage-initializer step and exit")
    args = ap.parse_args(argv)
    env = os.environ
    if args.init_only:
        path = init_storage(env)
        print(f"storage-initializer: materialized {path}", flush=True)
        return 0
    start(env)
    threading.Event().wait()           # serve until killed
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

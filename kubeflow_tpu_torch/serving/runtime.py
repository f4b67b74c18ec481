"""Predictor runtime entrypoint of the PyTorch port — env contract ->
storage init -> server (counterpart of ``kubeflow_tpu.serving.runtime``).

``python -m kubeflow_tpu_torch.serving.runtime`` builds the model the env
describes and serves V1+V2 HTTP; ``--init-only`` runs the storage-
initializer step and exits. The env contract is the JAX runtime's:

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

KFT_MODELS_CONFIG_DIR and KFT_V2_SOCKET_BIND belong to later slices of
the port: when one is set the runtime raises, naming the slice, instead
of ignoring it.
"""

from __future__ import annotations

import argparse
import os
import threading
from typing import Mapping, Optional

import torch

from kubeflow_tpu_torch.device import platform_device
from kubeflow_tpu_torch.parallel.mesh import mesh_from_topology_env
from kubeflow_tpu_torch.serving import storage
from kubeflow_tpu_torch.serving.disagg import TIERS, TierRuntime
from kubeflow_tpu_torch.serving.model import Model, ModelRepository
from kubeflow_tpu_torch.serving.server import ModelServer
from kubeflow_tpu_torch.serving.torch_model import LLMModel

LATER_SLICES = {
    "KFT_MODELS_CONFIG_DIR": "multi-model serving (model puller)",
    "KFT_V2_SOCKET_BIND": "the binary V2 socket data plane",
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def check_env_slices(env: Mapping[str, str]) -> None:
    """Raise for env knobs whose feature the port does not have yet, and
    for a KFT_TIER that names no tier."""
    for key, what in LATER_SLICES.items():
        if env.get(key):
            raise NotImplementedError(
                f"{key} is set: {what} is a later slice of the PyTorch port")
    tier = env.get("KFT_TIER", "")
    if tier:
        if tier not in TIERS:
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
    check_env_slices(env)
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
    repo = ModelRepository()
    model = build_model_from_env(env)
    repo.register(model)                       # load()s eagerly
    kv_addr = attach_tier(model, env)
    if kv_addr is not None:
        print(f"disagg decode kv listener at {kv_addr[0]}:{kv_addr[1]}",
              flush=True)
    bind = env.get("KFT_BIND", "127.0.0.1:8080")
    host, _, port = bind.rpartition(":")
    server = ModelServer(repo, host=host or "127.0.0.1", port=int(port))
    server.start()
    print(f"serving {repo.names()} at {server.url}", flush=True)
    threading.Event().wait()           # serve until killed
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

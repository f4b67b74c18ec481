"""Serving agent roles of the PyTorch port: request batcher, payload
logger, model puller (counterpart of ``kubeflow_tpu.serving.agents``,
which imports numpy and the serving base classes only; this is its copy
over the port's classes).

The reference ships these as the KServe *agent* sidecar container
(`[U] kserve:cmd/agent` — batcher, logger, and the multi-model puller,
SURVEY.md §2.4 'Agent sidecars'). In the single-binary design they are
in-process wrappers/watchers around the same Model/ModelRepository
surface:

- ``BatchingModel`` — wraps a Model; concurrent predict() calls coalesce
  into one batched model call (flush on max_batch_size or max_latency).
  On the card this is what keeps a batch bucket full under many small
  requests.
- ``LoggingModel`` — wraps a Model; request/response payloads stream to a
  JSONL sink asynchronously (the payload-logger role; swap the sink for
  an HTTP poster to match the CloudEvents logger).
- ``ModelPuller`` — watches a config directory of model descriptors,
  downloading + hot-registering on add and unloading on remove (the
  multi-model agent role over the repository's load/unload API).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from kubeflow_tpu_torch.serving import storage
from kubeflow_tpu_torch.serving.model import (
    Model, ModelNotReady, ModelRepository,
)
from kubeflow_tpu_torch.serving.protocol import (
    InferRequest, InferResponse, InferTensor,
)


class BatchingModel(Model):
    """Coalesces concurrent single requests into batched inner predicts.

    The inner model must be batch-transparent: outputs' leading dim matches
    the concatenated inputs' leading dim (true of every tensor model here).
    """

    def __init__(self, inner: Model, *, max_batch_size: int = 8,
                 max_latency_ms: float = 5.0):
        super().__init__(inner.name)
        self.inner = inner
        self.max_batch_size = max_batch_size
        self.max_latency = max_latency_ms / 1000.0
        self._queue: "queue.Queue[tuple]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._state_lock = threading.Lock()
        self.batches = 0                       # observability: flush count

    def load(self) -> bool:
        self.inner.load()
        # re-loadable after unload: fresh stop flag + worker thread (a
        # finished Thread object can never be start()ed again)
        with self._state_lock:
            if self._worker is None or not self._worker.is_alive():
                self._stop = threading.Event()
                self._worker = threading.Thread(target=self._run,
                                                daemon=True)
                self._worker.start()
            self.ready = True
        return self.ready

    def unload(self) -> None:
        # ready flips under the same lock predict() enqueues under, so no
        # request can slip into the queue after the drain below
        with self._state_lock:
            self.ready = False
            self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5)
            self._worker = None
        # callers already queued must not block forever on done.wait()
        while True:
            try:
                _, done, box = self._queue.get_nowait()
            except queue.Empty:
                break
            box["error"] = ModelNotReady(self.name)
            done.set()
        self.inner.unload()

    def predict(self, request: InferRequest) -> InferResponse:
        done = threading.Event()
        box: dict = {}
        with self._state_lock:
            if not self.ready:
                raise ModelNotReady(self.name)
            self._queue.put((request, done, box))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box["response"]

    # -- background flusher --

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_latency
            while len(batch) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._flush(batch)

    def _flush(self, batch: list[tuple]) -> None:
        self.batches += 1
        try:
            arrays = [req.as_numpy() for req, _, _ in batch]
            sizes = [a.shape[0] for a in arrays]
            merged = InferRequest(
                model_name=self.inner.name,
                inputs=[InferTensor.from_numpy(
                    batch[0][0].inputs[0].name, np.concatenate(arrays))])
            out = self.inner(merged).as_numpy()
            off = 0
            for (req, done, box), n in zip(batch, sizes):
                box["response"] = InferResponse.from_numpy(
                    self.name, {"output-0": out[off:off + n]}, id=req.id)
                off += n
                done.set()
        except Exception as e:
            for _, done, box in batch:
                box["error"] = e
                done.set()


class LoggingModel(Model):
    """Async request/response payload logging around any Model."""

    def __init__(self, inner: Model, sink_path: str,
                 mode: str = "all"):       # all|request|response
        super().__init__(inner.name)
        self.inner = inner
        self.sink_path = sink_path
        self.mode = mode
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue()
        # pending counts records enqueued but not yet WRITTEN (queue.empty()
        # goes true before the write happens, so flush keys on this instead)
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._start_worker()

    def _start_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def load(self) -> bool:
        self.inner.load()
        self._start_worker()          # survives hot unload->load cycles
        self.ready = True
        return self.ready

    def unload(self) -> None:
        self._queue.put(None)
        if self._worker is not None:
            self._worker.join(timeout=5)
            self._worker = None
        self.inner.unload()
        self.ready = False

    def predict(self, request: InferRequest) -> InferResponse:
        t0 = time.time()
        resp = self.inner(request)
        rec = {"model": self.name, "id": request.id, "ts": t0,
               "latency_ms": 1000 * (time.time() - t0)}
        if self.mode in ("all", "request"):
            rec["request"] = request.to_dict()
        if self.mode in ("all", "response"):
            rec["response"] = resp.to_dict()
        with self._pending_lock:
            self._pending += 1
        self._queue.put(rec)
        return resp

    def flush(self, timeout: float = 5.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._pending_lock:
                if self._pending == 0:
                    return
            time.sleep(0.01)

    def _drain(self) -> None:
        while True:
            rec = self._queue.get()
            if rec is None:
                return
            try:
                with open(self.sink_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass
            finally:
                with self._pending_lock:
                    self._pending -= 1


class ModelPuller:
    """Multi-model agent: sync a repository with a directory of model
    descriptors (JSON files: {"name", "storage_uri", ...}), downloading on
    add and unloading on remove — the kserve agent's puller/watcher role.

    ``factory(descriptor, local_path) -> Model`` builds the model once its
    artifacts are local; ``download`` defaults to the port's
    serving.storage.download.
    """

    def __init__(self, repository: ModelRepository, config_dir: str,
                 factory: Callable[[dict, str], Model],
                 model_dir: Optional[str] = None,
                 download: Optional[Callable[[str, str], str]] = None):
        self.repository = repository
        self.config_dir = config_dir
        self.factory = factory
        self.model_dir = model_dir or os.path.join(config_dir, "_models")
        self.download = download or storage.download
        self._seen: dict[str, dict] = {}
        self._failed: dict[str, dict] = {}   # descriptor content at failure

    def sync(self) -> dict:
        """One reconcile pass. Returns {"loaded": [...], "unloaded": [...]}"""
        current: dict[str, dict] = {}
        if os.path.isdir(self.config_dir):
            for fn in sorted(os.listdir(self.config_dir)):
                if not fn.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(self.config_dir, fn)) as f:
                        desc = json.load(f)
                    current[desc["name"]] = desc
                except (OSError, ValueError, KeyError):
                    continue
        loaded, unloaded, errors = [], [], {}
        for name, desc in current.items():
            if self._seen.get(name) == desc:
                continue
            if self._failed.get(name) == desc:
                # an UNCHANGED bad descriptor is not retried every pass —
                # re-downloading a broken multi-GB checkpoint on a 2s
                # period is pure churn; edit the file to retry
                continue
            # per-descriptor isolation: one unreachable uri or malformed
            # checkpoint must not starve later models of this pass (or, at
            # startup, crash the server)
            try:
                local = os.path.join(self.model_dir, name)
                if desc.get("storage_uri"):
                    os.makedirs(local, exist_ok=True)
                    local = self.download(desc["storage_uri"], local)
                self.repository.register(self.factory(desc, local))
            except Exception as e:
                errors[name] = f"{type(e).__name__}: {e}"
                self._failed[name] = desc
                print(f"model-puller: {name} failed: {errors[name]}",
                      flush=True)
                continue
            self._failed.pop(name, None)
            self._seen[name] = desc
            loaded.append(name)
        for name in list(self._seen):
            if name not in current:
                try:
                    self.repository.unload(name)
                except KeyError:
                    pass
                del self._seen[name]
                unloaded.append(name)
        # removed descriptors also clear their failure memory
        self._failed = {k: v for k, v in self._failed.items()
                        if k in current}
        return {"loaded": loaded, "unloaded": unloaded, "errors": errors}

    def watch(self, period: float = 2.0,
              stop: Optional[threading.Event] = None) -> threading.Thread:
        stop = stop or threading.Event()
        self._stop = stop

        def loop():
            while not stop.wait(period):
                # one bad descriptor (unreachable uri, malformed
                # checkpoint) must not kill the watcher for the rest of
                # the server's life
                try:
                    self.sync()
                except Exception as e:
                    print(f"model-puller sync failed: "
                          f"{type(e).__name__}: {e}", flush=True)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t

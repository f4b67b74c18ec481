"""Model lifecycle + repository — the kserve.Model equivalent.

Parity: SURVEY.md §2.4 'Python model server' — Model lifecycle
(load/preprocess/predict/postprocess/explain) and the multi-model
repository with hot load/unload (TrainedModel / model-repository API).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from kubeflow_tpu_torch.serving.protocol import InferRequest, InferResponse


class Model:
    """Override ``load`` + ``predict`` (and optionally pre/postprocess,
    explain). ``__call__`` runs the full chain, like the reference server."""

    def __init__(self, name: str):
        self.name = name
        self.ready = False
        self.version = "1"

    def load(self) -> bool:
        self.ready = True
        return self.ready

    def unload(self) -> None:
        self.ready = False

    def preprocess(self, request: InferRequest) -> InferRequest:
        return request

    def predict(self, request: InferRequest) -> InferResponse:
        raise NotImplementedError

    def postprocess(self, response: InferResponse) -> InferResponse:
        return response

    def explain(self, request: InferRequest) -> dict:
        raise NotImplementedError(f"model {self.name} has no explainer")

    def metadata(self) -> dict:
        return {
            "name": self.name,
            "versions": [self.version],
            "platform": "kubeflow-tpu-torch",
            "inputs": [],
            "outputs": [],
        }

    def __call__(self, request: InferRequest) -> InferResponse:
        if not self.ready:
            raise ModelNotReady(self.name)
        t0 = time.perf_counter()
        resp = self.postprocess(self.predict(self.preprocess(request)))
        resp.parameters["latency_ms"] = 1000 * (time.perf_counter() - t0)
        return resp


class ModelNotReady(RuntimeError):
    def __init__(self, name: str):
        super().__init__(f"model {name!r} is not ready")
        self.model_name = name


class ModelMissing(KeyError):
    def __init__(self, name: str):
        super().__init__(f"model {name!r} not found")
        self.model_name = name


class ModelRepository:
    """Thread-safe named model store with hot load/unload."""

    def __init__(self):
        self._models: dict[str, Model] = {}
        self._lock = threading.Lock()

    def register(self, model: Model, load: bool = True) -> None:
        with self._lock:
            self._models[model.name] = model
        if load and not model.ready:
            model.load()

    def unload(self, name: str) -> None:
        with self._lock:
            model = self._models.pop(name, None)
        if model is None:
            raise ModelMissing(name)
        model.unload()

    def get(self, name: str) -> Model:
        with self._lock:
            model = self._models.get(name)
        if model is None:
            raise ModelMissing(name)
        return model

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def all_ready(self) -> bool:
        with self._lock:
            models = list(self._models.values())
        return all(m.ready for m in models)

"""Serving layer of the PyTorch port (counterpart of
``kubeflow_tpu.serving``): the LLM engine over the paged KV pool, the
model server, and the runtime entrypoint."""

from kubeflow_tpu_torch.serving.llm import (
    GenRequest, LLMEngine, SamplingParams,
)
from kubeflow_tpu_torch.serving.model import (
    Model, ModelMissing, ModelNotReady, ModelRepository,
)
from kubeflow_tpu_torch.serving.protocol import (
    InferRequest, InferResponse, InferTensor,
)
from kubeflow_tpu_torch.serving.scheduler import SchedulerConfig
from kubeflow_tpu_torch.serving.server import InferenceClient, ModelServer
from kubeflow_tpu_torch.serving.torch_model import LLMModel

__all__ = [
    "GenRequest", "InferRequest", "InferResponse", "InferTensor",
    "InferenceClient", "LLMEngine", "LLMModel", "Model", "ModelMissing",
    "ModelNotReady", "ModelRepository", "ModelServer", "SamplingParams",
    "SchedulerConfig",
]

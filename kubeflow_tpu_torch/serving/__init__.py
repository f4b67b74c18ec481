"""Serving layer of the PyTorch port (counterpart of
``kubeflow_tpu.serving``): the LLM engine over the paged KV pool, the
function predictor, the model server and the V2 socket, the agent roles
(batcher, payload logger, model puller), and the runtime entrypoint."""

from kubeflow_tpu_torch.serving.agents import (
    BatchingModel, LoggingModel, ModelPuller,
)
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
from kubeflow_tpu_torch.serving.torch_model import LLMModel, TorchModel
from kubeflow_tpu_torch.serving.v2_socket import (
    V2SocketClient, V2SocketServer,
)

__all__ = [
    "BatchingModel", "GenRequest", "InferRequest", "InferResponse",
    "InferTensor", "InferenceClient", "LLMEngine", "LLMModel",
    "LoggingModel", "Model", "ModelMissing", "ModelNotReady",
    "ModelPuller", "ModelRepository", "ModelServer", "SamplingParams",
    "SchedulerConfig", "TorchModel", "V2SocketClient", "V2SocketServer",
]

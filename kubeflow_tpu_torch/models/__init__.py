"""Model code of the port (counterpart of ``kubeflow_tpu.models``):
Llama (and Mixtral) with its HF checkpoint reader and writer, the MNIST
CNN and the ResNet family."""

from kubeflow_tpu_torch.models import hf_llama, llama, mnist, resnet

__all__ = ["hf_llama", "llama", "mnist", "resnet"]

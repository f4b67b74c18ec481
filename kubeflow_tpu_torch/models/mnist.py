"""MNIST CNN of the port (counterpart of ``kubeflow_tpu.models.mnist``,
the CPU-only baseline config 'TFJob single-worker MNIST CNN').

The same function as the JAX model on NHWC images: two 3x3 "SAME"
convolutions, each followed by ReLU and a 2x2 "VALID" max-pool, then two
dense layers. Convolution weights are stored OIHW (PyTorch's layout; the
JAX tree's HWIO transposes through ``interop.mnist_from_jax``), dense
weights ``[in, out]`` as in the JAX tree. The flatten before ``fc1`` takes
the activations in NHWC order, as the JAX model's reshape does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.device import DeviceLike, resolve_device


def init_params(generator: torch.Generator, dtype=torch.float32,
                device: DeviceLike = None) -> dict:
    """He-normal weights and zero biases on ``device`` (CUDA unless
    ``"cpu"`` is asked for), drawn from ``generator``, which must live
    there too. The draws differ from ``jax.random``'s."""
    device = resolve_device(device)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_((2.0 / fan_in) ** 0.5).to(dtype)

    return {
        "conv1": normal((32, 1, 3, 3), 3 * 3 * 1),
        "conv2": normal((64, 32, 3, 3), 3 * 3 * 32),
        "fc1": normal((7 * 7 * 64, 128), 7 * 7 * 64),
        "b1": torch.zeros((128,), dtype=dtype, device=device),
        "fc2": normal((128, 10), 128),
        "b2": torch.zeros((10,), dtype=dtype, device=device),
    }


def forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: [B, 28, 28, 1] -> logits [B, 10]."""
    x = images.permute(0, 3, 1, 2)                 # NCHW view of NHWC
    x = F.max_pool2d(F.relu(F.conv2d(x, params["conv1"], padding=1)), 2)
    x = F.max_pool2d(F.relu(F.conv2d(x, params["conv2"], padding=1)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"] + params["b1"])
    return x @ params["fc2"] + params["b2"]

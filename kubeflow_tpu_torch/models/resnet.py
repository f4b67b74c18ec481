"""ResNet-v1.5 family of the port (counterpart of
``kubeflow_tpu.models.resnet``): the same function on NHWC images, bf16
compute with f32 params and batch-norm statistics threaded through
``forward`` as explicit state.

Where the two libraries differ, this module writes out what XLA does:

- "SAME" padding is XLA's: a dimension of size n under kernel k and
  stride s pads ``(out - 1) * s + k - n`` in all (``out = ceil(n / s)``),
  the smaller half before. That is asymmetric for ResNet's stride-2
  layers (the 7x7 stem on 224 pads (2, 3), the stride-2 3x3 convolutions
  and the 3x3/2 max-pool (0, 1)), where ``F.conv2d(padding=k // 2)``
  would give the same shape over windows shifted by one pixel. Those
  pads are explicit: zeros for the convolutions, ``-inf`` for the pool.
- Batch norm is computed in f32 as the JAX model computes it: the biased
  batch variance in training, running statistics ``0.9 * old + 0.1 *
  batch``, ``rsqrt(var + 1e-5)``, then a cast back to the compute dtype
  (``F.batch_norm`` updates its running variance with the unbiased one).

Convolution weights are stored OIHW (PyTorch's layout; the JAX tree's
HWIO transposes through ``interop.resnet_from_jax``) and cast to
``cfg.dtype`` at each use, as the JAX model casts them; activations stay
NHWC in memory (``channels_last``), the layout the card's convolutions
take. The convolutions are PyTorch's: the JAX model computes them with
XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)   # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16


def resnet50(**kw) -> ResNetConfig:
    return ResNetConfig(**kw)


def resnet18(**kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(2, 2, 2, 2), **kw)


def resnet_tiny(**kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(1, 1), width=8, num_classes=10, **kw)


def init_params(generator: torch.Generator, cfg: ResNetConfig,
                device: DeviceLike = None):
    """Returns (params, batch_stats) on ``device`` (CUDA unless ``"cpu"``
    is asked for), in f32, drawn from ``generator``, which must live
    there too: He-normal convolutions, N(0, 1/in) head, unit scales,
    zero biases, zero means and unit variances. The draws differ from
    ``jax.random``'s."""
    device = resolve_device(device)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32).mul_(std)

    def conv(o, i, k):
        return normal((o, i, k, k), (2.0 / (k * k * i)) ** 0.5)

    def bn(c):
        return {"scale": torch.ones((c,), device=device),
                "bias": torch.zeros((c,), device=device)}

    def stats(c):
        return {"mean": torch.zeros((c,), device=device),
                "var": torch.ones((c,), device=device)}

    params = {"stem": {"conv": conv(cfg.width, 3, 7), "bn": bn(cfg.width)}}
    batch_stats = {"stem": stats(cfg.width)}
    in_c = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        out_c, mid_c = cfg.width * (2 ** si) * 4, cfg.width * (2 ** si)
        stage_p, stage_s = [], []
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk_p = {"conv1": conv(mid_c, in_c, 1), "bn1": bn(mid_c),
                     "conv2": conv(mid_c, mid_c, 3), "bn2": bn(mid_c),
                     "conv3": conv(out_c, mid_c, 1), "bn3": bn(out_c)}
            blk_s = {"bn1": stats(mid_c), "bn2": stats(mid_c),
                     "bn3": stats(out_c)}
            if in_c != out_c or stride != 1:
                blk_p["proj"] = conv(out_c, in_c, 1)
                blk_p["proj_bn"] = bn(out_c)
                blk_s["proj_bn"] = stats(out_c)
            stage_p.append(blk_p)
            stage_s.append(blk_s)
            in_c = out_c
        params[f"stage{si}"] = stage_p
        batch_stats[f"stage{si}"] = stage_s
    params["head"] = {"w": normal((in_c, cfg.num_classes), in_c ** -0.5),
                      "b": torch.zeros((cfg.num_classes,), device=device)}
    return params, batch_stats


def same_pads(n: int, k: int, s: int) -> tuple:
    """XLA's "SAME" padding of a dimension of size n: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """(x, pad): ``x`` (NCHW) padded with ``value`` as XLA pads it for a
    k x k window of stride s, and pad (0, 0) for the window op; where
    XLA's pads are symmetric, ``x`` itself and those pads for the op."""
    (h0, h1), (w0, w1) = (same_pads(n, k, s) for n in x.shape[2:])
    if h0 == h1 and w0 == w1:
        return x, (h0, w0)
    return F.pad(x, (w0, w1, h0, h1), value=value), (0, 0)


def _conv(x, w, stride: int, dtype):
    x, pad = _pad_same(x.to(dtype), w.shape[-1], stride)
    return F.conv2d(x, w.to(dtype, memory_format=torch.channels_last),
                    stride=stride, padding=pad)


def _max_pool(x):
    """3x3 max-pool, stride 2, "SAME" (pads are -inf)."""
    x, pad = _pad_same(x, 3, 2, float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=pad)


def _bn(x, p, s, train: bool, momentum=0.9, eps=1e-5):
    """Returns (y, new_stats)."""
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        var = xf.var(dim=(0, 2, 3), correction=0)
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean,
                 "var": momentum * s["var"] + (1 - momentum) * var}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s

    def c(t):
        return t.view(1, -1, 1, 1)

    y = ((xf - c(mean)) * c(torch.rsqrt(var + eps)) * c(p["scale"])
         + c(p["bias"]))
    return y.to(x.dtype), new_s


def forward(params, stats, images, cfg: ResNetConfig, train: bool = True):
    """images: [B, H, W, 3] -> (logits [B, classes] f32, new_stats)."""
    dt = cfg.dtype
    new_stats: dict = {}
    x = images.permute(0, 3, 1, 2)             # NCHW view, NHWC in memory
    x = _conv(x, params["stem"]["conv"], 2, dt)
    x, new_stats["stem"] = _bn(x, params["stem"]["bn"], stats["stem"], train)
    x = _max_pool(F.relu(x))
    for si in range(len(cfg.stage_sizes)):
        stage_stats = []
        for bi, blk in enumerate(params[f"stage{si}"]):
            s = stats[f"stage{si}"][bi]
            ns: dict = {}
            stride = 2 if (si > 0 and bi == 0) else 1
            residual = x
            y = _conv(x, blk["conv1"], 1, dt)
            y, ns["bn1"] = _bn(y, blk["bn1"], s["bn1"], train)
            y = _conv(F.relu(y), blk["conv2"], stride, dt)
            y, ns["bn2"] = _bn(y, blk["bn2"], s["bn2"], train)
            y = _conv(F.relu(y), blk["conv3"], 1, dt)
            y, ns["bn3"] = _bn(y, blk["bn3"], s["bn3"], train)
            if "proj" in blk:
                residual = _conv(x, blk["proj"], stride, dt)
                residual, ns["proj_bn"] = _bn(
                    residual, blk["proj_bn"], s["proj_bn"], train)
            x = F.relu(y + residual)
            stage_stats.append(ns)
        new_stats[f"stage{si}"] = stage_stats
    x = x.float().mean(dim=(2, 3))
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, new_stats

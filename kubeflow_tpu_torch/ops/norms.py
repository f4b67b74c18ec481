"""Normalization ops. RMSNorm, computed in float32 whatever the input
dtype and cast back on exit (counterpart of ``kubeflow_tpu.ops.norms``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    orig_dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(orig_dtype)

"""Rotary position embeddings (RoPE), including Llama-3 frequency scaling
(counterpart of ``kubeflow_tpu.ops.rotary``; the frequency table is the
same numpy computation, so both packages rotate by identical angles)."""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    theta: float = 500000.0,
    scaling: str | None = "llama3",
    scale_factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_seq: int = 8192,
) -> np.ndarray:
    """Inverse frequencies [head_dim//2], optionally Llama-3-scaled for
    long context."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim))
    if scaling == "llama3":
        low_wavelen = original_max_seq / low_freq_factor
        high_wavelen = original_max_seq / high_freq_factor
        wavelen = 2 * np.pi / inv
        # three bands: keep high-freq, scale low-freq, smooth in between
        smooth = (original_max_seq / wavelen - low_freq_factor) / (
            high_freq_factor - low_freq_factor
        )
        inv = np.where(
            wavelen > low_wavelen,
            inv / scale_factor,
            np.where(
                wavelen < high_wavelen,
                inv,
                (1 - smooth) * inv / scale_factor + smooth * inv,
            ),
        )
    return inv.astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in float32, cast back to ``x.dtype``.

    x: [..., seq, heads, head_dim]; positions: [..., seq] integer;
    inv_freq: [head_dim//2] float32 on x's device.
    """
    angles = positions[..., :, None].float() * inv_freq      # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

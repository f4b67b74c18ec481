"""Causal grouped-query attention in plain PyTorch (counterpart of
``kubeflow_tpu.ops.attention``).

In the JAX package the "xla" path and decode attention are XLA einsums,
not Pallas kernels, so they stay plain tensor code here. ``impl="pallas"``
(the JAX package's own flash kernel) and ``impl="flash"`` (JAX's stock TPU
kernel with KV heads repeated, the same function) both run
``ops.flash_attention``: the hand-written flash kernels on CUDA tensors,
their plain versions on the CPU.

All paths take q: [B, S, H, D], k/v: [B, S, KV, D] and return [B, S, H, D].
GQA groups query heads over KV heads without repeating K/V.
"""

from __future__ import annotations

import math

import torch

from kubeflow_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -1e30


def _xla_attention(q, k, v, *, causal: bool, q_offset=0, bias=None):
    """Einsum attention: softmax in float32, mask value -1e30, output in
    q's dtype. ``q_offset`` is a Python int / 0-d tensor (every row shares
    one offset: prefill, chunked prefill) or a [B] tensor (per-slot
    offsets). A Python int offset is added on the device as a scalar: no
    host tensor is copied, so a CUDA graph can capture this path (the
    training step with ``attn_impl="xla"``)."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    groups = h // kvh
    qf = q.float().reshape(b, sq, kvh, groups, d)
    kf = k.float()
    vf = v.float()
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf * scale, kf)
    if bias is not None:
        logits = logits + bias
    if causal:
        q_pos = torch.arange(sq, device=q.device)[None, :]
        if isinstance(q_offset, torch.Tensor):
            q_pos = q_pos + q_offset.to(q.device).reshape(-1)[:, None]
        else:
            q_pos = q_pos + int(q_offset)
        kv_pos = torch.arange(skv, device=q.device)
        mask = q_pos[:, :, None] >= kv_pos[None, None, :]  # [B|1, Sq, Skv]
        logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vf)
    return out.reshape(b, sq, h, d).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, impl: str = "xla",
              q_offset=0, block_q: int = 512, block_kv: int = 512):
    """Multi-head / grouped-query attention; ``impl`` keeps the JAX
    package's switch values: "xla" (plain einsum attention) or
    "flash"/"pallas" (the flash kernels, which take no ``q_offset``).

    ``block_q``/``block_kv`` are kept only for the JAX dispatcher's
    signature: ``flash_attention`` checks them and the CUDA kernels tile
    64 x 64 rows on their own, so they never change the result."""
    if impl in ("flash", "pallas"):
        if not (isinstance(q_offset, int) and q_offset == 0):
            raise ValueError(
                f"impl={impl!r} does not support q_offset; use impl='xla' "
                "(decode paths use decode_attention)")
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_kv=block_kv)
    if impl == "xla":
        return _xla_attention(q, k, v, causal=causal, q_offset=q_offset)
    raise ValueError(f"attn_impl={impl!r} (want xla|flash|pallas)")


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-step decode attention against a KV cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, S_max, KV, D]; cache_len: [B]
    (valid cache entries per sequence, including this step).
    """
    b, _, h, d = q.shape
    kvh = k_cache.shape[2]
    groups = h // kvh
    qf = q.float().reshape(b, kvh, groups, d)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bkgd,bskd->bkgs", qf * scale, k_cache.float())
    mask = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
            < cache_len[:, None])
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)

"""Llama-3 model family in PyTorch (counterpart of
``kubeflow_tpu.models.llama``).

Parameters keep the JAX package's layout: a plain dict whose per-layer
weights are stacked on a leading ``layers`` axis (``wq [L, d, h, hd]``,
``wo [L, h, hd, d]``, ``w_gate [L, d, m]`` ...), so a tree converted by
``interop.params_from_jax`` drops straight in and every function here
takes the same arguments as its JAX counterpart. A Python loop over the
stacked layers takes the place of ``lax.scan``.

Compute runs in ``cfg.dtype`` with norms, RoPE and softmax in float32.
The serving slice is dense and unquantized: a config with
``n_experts > 0`` and int8 weight trees (``wq_q`` ...) raise
``NotImplementedError`` naming the slice that brings them.

``forward`` honours ``cfg.remat`` while autograd records: "none" keeps
every activation, "full" recomputes each block in backward
(``torch.utils.checkpoint``), and "dots" saves only the weight products
(``aten.mm``: the projections have no batch dims once flattened to rows)
and recomputes everything else, the flash-attention forward included --
the JAX package's ``checkpoint_dots_with_no_batch_dims``. The weight
products are written as row-major ``matmul``s so they reach ``aten.mm``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.ops.attention import attention
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import apply_rope, rope_frequencies

MOE_SLICE = ("MoE layers (n_experts > 0) are a later slice of the "
             "PyTorch port (queue 1: MoE)")
INT8_SLICE = ("int8 weight trees are the quantized-serving slice of the "
              "PyTorch port, not ported yet")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: str | None = "llama3"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    attn_impl: str = "xla"            # "xla" | "flash" | "pallas"
    attn_block: int = 512
    remat: str = "full"               # "none" | "full" | "dots"
    z_loss: float = 1e-4
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_token(self, seq: int | None = None) -> float:
        """Approx model FLOPs per token (fwd+bwd = 3x fwd matmul FLOPs).
        With ``seq`` the causal attention-score FLOPs (QK^T and PV, avg
        context seq/2) are included. Remat recompute is not counted (it
        lowers reported MFU). For MoE only the top-k experts' FFN FLOPs
        are active per token."""
        d, m, v = self.dim, self.mlp_dim, self.vocab_size
        attn_proj = 2 * d * (self.n_heads + 2 * self.n_kv_heads) \
            * self.head_dim
        attn_out = 2 * self.n_heads * self.head_dim * d
        attn_score = (2 * seq * self.n_heads * self.head_dim) if seq else 0
        active_ffns = self.moe_top_k if self.n_experts else 1
        mlp = 2 * 3 * d * m * active_ffns
        per_layer = attn_proj + attn_out + attn_score + mlp
        return 3 * (self.n_layers * per_layer + 2 * d * v)


def llama3_8b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama_1b(**kw) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=32768, dim=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        mlp_dim=5632, max_seq=2048, tie_embeddings=True, **kw
    )


def llama_tiny(**kw) -> LlamaConfig:
    """CI config: runs on the CPU in seconds."""
    return LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        mlp_dim=128, max_seq=128, rope_scaling=None, tie_embeddings=True,
        **kw
    )


def check_dense(cfg: LlamaConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(MOE_SLICE)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device: DeviceLike = None, dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout on ``device``
    (``device.resolve_device``: CUDA unless ``"cpu"`` is asked for), drawn
    from ``generator``, which must live there too: N(0, 1/fan_in) for the
    matrices, ones for the norms. The draws differ from ``jax.random``'s;
    tests that compare the two packages convert one tree with
    ``interop.params_from_jax``."""
    check_dense(cfg)
    device = resolve_device(device)
    d, h, kv, hd, m, L = (cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.mlp_dim, cfg.n_layers)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(fan_in ** -0.5).to(dtype)

    layers = {
        "attn_norm": torch.ones((L, d), dtype=dtype, device=device),
        "mlp_norm": torch.ones((L, d), dtype=dtype, device=device),
        "wq": dense((L, d, h, hd), d),
        "wk": dense((L, d, kv, hd), d),
        "wv": dense((L, d, kv, hd), d),
        "wo": dense((L, h, hd, d), h * hd),
        "w_gate": dense((L, d, m), d),
        "w_up": dense((L, d, m), d),
        "w_down": dense((L, m, d), m),
    }
    params = {
        "embed": dense((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size), d)
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer weights (views)."""
    return {k: v[i] for k, v in params["layers"].items()}


def inv_freq_for(cfg: LlamaConfig, device) -> torch.Tensor:
    return torch.as_tensor(rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
        original_max_seq=cfg.max_seq), device=device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: LlamaConfig):
    if "embed_q" in params:
        raise NotImplementedError(INT8_SLICE)
    return params["embed"].to(cfg.dtype)[tokens.long()]


def _rows_mm(x, w, cfg: LlamaConfig):
    """x [..., K] times a weight whose leading dims flatten to K: one
    ``aten.mm`` over the flattened rows (the JAX einsums ``bsd,dhk->bshk``,
    ``bshk,hkd->bsd``, ``bsd,dm->bsm``); returns [..., *w's trailing]."""
    k = x.shape[-1]
    w2 = w.to(cfg.dtype).reshape(k, -1)
    return (x.reshape(-1, k) @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def qkv_proj(lp, h, cfg: LlamaConfig):
    """Attention input projections [B, S, D] -> q [B,S,H,hd], k/v
    [B,S,KV,hd]."""
    if "wq_q" in lp:
        raise NotImplementedError(INT8_SLICE)
    return (_rows_mm(h, lp["wq"], cfg), _rows_mm(h, lp["wk"], cfg),
            _rows_mm(h, lp["wv"], cfg))


def out_proj(lp, o, cfg: LlamaConfig):
    """[..., H, hd] -> [..., D]."""
    if "wo_q" in lp:
        raise NotImplementedError(INT8_SLICE)
    wo = lp["wo"]
    return _rows_mm(o.reshape(*o.shape[:-2], -1),
                    wo.reshape(-1, wo.shape[-1]), cfg)


def _ffn(h, lp, cfg: LlamaConfig):
    """Dense SwiGLU FFN on the normed input h -> delta."""
    check_dense(cfg)
    if "w_gate_q" in lp:
        raise NotImplementedError(INT8_SLICE)
    gate = _rows_mm(h, lp["w_gate"], cfg)
    up = _rows_mm(h, lp["w_up"], cfg)
    return _rows_mm(F.silu(gate) * up, lp["w_down"], cfg)


def lm_head_weight(params, cfg: LlamaConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(cfg.dtype)


def _block(x, lp, inv_freq, positions, cfg: LlamaConfig):
    """One transformer block on x [B, S, D] in the compute dtype."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = qkv_proj(lp, h, cfg)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    o = attention(q, k, v, causal=True, impl=cfg.attn_impl)
    x = x + out_proj(lp, o, cfg)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _ffn(h, lp, cfg)


def _save_weight_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots": keep the outputs of
    the weight products (``aten.mm``), recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: LlamaConfig):
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={cfg.remat!r} (want none|full|dots)")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)
    return lambda *args: checkpoint(fn, *args, **kw)


def forward(params, tokens, cfg: LlamaConfig, positions=None):
    """Full-sequence forward. tokens: [B, S] integer -> logits [B, S, V]
    float32."""
    check_dense(cfg)
    device = params["embed"].device
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=device)[None, :]
    inv_freq = inv_freq_for(cfg, device)
    x = embed_tokens(params, tokens, cfg)
    block = _remat_wrap(
        lambda x, lp: _block(x, lp, inv_freq, positions, cfg), cfg)
    # one unbind per stacked weight, not an index per layer: the backward
    # of unbind stacks the layers' gradients once, where indexing would
    # add a zero-filled full [L, ...] gradient into the leaf per layer
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i in range(cfg.n_layers):
        x = block(x, {k: v[i] for k, v in layers.items()})
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, lm_head_weight(params, cfg)).float()


# ---------------------------------------------------------------------------
# KV-cached prefill (serving path)
# ---------------------------------------------------------------------------

def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> dict:
    """Dense KV cache on ``device`` (``device.resolve_device``)."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(params, tokens, cfg: LlamaConfig, cache,
            lengths: Optional[torch.Tensor] = None):
    """Run the prompt through the model, filling ``cache`` IN PLACE (the
    JAX version returns a new cache; here the dense scratch cache is
    written where it lies).

    tokens: [B, S] left-aligned, right-padded. ``lengths`` ([B], default
    S) gives each prompt's true length: logits are read at position
    ``lengths-1`` and ``cache["len"]`` is set per sequence. Returns
    (logits [B, V] float32, cache).
    """
    check_dense(cfg)
    b, s = tokens.shape
    device = params["embed"].device
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    positions = torch.arange(s, device=device)[None, :]
    inv_freq = inv_freq_for(cfg, device)
    impl = cfg.attn_impl if cfg.attn_impl in ("xla", "flash", "pallas") \
        else "pallas"
    x = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = qkv_proj(lp, h, cfg)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        o = attention(q, k, v, causal=True, impl=impl)
        x = x + out_proj(lp, o, cfg)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(h, lp, cfg)
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last_idx = (lengths.long() - 1).clamp(min=0)
    last = x[torch.arange(b, device=device), last_idx]
    logits = torch.einsum("bd,dv->bv", last, lm_head_weight(params, cfg))
    cache["len"] = lengths.to(torch.int32)
    return logits.float(), cache

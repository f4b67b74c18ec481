"""Llama-3 model family in PyTorch (counterpart of
``kubeflow_tpu.models.llama``).

Parameters keep the JAX package's layout: a plain dict whose per-layer
weights are stacked on a leading ``layers`` axis (``wq [L, d, h, hd]``,
``wo [L, h, hd, d]``, ``w_gate [L, d, m]`` ...), so a tree converted by
``interop.params_from_jax`` drops straight in and every function here
takes the same arguments as its JAX counterpart. A Python loop over the
stacked layers takes the place of ``lax.scan``.

Compute runs in ``cfg.dtype`` with norms, RoPE and softmax in float32.
The port is dense: a config with ``n_experts > 0`` raises
``NotImplementedError`` naming the slice that brings it. The serving
functions also take the int8 weight trees of ``serving.quant.
quantize_weights`` (``wq_q`` + ``wq_s`` ...): ``qmm`` is their product.

Tensor parallelism (``mesh=``, a launched ``parallel.mesh.TensorMesh``;
None is the one-card path, unchanged): each rank holds its shard of the
tree (``param_logical_axes`` through ``parallel.sharding``) and the
serving functions are Megatron's column- and row-parallel products.
``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` are column-parallel (the
rank's heads, the rank's slice of the MLP), ``wo`` and ``w_down``
row-parallel (a partial product, then an all-reduce), the embedding a
masked lookup of the rank's vocab rows plus an all-reduce, and the LM
head the rank's vocab columns of the logits, all-gathered. Norms are
replicated.

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
from kubeflow_tpu_torch.parallel.sharding import shard_slices

MOE_SLICE = ("MoE layers (n_experts > 0) are a later slice of the "
             "PyTorch port (queue 1: MoE)")


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
                device: DeviceLike = None, dtype=torch.float32,
                mesh=None) -> dict:
    """Random parameters in the JAX layout on ``device``
    (``device.resolve_device``: CUDA unless ``"cpu"`` is asked for), drawn
    from ``generator``, which must live there too: N(0, 1/fan_in) for the
    matrices, ones for the norms. The draws differ from ``jax.random``'s;
    tests that compare the two packages convert one tree with
    ``interop.params_from_jax``.

    With ``mesh``, the rank's shard only: every matrix is drawn whole
    (one at a time, so the full tree never exists) and cut to the rank's
    slice, so the shards of a seed are exactly the slices of its
    unsharded tree."""
    device = resolve_device(device)
    shapes, axes = param_shapes(cfg), param_logical_axes(cfg)
    d, m, hd = cfg.dim, cfg.mlp_dim, cfg.n_heads * cfg.head_dim
    fan_in = {"wq": d, "wk": d, "wv": d, "wo": hd, "w_gate": d, "w_up": d,
              "w_down": m, "embed": d, "lm_head": d}

    def dense(shape, names, fan):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        if mesh is None:
            return w.mul_(fan ** -0.5).to(dtype)
        part = w[tuple(shard_slices(names, shape, mesh.rank, mesh.tp))]
        out = torch.empty(part.shape, dtype=dtype, device=device)
        return out.copy_(part.mul_(fan ** -0.5))

    def leaf(name, shape, names):
        if name not in fan_in:                       # the norms
            return torch.ones(shape, dtype=dtype, device=device)
        return dense(shape, names, fan_in[name])

    # the draw order (layers, then embed, then lm_head) fixes the values
    layers = {k: leaf(k, shp, axes["layers"][k])
              for k, shp in shapes["layers"].items()}
    params = {k: layers if k == "layers" else leaf(k, shapes[k], axes[k])
              for k in shapes}
    return params


@dataclasses.dataclass(frozen=True)
class SeededParams:
    """A parameter source for ``LLMEngine`` (``serving.llm.
    local_params``): ``init_params`` from a generator seeded ``seed`` on
    the rank's device, so each rank of a mesh draws only its shard."""

    seed: int
    dtype: Any = torch.float32

    def __call__(self, cfg: LlamaConfig, mesh, device):
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(self.seed)
        params = init_params(gen, cfg, device=device, dtype=self.dtype,
                             mesh=mesh)
        if device.type == "cuda":
            # hand the whole-tensor draws back: ranks sharing a card
            # allocate from the same memory
            torch.cuda.empty_cache()
        return params


def param_shapes(cfg: LlamaConfig) -> dict:
    """Each parameter's full shape, in ``init_params``' structure."""
    check_dense(cfg)
    d, h, kv, hd, m, L = (cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.mlp_dim, cfg.n_layers)
    shapes = {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "attn_norm": (L, d), "mlp_norm": (L, d),
            "wq": (L, d, h, hd), "wk": (L, d, kv, hd), "wv": (L, d, kv, hd),
            "wo": (L, h, hd, d),
            "w_gate": (L, d, m), "w_up": (L, d, m), "w_down": (L, m, d),
        },
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def param_logical_axes(cfg: LlamaConfig) -> dict:
    """Logical axis names per param, mirroring init_params' structure
    (the JAX package's ``param_logical_axes``, dense layers)."""
    check_dense(cfg)
    axes = {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "embed"),
            "mlp_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


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

def embed_tokens(params, tokens, cfg: LlamaConfig, mesh=None):
    """Embedding lookup, quant-aware: int8 tables dequant the gathered
    rows with their per-vocab-row scale (gathered first, so only those
    rows are upcast; int8 values are exact in any compute dtype).

    With ``mesh`` the table is the rank's vocab rows: tokens outside
    them give zero rows, and the all-reduce adds each token's one
    nonzero row (exactly)."""
    tokens = tokens.long()
    if mesh is not None:
        n = (params["embed_q"] if "embed_q" in params
             else params["embed"]).shape[0]
        local = tokens - mesh.rank * n
        hit = (local >= 0) & (local < n)
        tokens = torch.where(hit, local, 0)
    if "embed_q" in params:
        rows = params["embed_q"][tokens].to(cfg.dtype)
        rows = rows * params["embed_s"][tokens].to(cfg.dtype)[..., None]
    else:
        rows = params["embed"].to(cfg.dtype)[tokens]
    if mesh is None:
        return rows
    return mesh.all_reduce(torch.where(hit[..., None], rows, 0))


def _rows_mm(x, w, cfg: LlamaConfig):
    """x [..., K] times a weight whose leading dims flatten to K: one
    ``aten.mm`` over the flattened rows (the JAX einsums ``bsd,dhk->bshk``,
    ``bshk,hkd->bsd``, ``bsd,dm->bsm``); returns [..., *w's trailing]."""
    k = x.shape[-1]
    w2 = w.to(cfg.dtype).reshape(k, -1)
    return (x.reshape(-1, k) @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def qmm(x, w_q, w_s, cfg: LlamaConfig):
    """``_rows_mm`` over an int8-quantized weight (``w_q`` int8, ``w_s``
    f32 per-output-channel scales): the product over the int8 tensor
    upcast to the compute dtype, then the OUTPUT multiplied by the scales
    in the compute dtype, in that order (the JAX package's ``qmm``). The
    upcast is a dense copy per use: 3 more bytes read per weight than the
    1 the int8 tensor holds."""
    return _rows_mm(x, w_q, cfg) * w_s.to(cfg.dtype)


def qkv_proj(lp, h, cfg: LlamaConfig):
    """Attention input projections [B, S, D] -> q [B,S,H,hd], k/v
    [B,S,KV,hd]; int8 layer trees (``wq_q`` present) go through qmm.
    Column-parallel under a mesh as it stands: a rank's weights hold its
    heads, so H and KV are the rank's."""
    if "wq_q" in lp:
        return tuple(qmm(h, lp[n + "_q"], lp[n + "_s"], cfg)
                     for n in ("wq", "wk", "wv"))
    return (_rows_mm(h, lp["wq"], cfg), _rows_mm(h, lp["wk"], cfg),
            _rows_mm(h, lp["wv"], cfg))


def _reduced(x, mesh):
    """A row-parallel product's partial sums, all-reduced under a mesh."""
    return x if mesh is None else mesh.all_reduce(x)


def out_proj(lp, o, cfg: LlamaConfig, mesh=None):
    """[..., H, hd] -> [..., D]. Row-parallel under a mesh: the rank's
    heads give a partial product (int8: already times the replicated
    per-output-channel scales, which factor out of the sum), then the
    all-reduce."""
    o = o.reshape(*o.shape[:-2], -1)
    if "wo_q" in lp:
        wo_q = lp["wo_q"]
        out = qmm(o, wo_q.reshape(-1, wo_q.shape[-1]), lp["wo_s"], cfg)
    else:
        wo = lp["wo"]
        out = _rows_mm(o, wo.reshape(-1, wo.shape[-1]), cfg)
    return _reduced(out, mesh)


def _ffn(h, lp, cfg: LlamaConfig, mesh=None):
    """Dense SwiGLU FFN on the normed input h -> delta. Under a mesh the
    gate/up products are the rank's MLP columns and the down product is
    row-parallel, then all-reduced."""
    check_dense(cfg)
    if "w_gate_q" in lp:
        gate = qmm(h, lp["w_gate_q"], lp["w_gate_s"], cfg)
        up = qmm(h, lp["w_up_q"], lp["w_up_s"], cfg)
        out = qmm(F.silu(gate) * up, lp["w_down_q"], lp["w_down_s"], cfg)
    else:
        gate = _rows_mm(h, lp["w_gate"], cfg)
        up = _rows_mm(h, lp["w_up"], cfg)
        out = _rows_mm(F.silu(gate) * up, lp["w_down"], cfg)
    return _reduced(out, mesh)


def lm_head_weight(params, cfg: LlamaConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(cfg.dtype)


def _gathered(logits, mesh):
    """The ranks' vocab columns of the logits, concatenated in rank
    order (each rank holds every logit after it)."""
    return logits if mesh is None else mesh.all_gather(logits, dim=-1)


def quant_head_logits(params, x, cfg: LlamaConfig, mesh=None):
    """LM-head product over the int8 tree: tied embeddings reuse the
    embedding table (its per-vocab-ROW scales become per-output-channel
    scales of the transposed head); untied heads carry their own
    per-vocab-channel scales. x: [..., D] -> [..., V] compute dtype.
    Under a mesh: the rank's vocab columns, then the all-gather."""
    if cfg.tie_embeddings:
        out = x @ params["embed_q"].T.to(cfg.dtype)
        out = out * params["embed_s"].to(cfg.dtype)
    else:
        out = x @ params["lm_head_q"].to(cfg.dtype)
        out = out * params["lm_head_s"].to(cfg.dtype)
    return _gathered(out, mesh)


def head_logits(params, x, cfg: LlamaConfig, mesh=None):
    """The LM head on the final-normed x [..., D] -> [..., V] in the
    compute dtype, for full-precision and int8 trees alike (under a
    mesh, every rank gets all V logits)."""
    if "embed_q" in params:
        return quant_head_logits(params, x, cfg, mesh)
    return _gathered(
        torch.einsum("...d,dv->...v", x, lm_head_weight(params, cfg)), mesh)


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
               device: DeviceLike = None, mesh=None) -> dict:
    """Dense KV cache on ``device`` (``device.resolve_device``); under a
    mesh, of the rank's KV heads."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    kv = cfg.n_kv_heads // (mesh.tp if mesh is not None else 1)
    shape = (cfg.n_layers, batch, max_len, kv, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(params, tokens, cfg: LlamaConfig, cache,
            lengths: Optional[torch.Tensor] = None, mesh=None):
    """Run the prompt through the model, filling ``cache`` IN PLACE (the
    JAX version returns a new cache; here the dense scratch cache is
    written where it lies). Under ``mesh``: the rank's shard, heads and
    cache (see the module docstring).

    tokens: [B, S] left-aligned, right-padded. ``lengths`` ([B], default
    S) gives each prompt's true length: logits are read at position
    ``lengths-1`` and ``cache["len"]`` is set per sequence. Returns
    (logits [B, V] float32, cache).
    """
    check_dense(cfg)
    b, s = tokens.shape
    device = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    positions = torch.arange(s, device=device)[None, :]
    inv_freq = inv_freq_for(cfg, device)
    impl = cfg.attn_impl if cfg.attn_impl in ("xla", "flash", "pallas") \
        else "pallas"
    x = embed_tokens(params, tokens, cfg, mesh)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = qkv_proj(lp, h, cfg)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        o = attention(q, k, v, causal=True, impl=impl)
        x = x + out_proj(lp, o, cfg, mesh)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(h, lp, cfg, mesh)
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last_idx = (lengths.long() - 1).clamp(min=0)
    last = x[torch.arange(b, device=device), last_idx]
    logits = head_logits(params, last, cfg, mesh)
    cache["len"] = lengths.to(torch.int32)
    return logits.float(), cache

"""Llama-3 model family in PyTorch (counterpart of
``kubeflow_tpu.models.llama``).

Parameters keep the JAX package's layout: a plain dict whose per-layer
weights are stacked on a leading ``layers`` axis (``wq [L, d, h, hd]``,
``wo [L, h, hd, d]``, ``w_gate [L, d, m]`` ...), so a tree converted by
``interop.params_from_jax`` drops straight in and every function here
takes the same arguments as its JAX counterpart. A Python loop over the
stacked layers takes the place of ``lax.scan``.

Compute runs in ``cfg.dtype`` with norms, RoPE and softmax in float32.
A config with ``n_experts > 0`` is Mixtral-style MoE: its layers hold
``moe_router [L, d, E]`` and expert stacks ``w_gate``/``w_up [L, E, d,
m]``, ``w_down [L, E, m, d]``, and the FFN is ``parallel.moe.
moe_layer``; ``forward(..., return_aux=True)`` also returns the summed
MoE penalties. The serving functions also take the int8 weight trees of
``serving.quant.quantize_weights`` (``wq_q`` + ``wq_s`` ...): ``qmm`` is
their product.

Serving meshes (``mesh=``, a launched ``parallel.mesh.TensorMesh`` of
``expert`` x ``tensor`` ranks; None is the one-card path, unchanged):
each rank holds its shard of the tree (``param_logical_axes`` through
``parallel.sharding``) and the serving functions are Megatron's column-
and row-parallel products over the rank's ``tensor`` group (the ranks of
its expert index). ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` are
column-parallel (the rank's heads, the rank's slice of the MLP), ``wo``
and ``w_down`` row-parallel (a partial product, then an all-reduce over
``tensor``), the embedding a masked lookup of the rank's vocab rows plus
an all-reduce over ``tensor``, and the LM head the rank's vocab columns
of the logits, all-gathered over ``tensor``. Norms are replicated, and
so is everything but the experts over ``expert``: under ``expert``
alone attention and a dense FFN run whole on every rank with no
collective. An MoE layer's rank holds the ``mlp`` slice of its experts
(the router whole): it routes every token as every rank does, runs its
slice of its experts (``parallel.moe.moe_layer`` with the mesh as its
world), and the output is all-reduced over the whole mesh.

In training the same cuts run over a ``parallel.mesh.WorldMesh``'s
``tensor`` axis, through the autograd-aware collectives of
``parallel/tensor.py``: ``forward`` takes the world from the parameters
it is given (a rank's ``parallel.tensor.TensorParams``, or its
``parallel.fsdp.FsdpParams``) and hands it to ``_block`` and the head
(``tp``): ``copy`` before the column-parallel products and the head,
``reduce`` after the row-parallel ones, the embedding a masked lookup
plus ``reduce``, and the logits all-gathered along vocab before the
loss. Each rank runs attention on its own heads. An MoE FFN gets the
world itself (``parallel.moe.moe_layer``): its router statistics,
capacity and slots are the global batch's, and under ``expert`` and
``tensor`` the rank runs its experts' ``mlp`` slices and joins its
peers' outputs.

Context parallelism (``attn_impl="ring"`` or ``"ulysses"``, the JAX
package's ``attn_impl`` values): ``forward(..., mesh=)`` takes the
training world (``parallel.mesh.WorldMesh``; by default the one the
parameters carry), each rank runs its chunk of every row's tokens, at
their global positions by default (``c * Sl + arange(Sl)``, so RoPE sees
what the JAX package's sharded sequence sees), and attention joins the
chunks over the ``context`` axis (``parallel/ring_attention.py``) on the
rank's heads. Without a world these impls raise as the JAX model does;
a world whose ``context`` axis cuts the sequence raises for any other
impl, which would attend within the rank's chunk alone. Serving's
prefill runs them as the flash path (as the JAX ``prefill`` does).

``forward`` honours ``cfg.remat`` while autograd records: "none" keeps
every activation, "full" recomputes each block in backward
(``torch.utils.checkpoint``), and "dots" saves only the weight products
(``aten.mm``: the projections have no batch dims once flattened to rows)
and recomputes everything else, the flash-attention forward included
(the ring's with its shifts) -- the JAX package's
``checkpoint_dots_with_no_batch_dims``. The weight
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
from kubeflow_tpu_torch.parallel import moe, tensor
from kubeflow_tpu_torch.parallel.fsdp import FsdpParams
from kubeflow_tpu_torch.parallel.ring_attention import (
    ring_attention, ulysses_attention,
)
from kubeflow_tpu_torch.parallel.sharding import shard_slices


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
    # "xla" | "flash" | "pallas" | "ring" | "ulysses" (the last two over
    # a training world's context axis)
    attn_impl: str = "xla"
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

    def moe_config(self) -> moe.MoEConfig:
        return moe.MoEConfig(
            dim=self.dim, mlp_dim=self.mlp_dim, n_experts=self.n_experts,
            top_k=self.moe_top_k, capacity_factor=self.moe_capacity_factor,
            dtype=self.dtype)


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


def llama_moe_8x(base: LlamaConfig | None = None, n_experts: int = 8,
                 **kw) -> LlamaConfig:
    """Mixtral-style MoE variant of any base config (default 8 experts)."""
    base = base or llama3_8b()
    return dataclasses.replace(base, n_experts=n_experts, **kw)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

# the layer weights of an MoE FFN (the dense FFN's names, stacked per
# expert, plus the router)
MOE_KEYS = ("moe_router", "w_gate", "w_up", "w_down")

def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device: DeviceLike = None, dtype=torch.float32,
                mesh=None) -> dict:
    """Random parameters in the JAX layout on ``device``
    (``device.resolve_device``: CUDA unless ``"cpu"`` is asked for), drawn
    from ``generator``, which must live there too: N(0, 1/fan_in) for the
    matrices, ones for the norms. The draws differ from ``jax.random``'s;
    tests that compare the two packages convert one tree with
    ``interop.params_from_jax``. MoE expert stacks (and the router) are
    drawn one (layer, expert) matrix at a time straight into ``dtype``
    (``parallel.moe.randn_stack``): a whole stack drawn in float32 at
    Mixtral's widths would be a 30 GB temporary.

    With ``mesh``, the rank's shard only: every matrix is drawn whole
    (one at a time, so the full tree never exists) and cut to the rank's
    slice, so the shards of a seed are exactly the slices of its
    unsharded tree (for MoE, of each expert's ``mlp`` dim)."""
    device = resolve_device(device)
    shapes, axes = param_shapes(cfg), param_logical_axes(cfg)
    d, m, hd = cfg.dim, cfg.mlp_dim, cfg.n_heads * cfg.head_dim
    fan_in = {"wq": d, "wk": d, "wv": d, "wo": hd, "w_gate": d, "w_up": d,
              "w_down": m, "embed": d, "lm_head": d, "moe_router": d}

    def dense(shape, names, fan):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        if mesh is None:
            return w.mul_(fan ** -0.5).to(dtype)
        part = w[tuple(shard_slices(names, shape, mesh.rank, mesh.tp,
                                    mesh.ep))]
        out = torch.empty(part.shape, dtype=dtype, device=device)
        return out.copy_(part.mul_(fan ** -0.5))

    def leaf(name, shape, names):
        if name not in fan_in:                       # the norms
            return torch.ones(shape, dtype=dtype, device=device)
        if cfg.n_experts and name in MOE_KEYS:
            part = None if mesh is None else tuple(
                shard_slices(names, shape, mesh.rank, mesh.tp, mesh.ep))
            return moe.randn_stack(generator, shape, fan_in[name], dtype,
                                   device, part)
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
    d, h, kv, hd, m, L = (cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.mlp_dim, cfg.n_layers)
    layers = {
        "attn_norm": (L, d), "mlp_norm": (L, d),
        "wq": (L, d, h, hd), "wk": (L, d, kv, hd), "wv": (L, d, kv, hd),
        "wo": (L, h, hd, d),
    }
    if cfg.n_experts:
        e = cfg.n_experts
        layers.update({"moe_router": (L, d, e), "w_gate": (L, e, d, m),
                       "w_up": (L, e, d, m), "w_down": (L, e, m, d)})
    else:
        layers.update({"w_gate": (L, d, m), "w_up": (L, d, m),
                       "w_down": (L, m, d)})
    shapes = {"embed": (cfg.vocab_size, d), "layers": layers,
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def param_logical_axes(cfg: LlamaConfig) -> dict:
    """Logical axis names per param, mirroring init_params' structure
    (the JAX package's ``param_logical_axes``)."""
    layers = {
        "attn_norm": ("layers", "embed"),
        "mlp_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
    }
    if cfg.n_experts:
        layers.update({
            "moe_router": ("layers", "embed", None),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        })
    else:
        layers.update({
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    axes = {"embed": ("vocab", "embed"), "layers": layers,
            "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer weights (views)."""
    return {k: v[i] for k, v in params["layers"].items()}


def inv_freq_for(cfg: LlamaConfig, device) -> torch.Tensor:
    """RoPE inverse frequencies of ``cfg`` on ``device``: made once per
    (frequency parameters, device) and kept, so a step never copies them
    from host memory (a decode step captured as a CUDA graph must not).
    The tensor is shared; callers only read it."""
    return _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                     cfg.max_seq, torch.device(device))


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, scaling, max_seq: int,
              device: torch.device) -> torch.Tensor:
    return torch.as_tensor(rope_frequencies(
        head_dim, theta, scaling, original_max_seq=max_seq), device=device)


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
        tokens, hit = tensor.local_tokens(
            tokens, mesh.axis_index("tensor"), n)
    if "embed_q" in params:
        rows = params["embed_q"][tokens].to(cfg.dtype)
        rows = rows * params["embed_s"][tokens].to(cfg.dtype)[..., None]
    else:
        rows = params["embed"].to(cfg.dtype)[tokens]
    if mesh is None:
        return rows
    return mesh.all_reduce(torch.where(hit[..., None], rows, 0), "tensor")


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
    """A row-parallel product's partial sums, all-reduced over the
    mesh's ``tensor`` group (the ranks of one expert index)."""
    return x if mesh is None else mesh.all_reduce(x, "tensor")


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


def _ffn(h, lp, cfg: LlamaConfig, mesh=None, token_mask=None, world=None):
    """FFN half of a block on the normed input h -> (delta, aux): the dense
    SwiGLU FFN with aux 0.0, or for MoE configs the routed mixture
    (``parallel.moe.moe_layer``) with its summed penalties (a float32
    0-d tensor). ``token_mask`` [B, S] bool: the serving paths keep pad
    and idle rows out of MoE routing. Under a serving ``mesh`` the gate
    and up products are the rank's MLP columns and the down product is
    row-parallel: a dense FFN (replicated over ``expert``) sums over
    ``tensor``; the MoE layer, whose rank holds its experts' columns,
    joins the mesh itself as a training world's layer joins its world,
    its output summed over the whole mesh. ``world``: a training world,
    which the MoE layer joins itself (its rows, experts and slices;
    ``_block`` joins the dense FFN's)."""
    if cfg.n_experts:
        moe_params = {"router": lp["moe_router"], "w_gate": lp["w_gate"],
                      "w_up": lp["w_up"], "w_down": lp["w_down"]}
        y, aux = moe.moe_layer(moe_params, h, cfg.moe_config(),
                               token_mask=token_mask,
                               world=world if world is not None else mesh)
        return y, moe.moe_aux_total(aux)
    if "w_gate_q" in lp:
        gate = qmm(h, lp["w_gate_q"], lp["w_gate_s"], cfg)
        up = qmm(h, lp["w_up_q"], lp["w_up_s"], cfg)
        out = qmm(F.silu(gate) * up, lp["w_down_q"], lp["w_down_s"], cfg)
    else:
        gate = _rows_mm(h, lp["w_gate"], cfg)
        up = _rows_mm(h, lp["w_up"], cfg)
        out = _rows_mm(F.silu(gate) * up, lp["w_down"], cfg)
    return _reduced(out, mesh), 0.0


def lm_head_weight(params, cfg: LlamaConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(cfg.dtype)


def _gathered(logits, mesh):
    """The vocab columns of the logits of the rank's ``tensor`` group,
    concatenated in rank order (each rank holds every logit after it)."""
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


CONTEXT_IMPLS = {"ring": ring_attention, "ulysses": ulysses_attention}


def _attention(q, k, v, cfg: LlamaConfig, world):
    """The block's causal attention by ``cfg.attn_impl`` (module
    docstring): over the world's ``context`` axis for "ring" and
    "ulysses", else ``ops.attention.attention``."""
    if cfg.attn_impl in CONTEXT_IMPLS:
        if world is None:
            raise ValueError(f"attn_impl={cfg.attn_impl!r} requires mesh=")
        return CONTEXT_IMPLS[cfg.attn_impl](q, k, v, world, causal=True)
    if tensor.on(world, "context"):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} over context="
            f"{world.axis_size('context')}: a rank holds one chunk of the "
            "sequence, which this impl would attend within; use ring or "
            "ulysses")
    return attention(q, k, v, causal=True, impl=cfg.attn_impl)


def _block(x, lp, inv_freq, positions, cfg: LlamaConfig, tp=None):
    """One transformer block on x [B, S, D] in the compute dtype ->
    (x, the layer's MoE aux: 0.0 for a dense layer). ``tp``: the
    training world whose ``tensor`` (and ``expert``) axes cut ``lp``
    and whose ``context`` axis cuts the sequence (module docstring), or
    None."""
    h = tensor.copy(rms_norm(x, lp["attn_norm"], cfg.norm_eps), tp)
    q, k, v = qkv_proj(lp, h, cfg)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    o = _attention(q, k, v, cfg, tp)
    x = x + tensor.reduce(out_proj(lp, o, cfg), tp)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts:
        # the MoE layer joins its peers itself (parallel/moe.py)
        delta, aux = _ffn(h, lp, cfg, world=tp)
        return x + delta, aux
    delta, aux = _ffn(tensor.copy(h, tp), lp, cfg)
    return x + tensor.reduce(delta, tp), aux


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
    # the blocks draw no random numbers, so there is no RNG state to
    # stash and restore for the recompute (stashing the CUDA generator's
    # state is not allowed while a CUDA graph captures the step)
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)
    return lambda *args: checkpoint(fn, *args, **kw)


def _weights(params):
    """(the weights outside the layers, ``i`` -> layer ``i``'s weights,
    the training world that holds them or None): the layer loop's
    accessor. A tree's layers come from one unbind per stacked weight,
    not an index per layer: the backward of unbind stacks the layers'
    gradients once, where indexing would add a zero-filled full
    [L, ...] gradient into the leaf per layer. A rank's
    ``parallel.fsdp.FsdpParams`` gathers the rest once and each layer
    (its expert and tensor slice) when it is asked for; a
    ``parallel.tensor.TensorParams`` holds the rank's slices."""
    if isinstance(params, FsdpParams):
        return params.gather(None), params.gather, params.world
    tp = None
    if isinstance(params, tensor.TensorParams):
        params, tp = params.tree, params.mesh
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    return params, lambda i: {k: v[i] for k, v in layers.items()}, tp


def forward(params, tokens, cfg: LlamaConfig, positions=None, mesh=None,
            return_aux: bool = False):
    """Full-sequence forward. tokens: [B, S] integer -> logits [B, S, V]
    float32. With ``return_aux``, (logits, {"moe_aux": the MoE penalties
    summed over the layers, float32 0-d; 0 for dense configs}): the
    training loss adds it.

    ``params`` is a tree, or under ``fsdp`` a rank's
    ``parallel.fsdp.FsdpParams``: the embedding, the final norm and the
    head are gathered once (the tied embedding serves the lookup and the
    head, and autograd sums both gradients before its reduce-scatter),
    and each layer's weights inside its block, so that remat "full" and
    "dots" gather them again when the backward recomputes the block
    rather than keep them. Under remat "none" the gathered weights are
    saved for the backward like any activation, and live until it.

    Over a world (``params`` a ``parallel.tensor.TensorParams``, or
    ``FsdpParams``, or ``mesh``, the JAX argument: a
    ``parallel.mesh.WorldMesh``) every rank gets the whole logits of its
    rows (module docstring), under ``context`` those of its chunk of
    their tokens, and an MoE layer's aux is the global batch's; the
    block's forward collectives run again when remat recomputes it."""
    top, layer, tp = _weights(params)
    tp = mesh if mesh is not None else tp
    device = top["embed"].device
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=device)[None, :]
        if tensor.on(tp, "context"):
            positions = positions + tp.axis_index("context") \
                * tokens.shape[1]
    inv_freq = inv_freq_for(cfg, device)
    x = (tensor.vocab_lookup(top["embed"], tokens, tp, cfg.dtype)
         if tensor.on(tp) else embed_tokens(top, tokens, cfg))
    block = _remat_wrap(
        lambda x, i: _block(x, layer(i), inv_freq, positions, cfg, tp), cfg)
    auxes = []
    for i in range(cfg.n_layers):
        x, aux = block(x, i)
        auxes.append(aux)
    x = tensor.copy(rms_norm(x, top["final_norm"], cfg.norm_eps), tp)
    logits = tensor.gather_vocab(
        torch.einsum("bsd,dv->bsv", x, lm_head_weight(top, cfg)), tp).float()
    if not return_aux:
        return logits
    total = (torch.stack(auxes).sum() if cfg.n_experts
             else torch.zeros((), dtype=torch.float32, device=device))
    return logits, {"moe_aux": total}


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
    ``lengths-1`` and ``cache["len"]`` is set per sequence; positions at
    or past it do not route through MoE experts. Returns (logits [B, V]
    float32, cache).
    """
    b, s = tokens.shape
    device = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    positions = torch.arange(s, device=device)[None, :]
    real = positions < lengths[:, None]
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
        x = x + _ffn(h, lp, cfg, mesh, token_mask=real)[0]
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last_idx = (lengths.long() - 1).clamp(min=0)
    last = x[torch.arange(b, device=device), last_idx]
    logits = head_logits(params, last, cfg, mesh)
    cache["len"] = lengths.to(torch.int32)
    return logits.float(), cache

"""Pipeline-parallel Llama in training (counterpart of the SPMD half of
``kubeflow_tpu.parallel.pipeline_llama``).

The layer weights ``[L, ...]`` are re-stacked ``[S, L/S, ...]`` under
``"stages"`` (``to_pipeline_params``), whose leading ``pipe_stage`` dim
the ``pipeline`` axis cuts (``pipeline_param_logical_axes``): over a
training world (``parallel.mesh.WorldMesh``) a rank keeps its stage,
``[1, L/S, ...]``, and the embedding, the final norm and the head
whole. ``pipeline_forward`` runs the embedding outside the pipeline, each
stage's layers as a loop of ``models/llama._block`` under its remat
(``pipeline.pipeline_apply``), and the final norm and the head outside
it on the outputs every pipeline rank receives, as the JAX function does.

Where the JAX program runs the embedding and the head on every pipeline
device, a rank here runs the lookup only where its output is read (stage
0), and the trainer's loss (``pipeline_lm_loss_fn``) runs the head and
the loss on the last stage alone and hands every rank that loss
(``pipeline.from_last``: the others then hold no logits). So a
replicated leaf's gradient is the lookup's on stage 0 and the head's on
the last stage, and their sum over ``pipeline`` (the trainer's,
``training/trainer.py``) is JAX's gradient, counted once, the same bytes
on every pipeline rank. ``pipeline_forward`` (logits on every rank) is
for inference: it runs the head on every rank, as JAX's does.

Under ``tensor`` a stage's blocks take the rank's slices through
``parallel/tensor.py``'s collectives; under ``fsdp`` (the rank's
``parallel.fsdp.FsdpParams`` of its stage) each layer is gathered inside
its remat block; an MoE layer joins its peers over the world
(``parallel.moe.moe_layer``): the router's statistics and capacity are
those of one pipeline micro batch, as the JAX layer's are. ``attn_impl``
"ring" or "ulysses" raises the JAX function's ValueError (its blocks get
no mesh).

The MPMD half of the JAX module (``mpmd_model_config``,
``MpmdLlamaSpec``, ``run_mpmd_llama_oracle``) is a later slice.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.ops.losses import softmax_cross_entropy
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.parallel import tensor
from kubeflow_tpu_torch.parallel.fsdp import FsdpParams
from kubeflow_tpu_torch.parallel.pipeline import (
    STAGES, _tree_map, from_last, pipeline_apply,
)


def to_pipeline_params(params: dict, n_stages: int) -> dict:
    """Re-stack layer params ``[L, ...]`` -> stages ``[n_stages,
    L/n_stages, ...]`` (views); the embedding, the final norm and the
    head stay top-level. ValueError when ``n_stages`` does not divide
    L."""
    first = params["layers"][sorted(params["layers"])[0]]
    n_layers = first.shape[0]
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by "
                         f"n_stages={n_stages}")
    stages = _tree_map(lambda a: a.reshape(
        (n_stages, n_layers // n_stages) + tuple(a.shape[1:])),
        params["layers"])
    out = {k: v for k, v in params.items() if k != "layers"}
    out[STAGES] = stages
    return out


def init_pipeline_params(generator: torch.Generator, cfg: llama.LlamaConfig,
                         n_stages: int, device=None,
                         dtype=torch.float32) -> dict:
    """``llama.init_params`` from ``generator`` (the whole tree, so it
    equals the plain tree of the same seed), re-stacked into
    ``n_stages`` stages."""
    return to_pipeline_params(
        llama.init_params(generator, cfg, device=device, dtype=dtype),
        n_stages)


def pipeline_param_logical_axes(cfg: llama.LlamaConfig) -> dict:
    """Logical axes of the pipelined tree: each layer leaf gains a
    leading ``pipe_stage`` axis (rule: the ``pipeline`` mesh axis)."""
    base = llama.param_logical_axes(cfg)
    out = {k: v for k, v in base.items() if k != "layers"}
    out[STAGES] = {k: ("pipe_stage",) + tuple(v)
                     for k, v in base["layers"].items()}
    return out


def _stage_weights(params):
    """(the weights outside the layers, ``i`` -> the stage's layer ``i``,
    the stage's number of layers, the world that holds them or None),
    as ``llama._weights`` gives them: one unbind of the rank's stage
    ``[1, L/S, ...]``, or its ``FsdpParams``' gathers."""
    if isinstance(params, FsdpParams):
        return (params.gather(None), params.gather, params.n_layers,
                params.world)
    world = None
    if isinstance(params, tensor.TensorParams):
        params, world = params.tree, params.mesh
    stages = params[STAGES]
    leads = {int(v.shape[0]) for v in stages.values()}
    if leads != {1}:
        raise ValueError(f"a rank runs one stage: its stage leaves lead "
                         f"with a dim of 1, not {sorted(leads)} (over a "
                         "world, the trainer keeps the rank's stage)")
    layers = {k: v.squeeze(0).unbind(0) for k, v in stages.items()}
    n = len(next(iter(layers.values())))
    return params, lambda i: {k: v[i] for k, v in layers.items()}, n, world


def _hidden(params, tokens, cfg: llama.LlamaConfig, world, microbatches: int,
            axis: str):
    """The pipelined forward up to the final norm (``pipeline_forward``):
    (the last stage's outputs ``[B, S, D]``, on every pipeline rank; the
    MoE penalties; the weights outside the layers; the world; whether
    this rank is the last stage)."""
    if cfg.attn_impl in llama.CONTEXT_IMPLS:
        raise ValueError(f"attn_impl={cfg.attn_impl!r} requires mesh=")
    top, layer, n_layers, held = _stage_weights(params)
    world = world if world is not None else held
    n = world.axis_size(axis) if world is not None else 1
    stage = world.axis_index(axis) if world is not None else 0
    device = top["embed"].device
    b, s = tokens.shape
    positions = torch.arange(s, device=device)[None, :]
    inv_freq = llama.inv_freq_for(cfg, device)
    if stage == 0:
        x = (tensor.vocab_lookup(top["embed"], tokens, world, cfg.dtype)
             if tensor.on(world) else llama.embed_tokens(top, tokens, cfg))
    else:
        # only stage 0 reads the pipeline's input
        x = torch.zeros((b, s, cfg.dim), dtype=cfg.dtype, device=device)
    block = llama._remat_wrap(lambda x, i: llama._block(
        x, layer(i), inv_freq, positions, cfg, world), cfg)
    moe = bool(cfg.n_experts)

    def stage_fn(_, x):
        auxes = []
        for i in range(n_layers):
            x, aux = block(x, i)
            auxes.append(aux)
        return (x, torch.stack(auxes).sum()) if moe else x

    out = pipeline_apply(stage_fn, world, axis=axis,
                         microbatches=microbatches, stage_aux=moe)(None, x)
    y, moe_aux = out if moe else (out, torch.zeros(
        (), dtype=torch.float32, device=device))
    return y, moe_aux, top, world, stage == n - 1


def _head(top, y, cfg: llama.LlamaConfig, world):
    """The final norm and the head: logits ``[B, S, V]`` float32, whole
    on every tensor rank."""
    h = tensor.copy(rms_norm(y, top["final_norm"], cfg.norm_eps), world)
    return tensor.gather_vocab(torch.einsum(
        "bsd,dv->bsv", h, llama.lm_head_weight(top, cfg)), world).float()


def pipeline_forward(params, tokens, cfg: llama.LlamaConfig, world=None, *,
                     microbatches: int, axis: str = "pipeline"):
    """Pipelined full-sequence forward: tokens ``[B, S]`` -> (logits
    ``[B, S, V]`` float32, ``{"moe_aux": the MoE penalties, float32
    0-d}``), on every pipeline rank. B must divide by ``microbatches``.
    ``params``: the rank's stage tree (``[1, L/S, ...]`` leaves under
    ``"stages"``), ``parallel.tensor.TensorParams`` of it, or its
    ``parallel.fsdp.FsdpParams``; ``world`` defaults to the one they
    carry (None: one process, one stage). Every rank runs the head, as
    JAX's function does; the trainer's loss is ``pipeline_lm_loss_fn``,
    whose head runs on the last stage alone."""
    y, moe_aux, top, world, _ = _hidden(params, tokens, cfg, world,
                                        microbatches, axis)
    return _head(top, y, cfg, world), {"moe_aux": moe_aux}


def pipeline_lm_loss_fn(cfg: llama.LlamaConfig, world=None, *,
                        microbatches: int, axis: str = "pipeline"):
    """Next-token LM loss of the pipelined model (the trainer's
    ``loss_fn(params, batch) -> (loss, metrics)``): ``lm_loss_fn``'s
    loss, masks and ``tokens`` metric (over a world, the rank's mask sum
    unclamped), plus the MoE penalties for MoE configs (``moe_aux``).
    The last stage runs the head and the loss on its outputs, and every
    pipeline rank gets that loss (``pipeline.from_last``): the JAX
    function's value on each, with the head's work and its logits on one
    rank."""
    moe = bool(getattr(cfg, "n_experts", 0))

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        y, moe_aux, top, held, last = _hidden(params, inputs, cfg, world,
                                              microbatches, axis)
        mask = batch.get("mask")
        mask = mask[:, 1:] if mask is not None else None
        if last:
            loss, _ = softmax_cross_entropy(
                _head(top, y, cfg, held), targets, mask,
                z_loss=getattr(cfg, "z_loss", 0.0))
        if held is not None and held.axis_size(axis) > 1:
            loss = from_last(loss if last else ((), torch.float32), y, held,
                             axis)
        count = (mask.float().sum() if mask is not None else torch.full(
            (), float(targets.numel()), device=targets.device))
        metrics = {"tokens": count if held is not None
                   else count.clamp_min(1.0)}
        if moe:
            loss = loss + moe_aux
            metrics["moe_aux"] = moe_aux.detach()
        return loss, metrics

    return loss_fn


def pipeline_training(cfg: llama.LlamaConfig, world, init, *,
                      microbatches: int):
    """(init, loss_fn, logical axes) of the trainer of ``cfg`` over
    ``world``'s ``pipeline`` axis: ``init(generator)``'s plain tree
    re-stacked into the axis's stages, ``pipeline_lm_loss_fn`` over
    ``microbatches`` pipeline micro batches, and
    ``pipeline_param_logical_axes``."""
    n_stages = world.axis_size("pipeline")
    return (lambda g: to_pipeline_params(init(g), n_stages),
            pipeline_lm_loss_fn(cfg, world, microbatches=microbatches),
            pipeline_param_logical_axes(cfg))

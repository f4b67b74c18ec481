"""Quantized serving: config resolution + int8 weight quantization
(counterpart of ``kubeflow_tpu.serving.quant``).

Two quantization surfaces, both configured by ``QuantConfig``
(serving/scheduler.py) and both with a hard exact-parity escape hatch:

- **Paged-KV pools** (int8 or fp8 e4m3): storage and per-block
  per-kv-head scales live in serving/paged_kv.py; the dequant is fused
  into the paged decode kernel's inner loop
  (``csrc/paged_decode_attention.cu`` through ops/paged_attention.py)
  and, identically, into the gather oracle's view.
- **Weights** (int8, per-output-channel scales): quantized ONCE here on
  the engine's build path; the matmul call sites (models/llama.py) read
  the int8 tensor, upcast it to the compute dtype for the product, and
  multiply the OUTPUT by the channel scales.

Under a tensor-parallel mesh each rank quantizes its own shard, and
the result is exactly the full tree's quantization, sliced (what the
JAX package gets by quantizing the sharded tree): a scale reduces over
the contraction, which a rank holds whole for the column-parallel
weights; for the row-parallel ``wo`` and ``w_down`` the ranks' amaxes
are all-reduced (max, exact) before anything is rounded.

``resolve_quant`` is the single downgrade authority: a requested mode
the build or model can't honor resolves to the unquantized path WITH a
reason the engine counts (kernel_downgrades / quant_downgrades) and logs
once per process — never a silent dtype change.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from kubeflow_tpu_torch.models.llama import param_logical_axes
from kubeflow_tpu_torch.parallel.sharding import pspec
from kubeflow_tpu_torch.serving.scheduler import QuantConfig

# Symmetric-quant clip points per KV storage dtype. fp8_e4m3's 448 is
# the e4m3fn finite max; int8 clips at +/-127 (keeping -128 unused makes
# the scale-growth requant in paged_kv exactly symmetric).
KV_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}
WEIGHT_QMAX = 127.0

# Big quantizable matmul weights and the axes their per-output-channel
# scales reduce over (layer tensors carry a leading L axis; the scale
# keeps it so per-layer slicing still works). Norm vectors stay full
# precision.
_LAYER_WEIGHTS = {
    # name: contraction axes (excluding the leading L axis)
    "wq": (1,),        # [L, d, h, hd]  -> scale [L, h, hd]
    "wk": (1,),        # [L, d, kv, hd] -> scale [L, kv, hd]
    "wv": (1,),        # [L, d, kv, hd] -> scale [L, kv, hd]
    "wo": (1, 2),      # [L, h, hd, d]  -> scale [L, d]
    "w_gate": (1,),    # [L, d, m]      -> scale [L, m]
    "w_up": (1,),      # [L, d, m]      -> scale [L, m]
    "w_down": (1,),    # [L, m, d]      -> scale [L, d]
}


def kv_store_dtype(kv_dtype: str) -> torch.dtype:
    """torch dtype the quantized pool is stored in."""
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8_e4m3":
        return torch.float8_e4m3fn
    raise ValueError(f"no storage dtype for kv_dtype={kv_dtype!r}")


def fp8_unsupported_reason(platform: Optional[str] = None) -> Optional[str]:
    """None when fp8 e4m3 pools can run here. The gate is dtype
    availability in this torch build: the pool path needs only casts to
    and from the dtype."""
    del platform  # dtype presence is the platform gate
    if not hasattr(torch, "float8_e4m3fn"):
        return "this torch build has no float8_e4m3fn dtype"
    return None


def resolve_quant(quant: Optional[QuantConfig], cfg=None,
                  platform: Optional[str] = None,
                  ) -> Tuple[QuantConfig, List[Tuple[str, str]]]:
    """Resolve a requested quant config against build/model support.

    Returns ``(effective, downgrades)`` where downgrades is a list of
    ``(requested_mode, reason)`` pairs — one per mode that fell back to
    unquantized. ``None`` and ``exact_parity=True`` resolve to all-off
    with NO downgrade (the caller asked for the unquantized program).
    """
    if quant is None:
        return QuantConfig(), []
    quant.validate()
    if quant.exact_parity:
        return QuantConfig(exact_parity=True), []
    kv, w = quant.kv_dtype, quant.weight_dtype
    downgrades: List[Tuple[str, str]] = []
    if kv == "fp8_e4m3":
        reason = fp8_unsupported_reason(platform)
        if reason is not None:
            downgrades.append((f"kv_dtype={kv}", reason))
            kv = "none"
    if w == "int8" and cfg is not None and getattr(cfg, "n_experts", 0):
        downgrades.append((
            f"weight_dtype={w}",
            "MoE expert weights keep full precision (the routed expert "
            "einsums are not int8-lowered)"))
        w = "none"
    return QuantConfig(kv_dtype=kv, weight_dtype=w), downgrades


def is_weight_quantized(params) -> bool:
    """True when the tree already carries int8 weight keys (idempotence
    guard for engine rebuilds over a shared quantized tree)."""
    return "embed_q" in params


def _quantize_channels(w, axes, mesh=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-output-channel quantization: amax over the
    contraction ``axes`` -> scale, round (half to even) / clip -> int8.
    Returns (q int8, scale f32 with ``axes`` squeezed out). ``mesh``:
    the contraction is sharded, so the amax is the max over the ranks."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axes)
    if mesh is not None:
        mesh.all_reduce(amax, op="max")
    s = amax / WEIGHT_QMAX
    s = s.clamp(min=1e-12)  # all-zero channels quantize to 0 cleanly
    s_b = s
    for a in sorted(axes):
        s_b = s_b.unsqueeze(a)
    q = torch.round(w32 / s_b).clamp_(-WEIGHT_QMAX, WEIGHT_QMAX)
    return q.to(torch.int8), s.float()


def _quantize_layers(w, axes, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_quantize_channels`` of a stacked [L, ...] weight, one layer at
    a time: the same bytes (no reduction crosses the L axis), with the
    transient f32 copy one layer wide instead of L."""
    qs, ss = zip(*(_quantize_channels(w[i], tuple(a - 1 for a in axes),
                                      mesh)
                   for i in range(w.shape[0])))
    return torch.stack(qs), torch.stack(ss)


def _contraction_sharded(names, axes) -> bool:
    """Whether any contraction axis of a weight maps to the tensor axis."""
    spec = pspec(names)
    return any(spec[a] == "tensor"
               or (isinstance(spec[a], tuple) and "tensor" in spec[a])
               for a in axes)


def quant_logical_axes(cfg) -> dict:
    """Logical axes of ``quantize_weights``' tree: an int8 payload keeps
    its weight's axes, a scale drops the contraction axes (the tree
    ``parallel.sharding.shard_tree`` cuts an int8 tree by)."""
    axes = param_logical_axes(cfg)
    out = {"final_norm": axes["final_norm"],
           "embed_q": axes["embed"], "embed_s": axes["embed"][:1]}
    if not cfg.tie_embeddings:
        out["lm_head_q"] = axes["lm_head"]
        out["lm_head_s"] = axes["lm_head"][1:]
    layers = {k: v for k, v in axes["layers"].items()
              if k not in _LAYER_WEIGHTS}
    for name, caxes in _LAYER_WEIGHTS.items():
        names = axes["layers"][name]
        layers[name + "_q"] = names
        layers[name + "_s"] = tuple(n for i, n in enumerate(names)
                                    if i not in caxes)
    out["layers"] = layers
    return out


def quantize_weights(params, cfg, mesh=None):
    """int8-quantize the big matmul weights ONCE (the engine's build
    path). Each quantized tensor ``name`` is replaced by ``name_q``
    (int8) + ``name_s`` (f32 per-output-channel scales); everything else
    (norms) passes through untouched. Call sites detect the ``_q`` keys
    and scale the product's output.

    The embedding quantizes per vocab ROW (each token's vector gets one
    scale): the lookup dequants with one scalar per gathered row, and a
    tied LM head gets per-vocab-channel output scaling from the same
    table. MoE configs must be downgraded before calling (resolve_quant
    does this).

    ``mesh``: ``params`` is the rank's shard; every rank calls this
    together (the row-parallel scales take one all-reduce per layer)."""
    if getattr(cfg, "n_experts", 0):
        raise ValueError("int8 weights unsupported for MoE configs; "
                         "resolve_quant should have downgraded")
    out = {"final_norm": params["final_norm"]}
    out["embed_q"], out["embed_s"] = _quantize_channels(params["embed"],
                                                        (1,))
    if not cfg.tie_embeddings:
        # [d, V] -> per-vocab-output-channel scale [V]
        out["lm_head_q"], out["lm_head_s"] = _quantize_channels(
            params["lm_head"], (0,))
    layers = dict(params["layers"])
    layer_axes = param_logical_axes(cfg)["layers"]
    for name, axes in _LAYER_WEIGHTS.items():
        w = layers.pop(name)
        reduce_over = (mesh if mesh is not None and _contraction_sharded(
            layer_axes[name], axes) else None)
        layers[name + "_q"], layers[name + "_s"] = _quantize_layers(
            w, axes, reduce_over)
    out["layers"] = layers
    return out

"""Mixture-of-Experts FFN (counterpart of ``kubeflow_tpu.parallel.moe``).

The JAX layer's function, on one card: a float32 router picks each
token's top-k experts (ties to the lower expert index, as ``lax.top_k``
breaks them), their probabilities renormalised; the Switch load-balance
loss and the router z-loss over the real tokens; then one of two
dispatch paths.

- **Capacity** (``capacity_factor > 0``, training): Switch/GShard dense
  dispatch. The (token, choice) pairs are flattened in priority order
  (choice 0 of every token first), each takes the next slot of its
  expert's capacity buffer or is dropped, and one-hot dispatch/combine
  tensors ``[G, E, C]`` move tokens into ``[E, C, D]`` buffers and back
  through einsums.
- **Dropless-exact** (``capacity_factor <= 0``, serving): every token's
  output is its true top-k mixture, whatever else is in the batch; every
  expert runs over every row, in expert order, weighted by the row's
  gate (0 where the expert was not chosen).

Every shape is static and nothing reads a value back to the host (no
``.item()``, boolean-mask indexing or ``nonzero``; one-hots are index
comparisons, where ``F.one_hot`` checks its indices on the host off the
card), so the layer runs inside the captured decode program and the
captured training step. The expert axis is not sharded: under a tensor
mesh the model raises ``MOE_MESH`` (``models.llama.check_moe_mesh``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.device import DeviceLike, resolve_device

MOE_MESH = ("MoE layers (n_experts > 0) under a tensor mesh: the expert "
            "axis and expert sharding are ROADMAP queue 1 item 8.7 "
            "(parallel/)")
MOE_WORLD = ("MoE layers (n_experts > 0) trained over a world of processes: "
             "the router's load-balance statistics are the global batch's "
             "in the JAX package, and the expert axis and expert sharding "
             "are ROADMAP queue 1 item 8.7 (parallel/)")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int
    mlp_dim: int
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    dtype: Any = torch.float32


def randn_stack(generator: torch.Generator, shape, fan_in: int,
                dtype, device) -> torch.Tensor:
    """N(0, 1/fan_in) of ``shape`` [..., rows, cols] in ``dtype``, drawn one
    trailing matrix at a time (in index order) into the preallocated
    stack, so no float32 temporary larger than one matrix exists."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for mat in out.view(-1, *shape[-2:]):
        w = torch.randn(shape[-2:], generator=generator, device=device,
                        dtype=torch.float32)
        mat.copy_(w.mul_(fan_in ** -0.5))
    return out


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    device: DeviceLike = None) -> dict:
    """Random float32 layer weights on ``device`` from ``generator``:
    router [d, E], w_gate / w_up [E, d, m] (fan-in d), w_down [E, m, d]
    (fan-in m). The draws differ from ``jax.random``'s."""
    device = resolve_device(device)
    d, m, e = cfg.dim, cfg.mlp_dim, cfg.n_experts
    f32 = torch.float32
    return {
        "router": randn_stack(generator, (d, e), d, f32, device),
        "w_gate": randn_stack(generator, (e, d, m), d, f32, device),
        "w_up": randn_stack(generator, (e, d, m), d, f32, device),
        "w_down": randn_stack(generator, (e, m, d), m, f32, device),
    }


def moe_param_logical_axes(cfg: MoEConfig) -> dict:
    return {
        "router": ("embed", None),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n, dtype=dtype)``: [..., n], 1 where the
    position equals ``idx``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest values and their
    indices, largest first, equal values in ascending index order
    (``torch.topk`` promises no order among ties). Values carry the
    gradient of ``probs``."""
    n = probs.shape[-1]
    ids = torch.arange(n, device=probs.device)
    rest = probs.detach()
    vals, idxs = [], []
    for _ in range(k):
        top = rest.amax(dim=-1, keepdim=True)
        # the lowest index among the maximizers (clamped: NaN rows have
        # none, and an out-of-range index would be a device assert)
        i = torch.where(rest == top, ids, n).amin(
            dim=-1, keepdim=True).clamp_(max=n - 1)
        vals.append(probs.gather(-1, i))
        idxs.append(i)
        rest = torch.where(ids == i, float("-inf"), rest)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def moe_layer(params: dict, x: torch.Tensor, cfg: MoEConfig,
              capacity: Optional[int] = None,
              token_mask: Optional[torch.Tensor] = None):
    """Apply the MoE FFN. x: [B, S, D] -> (y [B, S, D] in x's dtype, aux).

    ``params``: router [D, E], w_gate / w_up [E, D, M], w_down [E, M, D].
    ``token_mask`` [B, S] bool marks the real tokens: padding rows
    (prefill buckets, idle decode slots) neither route nor count in the
    aux losses, so they cannot displace a real token from an expert's
    capacity. ``aux``: float32 ``moe_load_balance``, ``moe_router_z``
    (``moe_aux_total`` adds them) and the diagnostic
    ``moe_dropped_fraction`` (of the valid choices)."""
    b, s, d = x.shape
    g = b * s
    e, k, dt = cfg.n_experts, cfg.top_k, cfg.dtype
    if capacity is None:
        capacity = max(1, int(math.ceil(g * k / e * cfg.capacity_factor)))

    tokens = x.reshape(g, d)
    logits = tokens.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # [G, E]
    valid = (torch.ones((g,), dtype=torch.bool, device=x.device)
             if token_mask is None else token_mask.reshape(g))

    topk_probs, topk_idx = top_k(probs, k)                     # [G, k]
    topk_probs = topk_probs / torch.clamp_min(
        topk_probs.sum(-1, keepdim=True), 1e-9)

    # aux losses (float32, real tokens only): one formula for both paths
    vf = valid.float()
    denom = torch.clamp_min(vf.sum(), 1.0)
    top1 = one_hot(topk_idx[:, 0], e, torch.float32)
    aux = {
        "moe_load_balance": cfg.load_balance_coef * e * torch.sum(
            ((top1 * vf[:, None]).sum(0) / denom)
            * ((probs * vf[:, None]).sum(0) / denom)),
        "moe_router_z": cfg.router_z_coef * torch.sum(
            torch.logsumexp(logits, dim=-1) ** 2 * vf) / denom,
    }

    if cfg.capacity_factor <= 0:
        # dropless-exact: independent of batch composition, E/k x the
        # routed FFN FLOPs (peak [G, M])
        gates = torch.zeros((g, e), dtype=dt, device=x.device)
        for j in range(k):
            gates = gates + one_hot(topk_idx[:, j], e, dt) \
                * topk_probs[:, j, None].to(dt)
        gates = gates * valid[:, None].to(dt)
        tk = tokens.to(dt)
        y = torch.zeros((g, d), dtype=dt, device=x.device)
        for i, (wg, wu, wd) in enumerate(zip(
                params["w_gate"].unbind(0), params["w_up"].unbind(0),
                params["w_down"].unbind(0))):
            h = F.silu(tk @ wg.to(dt)) * (tk @ wu.to(dt))
            y = y + gates[:, i, None] * (h @ wd.to(dt))
        aux["moe_dropped_fraction"] = torch.zeros(
            (), dtype=torch.float32, device=x.device)
        return y.reshape(b, s, d).to(x.dtype), aux

    # each (token, choice)'s slot in its expert's buffer: the count of
    # earlier assignments to that expert, choices flattened in priority
    # order (choice 0 of every token first)
    flat_idx = topk_idx.T.reshape(-1)                          # [k*G]
    flat_valid = valid.repeat(k)                               # [k*G]
    onehot = one_hot(flat_idx, e, torch.int32) \
        * flat_valid[:, None]                                  # [k*G, E]
    # the running count per expert, scanned along the contiguous dim: a
    # scan down dim 0 of [k*G, E] runs on E columns alone (on an H100,
    # 1.45 ms a call at G = 4096, E = 8: 14 % of the MoE training step)
    count = torch.cumsum(onehot.T.contiguous(), dim=1).T       # [k*G, E]
    pos = ((count - 1) * onehot).sum(-1)                       # [k*G]
    keep = (pos < capacity) & flat_valid
    pos = torch.where(keep, pos, 0)

    disp = (one_hot(flat_idx, e, dt)[:, :, None]
            * one_hot(pos, capacity, dt)[:, None, :]
            * keep[:, None, None].to(dt))                      # [k*G, E, C]
    disp = disp.reshape(k, g, e, capacity)
    weights = topk_probs.T.reshape(k, g).to(dt)                # [k, G]
    combine = (disp * weights[:, :, None, None]).sum(0)        # [G, E, C]
    dispatch = disp.sum(0)                                     # [G, E, C]

    expert_in = torch.einsum("gec,gd->ecd", dispatch, tokens.to(dt))
    h = F.silu(torch.einsum("ecd,edm->ecm", expert_in,
                            params["w_gate"].to(dt)))
    h = h * torch.einsum("ecd,edm->ecm", expert_in, params["w_up"].to(dt))
    expert_out = torch.einsum("ecm,emd->ecd", h, params["w_down"].to(dt))
    y = torch.einsum("gec,ecd->gd", combine, expert_out)

    aux["moe_dropped_fraction"] = ((~keep) & flat_valid).float().sum() \
        / torch.clamp_min(flat_valid.float().sum(), 1.0)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_aux_total(aux: dict) -> torch.Tensor:
    """Sum of the differentiable aux penalties (diagnostics excluded)."""
    return aux["moe_load_balance"] + aux["moe_router_z"]

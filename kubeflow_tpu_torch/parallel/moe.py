"""Mixture-of-Experts FFN (counterpart of ``kubeflow_tpu.parallel.moe``).

The JAX layer's function: a float32 router picks each token's top-k
experts (ties to the lower expert index, as ``lax.top_k`` breaks them),
their probabilities renormalised; the Switch load-balance loss and the
router z-loss over the real tokens; then one of two dispatch paths.

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
captured training step.

Over a training world (``world=``, a ``parallel.mesh.WorldMesh``) each
rank's result is what the JAX layer computes over the global micro batch
under GSPMD, where sharding never changes the function:

- over ``tokens`` (``data`` x ``fsdp`` x ``context``: the ranks holding
  different tokens; ``data`` and ``fsdp`` ranks hold different rows,
  ``context`` ranks chunk ``c`` of the same rows) the router's
  statistics are the global micro batch's: the sums behind both aux
  losses and the dropped fraction travel in one all-reduce of a small
  vector (``tensor.psum``, whose backward all-reduces too); the capacity
  is ``ceil(G * n_tokens * k / E * cf)``, JAX's ``B * S`` tokens; and a
  pair's slot follows JAX's priority order over the global micro batch,
  whose token ``b * S + s`` runs row-major: choice 0 of every token
  first; within a choice the rows in global order (the batch ranks in
  turn, each its local rows), within a row the chunks in ``context``
  order, within a chunk the positions. A rank's pairs therefore follow
  the pairs of every earlier choice, the pairs of the same choice in
  every earlier row (all its chunks, whichever ranks hold them) and in
  the earlier chunks of the same row, and the local prefix of its own
  chunk: from one all-gather over ``tokens`` of each rank's counts per
  choice, local row and expert (``[k, B_local, E]``);
- over ``expert`` a rank holds experts ``[x * E / X, (x + 1) * E / X)``
  and dispatches to them only (one-hots against the global ids; the
  slots counted over all E), and over ``tensor`` its ``mlp`` slice of
  every expert. Expert and tensor peers (the ``rows`` group) feed the
  same tokens (under ``context`` the same chunk of the same rows): the
  tokens and the combine weights enter the experts
  through ``tensor.copy`` over ``rows`` (each peer's gradient of them
  covers its own experts and columns only) and the output leaves
  through ``tensor.reduce`` over it. The router runs on every rank on
  the tokens as they are (its gradient is whole there).

A serving mesh (``parallel.mesh.TensorMesh``, ``expert`` x ``tensor``)
is passed as the world the same way: a rank holds experts ``[x * E / X,
(x + 1) * E / X)`` and its ``mlp`` slice of each, every rank routes every
token with the whole router (so the dropless path and the capacity
path, its capacity and slots counted over all tokens and all E, are
one card's), and the output leaves through the sum over ``rows``, the
whole mesh. Its ``tokens`` group is one rank.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.parallel import tensor


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
                dtype, device, part: Optional[tuple] = None) -> torch.Tensor:
    """N(0, 1/fan_in) of ``shape`` [..., rows, cols] in ``dtype``, drawn one
    trailing matrix at a time (in index order) into the preallocated
    stack, so no float32 temporary larger than one matrix exists.
    ``part``: the slices of the trailing dims kept (a mesh rank's share:
    its experts and its (rows, cols) of each; every matrix is drawn, so
    the values are the whole stack's)."""
    shape = tuple(shape)
    part = tuple(part or ())
    part = (slice(None),) * (len(shape) - len(part)) + part
    kept = tuple(len(range(*sl.indices(n))) for sl, n in zip(part, shape))
    lead = [range(*sl.indices(n)) for sl, n in zip(part[:-2], shape[:-2])]
    rows, cols = part[-2:]
    out = torch.empty(kept, dtype=dtype, device=device)
    mats = iter(out.view(-1, *kept[-2:]))
    for idx in itertools.product(*(range(n) for n in shape[:-2])):
        w = torch.randn(shape[-2:], generator=generator, device=device,
                        dtype=torch.float32)
        if all(i in r for i, r in zip(idx, lead)):
            next(mats).copy_(w[rows, cols].mul_(fan_in ** -0.5))
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


def _aux(cfg: MoEConfig, top1_sum, probs_sum, valid_sum, z_sum) -> dict:
    """The aux losses from the router's sums over the real tokens (of the
    rank, or of the global batch)."""
    denom = torch.clamp_min(valid_sum, 1.0)
    return {
        "moe_load_balance": cfg.load_balance_coef * cfg.n_experts
        * torch.sum((top1_sum / denom) * (probs_sum / denom)),
        "moe_router_z": cfg.router_z_coef * z_sum / denom,
    }


def _slots(onehot: torch.Tensor, k: int, b: int, world) -> torch.Tensor:
    """Each valid (token, choice) pair's count among the pairs before it
    (itself included) that chose its expert, in JAX's priority order over
    the global micro batch (module docstring): [k*G, E] from the pairs'
    one-hots ``onehot`` [k*G, E] of the rank's ``b`` rows (G = b * its
    chunk's length), from every ``tokens`` rank's counts per choice, row
    and expert."""
    e = onehot.shape[1]
    per = onehot.T.reshape(e, k, b, -1)                        # [E, k, B, S]
    mine = per.sum(-1, dtype=torch.int64).permute(1, 2, 0).contiguous()
    n, nc = world.axis_size("tokens"), world.axis_size("context")
    every = torch.empty((n * mine.numel(),), dtype=torch.int64,
                        device=mine.device)
    world.all_gather(every, mine.view(-1), "tokens", "moe")
    # the tokens group's order is (batch index, context index): put the
    # rows in global order, each row's chunks in context order
    every = every.view(n // nc, nc, k, b, e).permute(2, 0, 3, 1, 4)
    every = every.reshape(k, -1, e)                            # [k, rows*C, E]
    total = every.sum(1)                                       # [k, E]
    before = (every.cumsum(1) - every).view(k, n // nc, b, nc, e)
    ahead = (total.cumsum(0) - total)[:, None, :] + before[
        :, world.axis_index("batch"), :, world.axis_index("context")]
    count = per.cumsum(-1, dtype=torch.int64) \
        + ahead.permute(2, 0, 1)[..., None]                    # [E, k, B, S]
    return count.reshape(e, -1).T


def moe_layer(params: dict, x: torch.Tensor, cfg: MoEConfig,
              capacity: Optional[int] = None,
              token_mask: Optional[torch.Tensor] = None, world=None):
    """Apply the MoE FFN. x: [B, S, D] -> (y [B, S, D] in x's dtype, aux).

    ``params``: router [D, E], w_gate / w_up [E', D, M'], w_down
    [E', M', D]: every expert whole, or over ``world``'s ``expert`` and
    ``tensor`` axes the rank's experts (E' = E / expert) and ``mlp``
    slice (M' = M / tensor). ``token_mask`` [B, S] bool marks the real
    tokens: padding rows (prefill buckets, idle decode slots) neither
    route nor count in the aux losses, so they cannot displace a real
    token from an expert's capacity. ``aux``: float32
    ``moe_load_balance``, ``moe_router_z`` (``moe_aux_total`` adds them)
    and the diagnostic ``moe_dropped_fraction`` (of the valid choices).
    ``world``: a training world (module docstring), or None: the one-card
    function of the rows given."""
    b, s, d = x.shape
    g = b * s
    e, k, dt = cfg.n_experts, cfg.top_k, cfg.dtype
    spread = tensor.on(world, "tokens")
    n_local = params["w_gate"].shape[0]
    first = 0
    if tensor.on(world, "expert"):
        if n_local * world.axis_size("expert") != e:
            raise ValueError(f"{n_local} experts a rank over expert="
                             f"{world.axis_size('expert')}; the model has {e}")
        first = world.axis_index("expert") * n_local
    if capacity is None:
        total = g * (world.axis_size("tokens") if spread else 1)
        capacity = max(1, int(math.ceil(total * k / e * cfg.capacity_factor)))

    tokens = x.reshape(g, d)
    logits = tokens.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # [G, E]
    valid = (torch.ones((g,), dtype=torch.bool, device=x.device)
             if token_mask is None else token_mask.reshape(g))

    topk_probs, topk_idx = top_k(probs, k)                     # [G, k]
    topk_probs = topk_probs / torch.clamp_min(
        topk_probs.sum(-1, keepdim=True), 1e-9)

    # the router's sums over the real tokens (float32): one formula for
    # both paths, the global batch's over a world
    vf = valid.float()
    top1 = one_hot(topk_idx[:, 0], e, torch.float32)
    sums = [(top1 * vf[:, None]).sum(0), (probs * vf[:, None]).sum(0),
            vf.sum()[None],
            torch.sum(torch.logsumexp(logits, dim=-1) ** 2 * vf)[None]]
    # the experts' inputs: through copy over the rows group (each peer's
    # gradient covers its own experts and mlp columns)
    tk = tensor.copy(tokens, world, "rows", "moe").to(dt)

    if cfg.capacity_factor <= 0:
        # dropless-exact: independent of batch composition, E/k x the
        # routed FFN FLOPs (peak [G, M])
        gates = torch.zeros((g, e), dtype=dt, device=x.device)
        for j in range(k):
            gates = gates + one_hot(topk_idx[:, j], e, dt) \
                * topk_probs[:, j, None].to(dt)
        gates = tensor.copy(gates * valid[:, None].to(dt), world, "rows",
                            "moe")
        y = torch.zeros((g, d), dtype=dt, device=x.device)
        for i, (wg, wu, wd) in enumerate(zip(
                params["w_gate"].unbind(0), params["w_up"].unbind(0),
                params["w_down"].unbind(0))):
            h = F.silu(tk @ wg.to(dt)) * (tk @ wu.to(dt))
            y = y + gates[:, first + i, None] * (h @ wd.to(dt))
        sums = _global(sums, world, spread)
        aux = _aux(cfg, *sums)
        aux["moe_dropped_fraction"] = torch.zeros(
            (), dtype=torch.float32, device=x.device)
        y = tensor.reduce(y, world, "rows", "moe")
        return y.reshape(b, s, d).to(x.dtype), aux

    # each (token, choice)'s slot in its expert's buffer: the count of
    # earlier assignments to that expert, choices flattened in priority
    # order (choice 0 of every token first)
    flat_idx = topk_idx.T.reshape(-1)                          # [k*G]
    flat_valid = valid.repeat(k)                               # [k*G]
    onehot = one_hot(flat_idx, e, torch.int32) \
        * flat_valid[:, None]                                  # [k*G, E]
    if spread:
        count = _slots(onehot, k, b, world)
    else:
        # the running count per expert, scanned along the contiguous dim:
        # a scan down dim 0 of [k*G, E] runs on E columns alone (on an
        # H100, 1.45 ms a call at G = 4096, E = 8: 14 % of the MoE
        # training step)
        count = torch.cumsum(onehot.T.contiguous(), dim=1).T   # [k*G, E]
    pos = ((count - 1) * onehot).sum(-1)                       # [k*G]
    keep = (pos < capacity) & flat_valid
    pos = torch.where(keep, pos, 0)

    # the rank's experts only: their local ids (an id outside them
    # matches no column)
    mine = flat_idx - first if first else flat_idx
    disp = (one_hot(mine, n_local, dt)[:, :, None]
            * one_hot(pos, capacity, dt)[:, None, :]
            * keep[:, None, None].to(dt))                      # [k*G, E', C]
    disp = disp.reshape(k, g, n_local, capacity)
    weights = tensor.copy(topk_probs.T.reshape(k, g).to(dt), world, "rows",
                          "moe")                               # [k, G]
    combine = (disp * weights[:, :, None, None]).sum(0)        # [G, E', C]
    dispatch = disp.sum(0)                                     # [G, E', C]

    expert_in = torch.einsum("gec,gd->ecd", dispatch, tk)
    h = F.silu(torch.einsum("ecd,edm->ecm", expert_in,
                            params["w_gate"].to(dt)))
    h = h * torch.einsum("ecd,edm->ecm", expert_in, params["w_up"].to(dt))
    expert_out = torch.einsum("ecm,emd->ecd", h, params["w_down"].to(dt))
    y = torch.einsum("gec,ecd->gd", combine, expert_out)
    y = tensor.reduce(y, world, "rows", "moe")

    sums += [((~keep) & flat_valid).float().sum()[None],
             flat_valid.float().sum()[None]]
    *sums, dropped, choices = _global(sums, world, spread)
    aux = _aux(cfg, *sums)
    aux["moe_dropped_fraction"] = dropped / torch.clamp_min(choices, 1.0)
    return y.reshape(b, s, d).to(x.dtype), aux


def _global(sums: list, world, spread: bool) -> list:
    """The sums (each 1-d) over ``world``'s ``tokens`` ranks, in one
    all-reduce whose backward all-reduces too (``tensor.psum``), or as
    they are; 0-d where a sum is one number."""
    if spread:
        sizes = [t.numel() for t in sums]
        sums = list(tensor.psum(torch.cat(sums), world, "tokens",
                                "moe").split(sizes))
    return [t[0] if t.numel() == 1 else t for t in sums]


def moe_aux_total(aux: dict) -> torch.Tensor:
    """Sum of the differentiable aux penalties (diagnostics excluded)."""
    return aux["moe_load_balance"] + aux["moe_router_z"]

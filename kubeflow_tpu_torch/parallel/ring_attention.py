"""Context parallelism: ring attention and Ulysses all-to-all attention
over a training world's ``context`` axis (counterpart of
``kubeflow_tpu.parallel.ring_attention``).

Under ``context`` (``parallel.mesh.WorldMesh``) each rank holds chunk
``c`` of n of every row's tokens: its local q [B, Sl, H, D] and k/v
[B, Sl, KV, D] (under ``tensor``, the rank's own heads), Sl = S / n.

- **Ring** (``ring_attention``): K/V pass round the ring
  (``WorldMesh.ring_shift``: to ``c + 1``, from ``c - 1``) while each
  rank merges the attention of its queries over every block it is
  handed. The JAX function accumulates each block in float32 einsums,
  whose [B, KV, G, Sl, Sl] scores autograd keeps for the backward; here
  each ring step is one launch of the flash kernels
  (``ops/flash_attention.py``), which never build the scores. At step
  ``s`` the rank holds block ``src = (c - s) mod n``: ``src < c`` is
  attended in full (``causal=False``), ``src == c`` under the causal
  mask (the kernels' mask is aligned at position 0, which is right for
  the diagonal block alone), and under ``causal`` a block ``src > c``
  is skipped: the JAX update adds exactly zero for it. Each step's
  ``(o_s, lse_s)`` is merged into a float32 ``(o, lse)`` by
  log-sum-exp. The backward takes ``delta = rowsum(dO * O)`` in float32
  and the merged (global) lse, passes K/V round the ring again in the
  same order, and at each step calls the dQ and the dK/dV kernel on the
  block it holds (the global lse makes each block's P the global
  softmax's); the float32 dK/dV accumulators travel with their blocks,
  and one more step takes them home to their owners. With n = 1 the
  ring is the plain flash call.
- **Ulysses** (``ulysses_attention``): an ``all_to_all`` swaps the
  sequence cut for a head cut ([B, S, H / n, D] a rank), the flash
  attention runs over the whole sequence on the rank's heads, and the
  inverse ``all_to_all`` swaps back; the backward of each is the
  other. Needs the rank's KV heads divisible by n (the JAX message
  otherwise).

The forward kernel writes each step's ``o_s`` in q's dtype: in bf16 a
ring step adds one rounding that JAX's float32 carry does not have
(``chip_smoke.py`` phase 9r reads it at full width). Remat "full" and
"dots" re-run the ring's forward, its shifts included, in the backward
(``models/llama.py``), as they re-run the ``tensor`` axis's
collectives.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import flash_attention as fa

# the three calls of a ring step: the kernels' wrappers, or (for
# ``ring_attention_reference``) their plain versions
KERNEL_STEPS = (fa.flash_attention_fwd, fa.flash_attention_dq,
                fa.flash_attention_dkv)
PLAIN_STEPS = (fa.flash_attention_fwd_reference,
               fa.flash_attention_dq_reference,
               fa.flash_attention_dkv_reference)


def _block_causal(src: int, c: int, causal: bool):
    """How rank ``c`` attends to the K/V block of index ``src``: True
    (the causal mask: the diagonal block), False (in full) or None
    (skipped: every key lies after every query)."""
    if not causal or src < c:
        return False
    return True if src == c else None


def _merge(o, lse, o_s, lse_s):
    """The float32 (o [B, S, H, D], lse [B, H, S]) of two blocks' partial
    attention over disjoint keys, from each one's (o, lse)."""
    new = torch.logaddexp(lse, lse_s)
    w = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_s = torch.exp(lse_s - new).transpose(1, 2)[..., None]
    return o * w + o_s.float() * w_s, new


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, world, axis, causal, steps):
        fwd = steps[0]
        n, c = world.axis_size(axis), world.axis_index(axis)
        kv = torch.stack((k, v))
        o = lse = None
        for s in range(n):
            if s:
                kv = world.ring_shift(kv, axis)
            mask = _block_causal((c - s) % n, c, causal)
            if mask is None:
                continue
            o_s, lse_s = fwd(q, kv[0], kv[1], mask)
            if o is None:
                o, lse = o_s.float(), lse_s
            else:
                o, lse = _merge(o, lse, o_s, lse_s)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.world, ctx.axis, ctx.causal = world, axis, causal
        ctx.steps = steps
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        world, axis = ctx.world, ctx.axis
        _, dq_step, dkv_step = ctx.steps
        n, c = world.axis_size(axis), world.axis_index(axis)
        # delta = rowsum(dO * O) in float32, [B, S, H] -> [B, H, S]
        delta = (do.float() * o).sum(-1).transpose(1, 2).contiguous()
        do = do.to(q.dtype).contiguous()
        kv = torch.stack((k, v))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for s in range(n):
            if s:
                kv = world.ring_shift(kv, axis)
            mask = _block_causal((c - s) % n, c, ctx.causal)
            if mask is not None:
                dq += dq_step(q, kv[0], kv[1], do, lse, delta, mask)
                dk, dv = dkv_step(q, kv[0], kv[1], do, lse, delta, mask)
                dkv[0] += dk
                dkv[1] += dv
            # the accumulators travel with their block; after the last
            # step this shift takes each home
            dkv = world.ring_shift(dkv, axis)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, world, *, axis: str = "context",
                   causal: bool = True):
    """Sequence-sharded ring attention over ``world``'s ``axis``
    (module docstring). q: the rank's [B, Sl, H, D], k/v [B, Sl, KV, D]
    -> the rank's [B, Sl, H, D] in q's dtype, differentiable in q, k
    and v."""
    if world is None or world.axis_size(axis) == 1:
        return fa.flash_attention(q, k, v, causal=causal)
    return _Ring.apply(q, k, v, world, axis, bool(causal), KERNEL_STEPS)


def ring_attention_reference(q, k, v, world, *, axis: str = "context",
                             causal: bool = True):
    """``ring_attention`` with each ring step's forward, dQ and dK/dV
    through the flash kernels' plain versions (dense float32 math from
    the same formulas) on any device: the same ring, shifts and merges,
    which ``chip_smoke.py`` holds the kernels' ring against on the
    card. Needs a world of more than one rank on ``axis``."""
    return _Ring.apply(q, k, v, world, axis, bool(causal), PLAIN_STEPS)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, axis, split_dim, concat_dim):
        ctx.world, ctx.axis = world, axis
        ctx.dims = split_dim, concat_dim
        return world.all_to_all(x, split_dim, concat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (ctx.world.all_to_all(g, concat_dim, split_dim, ctx.axis),
                None, None, None, None)


def ulysses_attention(q, k, v, world, *, axis: str = "context",
                      causal: bool = True):
    """All-to-all (DeepSpeed-Ulysses) sequence-parallel attention over
    ``world``'s ``axis`` (module docstring); the shapes of
    ``ring_attention``. Raises ValueError (the JAX message) when the
    rank's KV heads do not divide over the axis."""
    n = 1 if world is None else world.axis_size(axis)
    if n > 1 and k.shape[2] % n != 0:
        raise ValueError(
            f"ulysses needs n_kv_heads ({k.shape[2]}) divisible by "
            f"mesh axis {axis!r} ({n}); use ring_attention")
    if n == 1:
        return fa.flash_attention(q, k, v, causal=causal)
    # [B, Sl, H, D] -> [B, S, H / n, D]: gather the sequence, cut heads
    qg, kg, vg = (_AllToAll.apply(x, world, axis, 2, 1) for x in (q, k, v))
    o = fa.flash_attention(qg, kg, vg, causal=causal)
    return _AllToAll.apply(o, world, axis, 1, 2)

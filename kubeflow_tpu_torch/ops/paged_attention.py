"""Paged grouped-query DECODE attention: the wrapper of the hand-written
Hopper kernel ``csrc/paged_decode_attention.cu`` and its plain PyTorch
version (counterpart of ``kubeflow_tpu.ops.pallas_paged_attention``).

One query row per slot attends to the KV rows of the pool blocks its
block-table row names, walking only the ``ceil(kv_len / bs)`` live blocks;
no ``[max_seq]`` view of the cache is ever built by the kernel. The kernel
splits each slot's walk over thread blocks of ``split_plan(max_blocks,
bs).blocks_per_split`` pool blocks each and merges their partials in a
second pass (flash-decoding); the wrapper allocates the partials'
workspace. The kernel source carries the design notes and what bounds it
on the card.

``paged_decode_attention`` launches the kernel for CUDA tensors (raising
on anything the kernel does not take) and runs the plain version,
``paged_decode_attention_reference``, only for tensors on the CPU. There
is no fallback from one to the other. ``paged_decode_attention.launches``
counts kernel launches.

Quantized pools (int8 or fp8 e4m3, with per-block per-KV-head f32
scales ``k_scale``/``v_scale`` [NB, KV_H]) take the same entry point
with the scales given; it hands them to
``paged_decode_attention_quant``, the wrapper of the same source's
fused-dequant kernel, whose launches count separately in
``paged_decode_attention_quant.launches``.

Tensor parallelism (the JAX package's ``paged_decode_attention_sharded``,
a ``shard_map`` of the kernel over the KV-head axis with no collectives)
needs no kernel of its own: GQA decode is independent per KV head. Each
rank of the port's mesh owns its contiguous slice of the pool (and of
the scale tables) and calls the kernel on it, ``paged_decode_attention_
shard``; ``paged_decode_attention_sharded`` takes whole arrays and does
every rank's call in turn on contiguous copies of the slices, for checks
against the unsharded call.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from kubeflow_tpu_torch.cuda_graph import count_launch
from kubeflow_tpu_torch.ops.attention import decode_attention

KERNEL = "paged_decode_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPE_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}
_HEAD_DIMS = (64, 128)
_MAX_BLOCK_SIZE = 64
_MAX_GROUPS = 8
# KV rows a split of the kernel walks at most: one 64-row pool block at
# the serving block size, several smaller ones (whose copies then overlap
# the previous block's arithmetic). At the serving shape 1, 2, 4 and 16
# blocks a split take 0.0356, 0.0466, 0.0780 and 0.2426 ms
# (tools/paged_split.py on NVIDIA H100 80GB HBM3, 700 W): the widest
# spread wins there
_SPLIT_ROWS = 64


class SplitPlan(NamedTuple):
    """How the kernel splits a slot's walk: split s walks live blocks
    [s * blocks_per_split, min((s + 1) * blocks_per_split, n_live)) with
    n_live = min(ceil(kv_len / bs), max_blocks), and ``n_split`` splits
    cover a full table row; the splits past n_live exit without work."""
    blocks_per_split: int
    n_split: int


def split_plan(max_blocks: int, block_size: int) -> SplitPlan:
    """The kernel's split of a slot's walk, from the table width and the
    pool block size alone: never from the batch, the KV heads or the
    other slots' lengths, so a slot's output is bitwise the same whatever
    shares its launch (and one rank's heads the same as in the unsharded
    launch)."""
    p = max(1, _SPLIT_ROWS // block_size)
    return SplitPlan(p, -(-max_blocks // p))


def _check_shapes(q, k_pool, v_pool, tables, kv_len):
    """The JAX wrapper's shape errors, plus the pool/table consistency it
    relies on implicitly."""
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"want q [B, H, D] and pools [NB, bs, KV_H, D], "
                         f"got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    b, h, d = q.shape
    _, _, kvh, d_k = k_pool.shape
    if d != d_k:
        raise ValueError(f"head_dim mismatch: q has {d}, pool has {d_k}")
    if h % kvh:
        raise ValueError(f"H={h} not a multiple of KV_H={kvh}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool shape {tuple(v_pool.shape)} != k_pool "
                         f"shape {tuple(k_pool.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables shape {tuple(tables.shape)}: want "
                         f"[{b}, max_blocks]")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len shape {tuple(kv_len.shape)}: want [{b}]")


def check_kernel_geometry(head_dim: int, block_size: int,
                          groups: int, dtype=None) -> None:
    """Raise ValueError for a geometry (or dtype, when given) the CUDA
    kernel does not take: the Python side of the limits that the C entry
    of ``csrc/paged_decode_attention.cu`` enforces again."""
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got "
                         f"{head_dim}")
    if not 1 <= block_size <= _MAX_BLOCK_SIZE:
        raise ValueError(f"kernel takes block_size <= {_MAX_BLOCK_SIZE}, "
                         f"got {block_size}")
    if groups > _MAX_GROUPS:
        raise ValueError(f"kernel takes H / KV_H <= {_MAX_GROUPS}, got "
                         f"{groups}")
    if dtype is not None and dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes bf16 or f32, got {dtype}")


def _check_scales(k_pool, k_scale, v_scale):
    """The JAX wrapper's scale errors: both or neither, each [NB, KV_H]."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if k_scale is None:
        return
    want = (k_pool.shape[0], k_pool.shape[2])
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(sc.shape) != want:
            raise ValueError(f"{name} shape {tuple(sc.shape)} != {want}")


def _dequant(pool, scale):
    """float32(pool) * scale[block, head]: the f32 values the fused kernel
    computes, never rounded to a compute dtype."""
    return pool.float() * scale.float()[:, None, :, None]


def paged_decode_attention_reference(q, k_pool, v_pool, tables, kv_len,
                                     k_scale=None, v_scale=None):
    """Plain PyTorch version: gather each slot's logical view of the pool
    and run dense decode attention over it (f32 softmax, -1e30 mask); a
    slot with kv_len 0 outputs zeros, as the kernel does. With scales
    the pool is dequantized to f32 first (``_dequant``) and the output
    comes back in q's dtype."""
    _check_shapes(q, k_pool, v_pool, tables, kv_len)
    _check_scales(k_pool, k_scale, v_scale)
    if k_scale is not None:
        k_pool, v_pool = _dequant(k_pool, k_scale), _dequant(v_pool, v_scale)
    b = q.shape[0]
    idx = tables.long()
    k_view = k_pool[idx].reshape(b, -1, *k_pool.shape[2:])
    v_view = v_pool[idx].reshape(b, -1, *v_pool.shape[2:])
    out = decode_attention(q[:, None], k_view, v_view, kv_len)[:, 0]
    return torch.where((kv_len > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _on_cpu_or_one_cuda(name, tensors) -> bool:
    """True for all-CPU inputs (the plain version runs); raises unless
    every input is on one CUDA device; checks what every kernel launch
    needs (int32 tables/lengths, contiguous, 16-byte aligned pools)."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device or "
                         f"all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    q, k_pool, v_pool, tables, kv_len = tensors[:5]
    if tables.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError("tables and kv_len must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")
    b, h, d = q.shape
    _, bs, kvh, _ = k_pool.shape
    check_kernel_geometry(d, bs, h // kvh, q.dtype)
    return False


def paged_decode_attention(q, k_pool, v_pool, tables, kv_len,
                           k_scale=None, v_scale=None):
    """Block-resident paged GQA decode attention.

    q: [B, H, D] (this step's query rows); k_pool/v_pool:
    [num_blocks, block_size, KV_H, D] (the current step's KV row already
    scattered in); tables: [B, max_blocks_per_seq] int32 pool block ids in
    logical order; kv_len: [B] int32 live rows per slot INCLUDING this
    step. Returns [B, H, D] in q.dtype.

    k_scale/v_scale: [num_blocks, KV_H] f32 per-block per-kv-head scales
    of an int8/fp8-quantized pool (both or neither); when given, the
    call goes to ``paged_decode_attention_quant``.
    """
    _check_shapes(q, k_pool, v_pool, tables, kv_len)
    _check_scales(k_pool, k_scale, v_scale)
    if k_scale is not None:
        return paged_decode_attention_quant(q, k_pool, v_pool, tables,
                                            kv_len, k_scale, v_scale)
    tensors = (q, k_pool, v_pool, tables, kv_len)
    if _on_cpu_or_one_cuda("paged_decode_attention", tensors):
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                kv_len)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"kernel takes bf16 or f32 q/pools of one dtype, "
                         f"got q {q.dtype}, pools {k_pool.dtype}/"
                         f"{v_pool.dtype}")
    b, h, d = q.shape
    _, bs, kvh, _ = k_pool.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    plan, ws = _workspace(q, bs, tables.shape[1])
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.kft_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(),
        b, h, kvh, d, bs, tables.shape[1], *plan, 1.0 / math.sqrt(d),
        _DTYPE_CODE[q.dtype], stream)
    count_launch(paged_decode_attention, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_quant(q, k_pool, v_pool, tables, kv_len,
                                 k_scale, v_scale):
    """``paged_decode_attention`` over an int8 or fp8-e4m3 pool with its
    [NB, KV_H] f32 scales: the fused-dequant kernel for CUDA tensors
    (each K/V element upcast to f32 and multiplied by its block's scale
    before the dot, never rounded to q's dtype), the plain version for
    CPU tensors. Returns [B, H, D] in q.dtype."""
    _check_shapes(q, k_pool, v_pool, tables, kv_len)
    _check_scales(k_pool, k_scale, v_scale)
    tensors = (q, k_pool, v_pool, tables, kv_len, k_scale, v_scale)
    if _on_cpu_or_one_cuda("paged_decode_attention_quant", tensors):
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                kv_len, k_scale, v_scale)
    if k_pool.dtype not in _KV_DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"quantized kernel takes int8 or float8_e4m3fn "
                         f"pools of one dtype, got {k_pool.dtype}/"
                         f"{v_pool.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("k_scale and v_scale must be float32")
    b, h, d = q.shape
    _, bs, kvh, _ = k_pool.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    plan, ws = _workspace(q, bs, tables.shape[1])
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.kft_paged_decode_attention_quant(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), tables.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(), b, h, kvh, d, bs,
        tables.shape[1], *plan, 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype],
        _KV_DTYPE_CODE[k_pool.dtype], stream)
    count_launch(paged_decode_attention_quant, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention_quant kernel launch "
                           f"failed: cudaError {err}")
    return out


paged_decode_attention_quant.launches = 0


def _workspace(q, block_size: int, max_blocks: int):
    """The split plan and the kernel's partials, [B, H, n_split] x (D + 2)
    float32 (acc, then m and l), from the caching allocator on q's
    stream."""
    plan = split_plan(max_blocks, block_size)
    b, h, d = q.shape
    ws = torch.empty(b * h * plan.n_split * (d + 2), dtype=torch.float32,
                     device=q.device)
    return plan, ws


def _library():
    from kubeflow_tpu_torch.ops import cuda_build

    lib = cuda_build.load(KERNEL)
    fn = lib.kft_paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    fq = lib.kft_paged_decode_attention_quant
    if fq.argtypes is None:
        fq.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fq.restype = ctypes.c_int
    return lib


def shard_unsupported_reason(mesh, n_kv_heads: int):
    """Why the KV heads cannot be split over the mesh, or None when they
    can (the JAX package's check and text): the KV-head dim must divide
    evenly over the ``tensor`` axis."""
    if mesh is None:
        return None
    tp = int(dict(mesh.shape).get("tensor", 1))
    if tp > 1 and n_kv_heads % tp:
        return f"n_kv_heads={n_kv_heads} not divisible by tensor={tp}"
    return None


def paged_decode_attention_shard(q, k_pool, v_pool, tables, kv_len, *,
                                 mesh, n_kv_heads: int, k_scale=None,
                                 v_scale=None):
    """One rank's part of ``paged_decode_attention_sharded``: q
    [B, H/tp, D] holds the rank's query heads, the pools [NB, bs,
    KV_H/tp, D] (and scales [NB, KV_H/tp]) its KV heads, tables and
    lengths are whole. Checks that the local shapes are the rank's share
    of ``n_kv_heads``, then runs ``paged_decode_attention`` (rows 1-2's
    kernels on a CUDA pool, counted there)."""
    reason = shard_unsupported_reason(mesh, n_kv_heads)
    if reason is not None:
        raise ValueError(f"cannot shard paged attention: {reason}")
    local = n_kv_heads // mesh.tp
    if k_pool.dim() != 4 or k_pool.shape[2] != local:
        raise ValueError(f"rank pool {tuple(k_pool.shape)}: want KV_H = "
                         f"{n_kv_heads} / tensor={mesh.tp} = {local}")
    return paged_decode_attention(q, k_pool, v_pool, tables, kv_len,
                                  k_scale=k_scale, v_scale=v_scale)


def paged_decode_attention_sharded(q, k_pool, v_pool, tables, kv_len, *,
                                   mesh, k_scale=None, v_scale=None):
    """``paged_decode_attention`` partitioned over the mesh's ``tensor``
    axis, on whole arrays (the JAX function's signature and result): q
    [B, H, D] splits on H, the pools on KV_H, the scales on their KV_H,
    tables and lengths go whole to every part. Each rank's slice is made
    a contiguous tensor of its own, as a rank's pool is, and goes through
    ``paged_decode_attention_shard``; the outputs concatenate on H. A
    1-sized axis is the plain call; an indivisible one raises."""
    kvh = k_pool.shape[2]
    reason = shard_unsupported_reason(mesh, kvh)
    if reason is not None:
        raise ValueError(f"cannot shard paged attention: {reason}")
    tp = int(dict(mesh.shape).get("tensor", 1))
    if tp <= 1:
        return paged_decode_attention(q, k_pool, v_pool, tables, kv_len,
                                      k_scale=k_scale, v_scale=v_scale)
    h = q.shape[1]
    if h % tp:
        raise ValueError(f"H={h} not divisible by tensor={tp}")
    qh, kh = h // tp, kvh // tp
    outs = []
    for r in range(tp):
        heads = slice(r * kh, (r + 1) * kh)
        sc = ({} if k_scale is None else
              {"k_scale": k_scale[:, heads].contiguous(),
               "v_scale": v_scale[:, heads].contiguous()})
        outs.append(paged_decode_attention_shard(
            q[:, r * qh:(r + 1) * qh].contiguous(),
            k_pool[:, :, heads].contiguous(),
            v_pool[:, :, heads].contiguous(), tables, kv_len,
            mesh=mesh, n_kv_heads=kvh, **sc))
    return torch.cat(outs, dim=1)

"""Paged grouped-query DECODE attention: the wrapper of the hand-written
Hopper kernel ``csrc/paged_decode_attention.cu`` and its plain PyTorch
version (counterpart of ``kubeflow_tpu.ops.pallas_paged_attention``).

One query row per slot attends to the KV rows of the pool blocks its
block-table row names, walking only the ``ceil(kv_len / bs)`` live blocks;
no ``[max_seq]`` view of the cache is ever built by the kernel. The kernel
source carries the design notes and what bounds it on the card.

``paged_decode_attention`` launches the kernel for CUDA tensors (raising
on anything the kernel does not take) and runs the plain version,
``paged_decode_attention_reference``, only for tensors on the CPU. There
is no fallback from one to the other. ``paged_decode_attention.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kubeflow_tpu_torch.ops.attention import decode_attention

KERNEL = "paged_decode_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_BLOCK_SIZE = 64
_MAX_GROUPS = 8


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


def paged_decode_attention_reference(q, k_pool, v_pool, tables, kv_len):
    """Plain PyTorch version: gather each slot's logical view of the pool
    and run dense decode attention over it (f32 softmax, -1e30 mask); a
    slot with kv_len 0 outputs zeros, as the kernel does."""
    _check_shapes(q, k_pool, v_pool, tables, kv_len)
    b = q.shape[0]
    idx = tables.long()
    k_view = k_pool[idx].reshape(b, -1, *k_pool.shape[2:])
    v_view = v_pool[idx].reshape(b, -1, *v_pool.shape[2:])
    out = decode_attention(q[:, None], k_view, v_view, kv_len)[:, 0]
    return torch.where((kv_len > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def paged_decode_attention(q, k_pool, v_pool, tables, kv_len):
    """Block-resident paged GQA decode attention.

    q: [B, H, D] (this step's query rows); k_pool/v_pool:
    [num_blocks, block_size, KV_H, D] (the current step's KV row already
    scattered in); tables: [B, max_blocks_per_seq] int32 pool block ids in
    logical order; kv_len: [B] int32 live rows per slot INCLUDING this
    step. Returns [B, H, D] in q.dtype.
    """
    _check_shapes(q, k_pool, v_pool, tables, kv_len)
    tensors = (q, k_pool, v_pool, tables, kv_len)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                kv_len)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged_decode_attention: all inputs must be on one "
                         f"CUDA device or all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"kernel takes bf16 or f32 q/pools of one dtype, "
                         f"got q {q.dtype}, pools {k_pool.dtype}/"
                         f"{v_pool.dtype}")
    if tables.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError("tables and kv_len must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    b, h, d = q.shape
    _, bs, kvh, _ = k_pool.shape
    check_kernel_geometry(d, bs, h // kvh)
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _library()
    err = lib.kft_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        b, h, kvh, d, bs, tables.shape[1], 1.0 / math.sqrt(d),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    paged_decode_attention.launches += 1
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    return out


paged_decode_attention.launches = 0


def _library():
    from kubeflow_tpu_torch.ops import cuda_build

    lib = cuda_build.load(KERNEL)
    fn = lib.kft_paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib

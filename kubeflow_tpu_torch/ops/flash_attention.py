"""Flash attention for training: the wrappers of the hand-written Hopper
kernels ``csrc/flash_attention_{fwd,dq,dkv}.cu``, their plain PyTorch
versions, and the ``torch.autograd.Function`` that joins them
(counterpart of ``kubeflow_tpu.ops.pallas_attention``).

``flash_attention(q, k, v)`` takes q [B, S, H, D] and k/v [B, S, KV_H, D]
(H a multiple of KV_H; KV heads are never repeated) and returns
[B, S, H, D] in q's dtype. The forward saves ``(q, k, v, o, lse)`` with
lse [B, H, S] float32; the backward computes ``delta = rowsum(dO * O)`` in
float32, outside any kernel (as the JAX ``_bwd`` does), then calls the dQ
and the dK/dV kernel.

Each of the three wrappers (``flash_attention_fwd``, ``flash_attention_dq``,
``flash_attention_dkv``) launches its kernel for CUDA tensors, raising on
anything the kernel does not take, and runs its plain version
(``*_reference``: dense float32 math from the same formulas) only for
tensors on the CPU. There is no fallback from one to the other, and no
padding copy: the kernels mask the ragged edge themselves. Each wrapper's
``.launches`` counts kernel launches.

Each kernel has two bodies, chosen by dtype. bf16 runs on the tensor
cores (wgmma) and rounds P (forward, dK/dV) and dS (dQ, dK/dV) to bf16
once, as they leave the accumulators for the products that take them
(P . v; dS . k; P^T . dO and dS^T . q); in the forward P is taken against
the running max of its 64-wide KV block's walk. Everything else stays
float32 until the one final write. float32 runs float32 FMAs
throughout and keeps P float32. The plain versions take
``operand_dtype`` to round at the same points (None, the default and the
CPU path, keeps P and dS float32 as the JAX function does);
``tools/flash_parity.py`` holds the bf16 kernels to both.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kubeflow_tpu_torch.cuda_graph import count_launch

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
KERNELS = ("flash_attention_fwd", "flash_attention_dq",
           "flash_attention_dkv")


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"want q [B, S, H, D] and k/v [B, S, KV_H, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, _, h, d = q.shape
    bk, _, kvh, dk = k.shape
    if v.shape != k.shape:
        raise ValueError(f"v shape {tuple(v.shape)} != k shape "
                         f"{tuple(k.shape)}")
    if bk != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head_dim")
    if h % kvh:
        raise ValueError(f"H={h} not a multiple of KV_H={kvh}")


def check_kernel_geometry(head_dim: int, dtype=None) -> None:
    """Raise ValueError for a head_dim (or dtype, when given) the CUDA
    kernels do not take: the Python side of the limits that the C entries
    of ``csrc/flash_attention_*.cu`` enforce again."""
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {_HEAD_DIMS}, got "
                         f"{head_dim}")
    if dtype is not None and dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernels take bf16 or f32, got {dtype}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _mask(sq: int, skv: int, causal: bool, device) -> torch.Tensor:
    """[Sq, Skv] validity: every KV row is real here (no padding), the
    causal triangle when ``causal``."""
    if not causal:
        return torch.ones((sq, skv), dtype=torch.bool, device=device)
    q_pos = torch.arange(sq, device=device)[:, None]
    return q_pos >= torch.arange(skv, device=device)[None, :]


def _grouped(x, kvh):
    """[B, S, H, D] -> float32 [B, S, KV_H, G, D] (query head h is group
    member h % G of KV head h // G)."""
    b, s, h, d = x.shape
    return x.float().reshape(b, s, kvh, h // kvh, d)


def flash_attention_fwd_reference(q, k, v, causal: bool = True,
                                  operand_dtype=None):
    """Plain forward: (o [B, S, H, D] in q's dtype, lse [B, H, S] f32),
    with the -1e30 mask and l clamped at 1e-30, as the kernels compute
    them.

    ``operand_dtype=None`` (the default and the CPU path) is the dense
    float32 function the JAX package computes, with q pre-scaled by
    1/sqrt(D); float32 rounds nothing and gives the same. A narrower
    dtype (torch.bfloat16) is the tensor-core kernel's arithmetic: S =
    (q . k^T) * scale in float32, then a walk over 64-wide KV blocks
    with the running max m, P = exp(S - m) rounded to ``operand_dtype``
    for the P . v product and summed into l in float32, and O rescaled
    by exp(m_old - m_new) at each block (``_fwd_walk``)."""
    _check_shapes(q, k, v)
    if operand_dtype not in (None, torch.float32):
        return _fwd_walk(q, k, v, causal, operand_dtype)[:2]
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf = _grouped(q, kvh) * (1.0 / math.sqrt(d))
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    s = torch.where(_mask(sq, skv, causal, q.device), s,
                    torch.tensor(NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lc = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / lc
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    lse = (m + torch.log(lc))[..., 0].reshape(b, h, sq)
    return o, lse


BLOCK_KV = 64   # the kernels' KV block: the walk's rescale points


def _fwd_walk(q, k, v, causal, operand_dtype, wide=False, on_p=None):
    """The bf16 forward kernel's walk: (o, lse, extra) with P rounded to
    ``operand_dtype`` where it enters P . v. ``wide`` takes the two
    products' sums in float64 (another order) and l and O in float64,
    with the same rounding points (S and P float32, P then rounded).
    ``on_p(p, vf)`` is called per KV block with the float32 P and returns
    a [B, KV_H, G, Sq, D] term that the walk rescales and sums as it does
    P . v (``tools/flash_parity.py`` adds its near-tie allowance so);
    ``extra`` is that sum over max(l, 1e-30), or None."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    acc_t = torch.float64 if wide else torch.float32
    qx = _grouped(q, kvh).to(acc_t)
    kx, vx = k.to(acc_t), v.to(acc_t)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qx, kx).float() * scale
    s = torch.where(_mask(sq, skv, causal, q.device), s,
                    torch.tensor(NEG_INF, device=q.device))
    m = torch.full(s.shape[:-1] + (1,), NEG_INF, device=q.device)
    l = torch.zeros(m.shape, dtype=acc_t, device=q.device)
    acc = torch.zeros(s.shape[:-1] + (d,), dtype=acc_t, device=q.device)
    extra = None
    for k0 in range(0, skv, BLOCK_KV):
        blk = s[..., k0:k0 + BLOCK_KV]
        m_new = torch.maximum(m, blk.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(blk - m_new)
        m = m_new
        l = l * alpha + p.to(acc_t).sum(dim=-1, keepdim=True)
        vb = vx[:, k0:k0 + BLOCK_KV]
        acc = acc * alpha + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(operand_dtype).to(acc_t), vb)
        if on_p is not None:
            term = on_p(p, vb.float())
            extra = term if extra is None else extra * alpha + term
    lc = l.clamp_min(1e-30)
    o = (acc / lc).float()
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    lse = (m + torch.log(lc.float()))[..., 0].reshape(b, h, sq)
    if extra is not None:
        extra = (extra / lc.float()).permute(0, 3, 1, 2, 4).reshape(
            b, sq, h, d)
    return o, lse, extra


def _dscores(q, k, v, do, lse, delta, causal):
    """P and dS ([B, KV_H, G, Sq, Skv] f32) recomputed from lse, with the
    grouped float32 q and dO they came from."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qf, dof = _grouped(q, kvh), _grouped(do, kvh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    s = torch.where(_mask(sq, skv, causal, q.device), s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.exp(s - lse.float().reshape(b, kvh, g, sq)[..., None])
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - delta.float().reshape(b, kvh, g, sq)[..., None]) * scale
    return p, ds, qf, dof


def _operand(x, operand_dtype):
    """``x`` as the product that takes it sees it: rounded to
    ``operand_dtype`` and back to float32, or ``x`` itself for None."""
    return x if operand_dtype is None else x.to(operand_dtype).float()


def flash_attention_dq_reference(q, k, v, do, lse, delta,
                                 causal: bool = True, operand_dtype=None):
    """Plain dQ: P = exp(S * scale - lse), dS = P * (dO.v^T - delta) *
    scale, dQ = dS . k, in float32, returned in q's dtype.

    ``operand_dtype`` (None or a dtype such as torch.bfloat16) rounds dS
    to that dtype before the dS . k product, where the tensor-core kernel
    rounds it; None keeps it float32, as the JAX function does."""
    _, ds, _, _ = _dscores(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bkgqs,bskd->bqkgd", _operand(ds, operand_dtype),
                      k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                  causal: bool = True, operand_dtype=None):
    """Plain dK, dV: P^T . dO and dS^T . q summed over the G query heads
    of each KV head, in float32, returned in k's dtype.

    ``operand_dtype`` rounds P and dS to that dtype before the two
    products, where the tensor-core kernel rounds them; None keeps them
    float32, as the JAX function does."""
    p, ds, qf, dof = _dscores(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bkgqs,bqkgd->bskd", _operand(p, operand_dtype), dof)
    dk = torch.einsum("bkgqs,bqkgd->bskd", _operand(ds, operand_dtype), qf)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _on_cpu(tensors) -> bool:
    """True when every tensor lies on the CPU; False when all lie on one
    CUDA device; raises for anything else."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash attention: all inputs must be on one CUDA "
                         "device or all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    return False


def _kernel_inputs(name, tensors, dtype):
    """Contiguous, 16-byte aligned inputs of one dtype for a kernel."""
    out = []
    for t in tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name}: inputs must share one dtype, got "
                             f"{[str(x.dtype) for x in tensors]}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
        out.append(t)
    return out


def _stats(name, tensors, shape):
    out = []
    for t in tensors:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: lse and delta must be float32 "
                             f"{list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
        out.append(t.contiguous())
    return out


def _geometry(q, k):
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    check_kernel_geometry(d, q.dtype)
    return b, sq, skv, h, kvh, d


def flash_attention_fwd(q, k, v, causal: bool = True):
    """Forward kernel: (o [B, S, H, D] in q's dtype, lse [B, H, S] f32)."""
    _check_shapes(q, k, v)
    if _on_cpu((q, k, v)):
        return flash_attention_fwd_reference(q, k, v, causal)
    b, sq, skv, h, kvh, d = _geometry(q, k)
    q, k, v = _kernel_inputs("flash_attention_fwd", (q, k, v), q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = _stream(q)
    err = _library("flash_attention_fwd").kft_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, sq, skv, h, kvh, d, int(causal),
        1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype], stream)
    count_launch(flash_attention_fwd, stream)
    _raise_on(err, "flash_attention_fwd")
    return o, lse


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dQ kernel: [B, S, H, D] in q's dtype."""
    _check_shapes(q, k, v)
    if _on_cpu((q, k, v, do, lse, delta)):
        return flash_attention_dq_reference(q, k, v, do, lse, delta, causal)
    b, sq, skv, h, kvh, d = _geometry(q, k)
    q, k, v, do = _kernel_inputs("flash_attention_dq", (q, k, v, do),
                                 q.dtype)
    lse, delta = _stats("flash_attention_dq", (lse, delta), (b, h, sq))
    dq = torch.empty_like(q)
    stream = _stream(q)
    err = _library("flash_attention_dq").kft_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq, skv, h, kvh,
        d, int(causal), 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype], stream)
    count_launch(flash_attention_dq, stream)
    _raise_on(err, "flash_attention_dq")
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """dK/dV kernel: (dk, dv) [B, S, KV_H, D] in k's dtype."""
    _check_shapes(q, k, v)
    if _on_cpu((q, k, v, do, lse, delta)):
        return flash_attention_dkv_reference(q, k, v, do, lse, delta, causal)
    b, sq, skv, h, kvh, d = _geometry(q, k)
    q, k, v, do = _kernel_inputs("flash_attention_dkv", (q, k, v, do),
                                 q.dtype)
    lse, delta = _stats("flash_attention_dkv", (lse, delta), (b, h, sq))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = _stream(q)
    err = _library("flash_attention_dkv").kft_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        sq, skv, h, kvh, d, int(causal), 1.0 / math.sqrt(d),
        _DTYPE_CODE[q.dtype], stream)
    count_launch(flash_attention_dkv, stream)
    _raise_on(err, "flash_attention_dkv")
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# number of pointer arguments of each C entry; then int geometry (B, Sq,
# Skv, H, KV_H, D, causal), float scale, int dtype, stream
_N_POINTERS = {"flash_attention_fwd": 5, "flash_attention_dq": 7,
               "flash_attention_dkv": 8}


def _library(name: str):
    from kubeflow_tpu_torch.ops import cuda_build

    lib = cuda_build.load(name)
    fn = getattr(lib, f"kft_{name}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * _N_POINTERS[name]
                       + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def kernel_work(b: int, s: int, h: int, kvh: int, d: int, causal: bool,
                itemsize: int = 2) -> dict:
    """{kernel: (FLOPs, bytes)} of one launch of each kernel at this
    shape, as the kernels' bounds count them: 4, 6 and 8 x D FLOPs per
    (q, k) pair that meets the mask (forward: q.k^T and P.v; dQ adds dO.v^T
    and dS.k; dK/dV recomputes q.k^T and dO.v^T and accumulates P^T.dO and
    dS^T.q), and each input read once and each output written once."""
    pairs = (s * (s + 1) // 2 if causal else s * s) * b * h
    q = b * s * h * d * itemsize
    kv = b * s * kvh * d * itemsize
    stat = b * h * s * 4
    return {"flash_attention_fwd": (4 * d * pairs, 2 * q + 2 * kv + stat),
            "flash_attention_dq": (6 * d * pairs, 3 * q + 2 * kv + 2 * stat),
            "flash_attention_dkv": (8 * d * pairs,
                                    2 * q + 4 * kv + 2 * stat)}


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX kernel (pallas_attention.py:297-308)
    as an autograd Function: forward kernel, then delta in float32 and the
    dQ and dK/dV kernels in backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # delta = rowsum(dO * O) in float32, [B, S, H] -> [B, H, S]
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        do = do.to(q.dtype)
        dq = flash_attention_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                    block_kv: int = 512):
    """Flash attention. q: [B, S, H, D]; k/v: [B, S, KV_H, D] ->
    [B, S, H, D] in q's dtype, differentiable in q, k and v.

    ``block_q``/``block_kv`` are the JAX kernel's tiling knobs (its VMEM
    budget); they are checked and do not change the result. The CUDA
    kernels choose their own tiles (64-row query and KV blocks, sized
    for the SM's shared memory and registers, not for VMEM).
    """
    _check_shapes(q, k, v)
    if block_q <= 0 or block_kv <= 0:
        raise ValueError(f"block sizes must be positive, got {block_q}, "
                         f"{block_kv}")
    return FlashAttention.apply(q, k, v, bool(causal))

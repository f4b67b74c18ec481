"""The port's paged decode attention (``kubeflow_tpu_torch.ops.
paged_attention``) against the JAX package's Pallas kernel run in
interpret mode, mirroring tests/test_paged_attention_kernel.py.

On the CPU the port's wrapper runs its plain PyTorch version (CPU
tensors); the CUDA kernel itself is held against that plain version by
the ``cuda``-marked test, which skips where no GPU is visible, and by
chip_smoke.py on the card.

Tolerances: 2e-5 for float32 (the JAX kernel's online softmax and the
port's dense softmax sum in different orders), 2e-2 for bfloat16 (one
bf16 rounding of outputs of magnitude up to ~2).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.pallas_paged_attention import (
    paged_decode_attention as jax_paged,
)
from kubeflow_tpu_torch.ops import paged_attention as pa


def _pool_case(seed, b, h, kvh, d, bs, nbp, kv_len, num_blocks=None):
    """Random q/pools (numpy f32) plus a block table assigning each slot
    distinct permuted pool blocks for its kv_len rows."""
    rng = np.random.default_rng(seed)
    nb = num_blocks or (b * nbp + 1)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kvh, d)).astype(np.float32)
    tables = np.zeros((b, nbp), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    i = 0
    for s in range(b):
        nlive = -(-int(kv_len[s]) // bs)
        tables[s, :nlive] = perm[i:i + nlive]
        i += nlive
    return q, kp, vp, tables, np.asarray(kv_len, np.int32)


def _port(case, dtype=torch.float32, device="cpu"):
    q, kp, vp, tables, kv_len = case
    return pa.paged_decode_attention(
        torch.tensor(q, dtype=dtype, device=device),
        torch.tensor(kp, dtype=dtype, device=device),
        torch.tensor(vp, dtype=dtype, device=device),
        torch.tensor(tables, device=device),
        torch.tensor(kv_len, device=device))


def _jax(case, dtype=jnp.float32):
    q, kp, vp, tables, kv_len = case
    return np.asarray(jax_paged(
        jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
        jnp.asarray(vp, dtype), jnp.asarray(tables), jnp.asarray(kv_len),
        interpret=True).astype(jnp.float32))


def _assert_parity(case, rtol=2e-5, atol=2e-5):
    out = _port(case)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _jax(case), rtol=rtol, atol=atol)


def test_head_dim_64_groups_2():
    kv_len = [1, 7, 16, 17, 64]   # fresh, partial, exact-block, cross, full
    _assert_parity(_pool_case(0, b=5, h=4, kvh=2, d=64, bs=16, nbp=4,
                              kv_len=kv_len))


def test_serving_geometry():
    """llama3_8b's decode geometry at a small batch: H=32, KV=8, D=128,
    block 64."""
    _assert_parity(_pool_case(1, b=3, h=32, kvh=8, d=128, bs=64, nbp=3,
                              kv_len=[65, 130, 192]))


def test_ragged_lengths_and_idle_slots_give_zeros():
    """Ragged lengths INCLUDING len=0 idle slots (all-zero table rows):
    both kernels leave exact zeros there; live slots match."""
    kv_len = [0, 1, 5, 8, 9, 24, 0, 13]
    case = _pool_case(2, b=8, h=4, kvh=2, d=32, bs=8, nbp=3, kv_len=kv_len)
    out = _port(case).numpy()
    ref = _jax(case)
    idle = np.asarray(kv_len) == 0
    assert np.all(out[idle] == 0.0) and np.all(ref[idle] == 0.0)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_shared_prefix_blocks():
    """Two slots whose tables name the SAME pool blocks (the prefix-cache
    sharing case) both read them correctly."""
    q, kp, vp, tables, kv_len = _pool_case(3, b=2, h=4, kvh=2, d=32, bs=8,
                                           nbp=4, kv_len=[24, 24])
    tables = tables.copy()
    tables[1, :2] = tables[0, :2]
    _assert_parity((q, kp, vp, tables, kv_len))


def test_bf16_pool():
    case = _pool_case(4, b=3, h=4, kvh=2, d=64, bs=16, nbp=2,
                      kv_len=[9, 16, 30])
    out = _port(case, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               _jax(case, dtype=jnp.bfloat16),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kv_len", [[7, 8], [8, 9], [15, 17]])
def test_block_boundary_crossing(kv_len):
    """Lengths just below, at and past a block boundary (block 8)."""
    _assert_parity(_pool_case(5, b=2, h=4, kvh=2, d=16, bs=8, nbp=3,
                              kv_len=kv_len))


def test_rejects_bad_shapes():
    q, kp, vp, tables, kv_len = (torch.tensor(x) for x in _pool_case(
        6, b=2, h=4, kvh=2, d=32, bs=8, nbp=2, kv_len=[4, 4]))
    with pytest.raises(ValueError, match="multiple"):
        pa.paged_decode_attention(q[:, :3], kp, vp, tables, kv_len)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention(q[..., :16].contiguous(), kp, vp, tables,
                                  kv_len)
    with pytest.raises(ValueError, match="tables"):
        pa.paged_decode_attention(q, kp, vp, tables[:1], kv_len)
    with pytest.raises(ValueError, match="kv_len"):
        pa.paged_decode_attention(q, kp, vp, tables, kv_len[:1])


def test_kernel_geometry_limits():
    pa.check_kernel_geometry(128, 64, 4, torch.bfloat16)
    pa.check_kernel_geometry(64, 16, 2, torch.float32)
    for args, what in (((96, 64, 4), "head_dim"), ((128, 128, 4),
                       "block_size"), ((128, 64, 16), "H / KV_H"),
                       ((128, 64, 4, torch.float16), "bf16 or f32")):
        with pytest.raises(ValueError, match=what):
            pa.check_kernel_geometry(*args)


def _split_lengths(plan, bs, max_blocks):
    """The lengths where a split turns: 0, 1, one split's rows - 1, + 0,
    + 1, and a full table row."""
    rows = plan.blocks_per_split * bs
    return [0, 1, rows - 1, rows, rows + 1, max_blocks * bs]


def test_split_plan_depends_only_on_table_width_and_block_size():
    """The plan takes the table width and the block size, nothing of the
    batch, the heads or the lengths; it is a pure function of them, and
    the wrapper sizes the kernel's partials from it."""
    assert list(inspect.signature(pa.split_plan).parameters) == [
        "max_blocks", "block_size"]
    for max_blocks, bs in ((16, 64), (3, 8), (64, 16), (1, 1)):
        plan = pa.split_plan(max_blocks, bs)
        assert plan == pa.split_plan(max_blocks, bs)
        assert plan.blocks_per_split >= 1
        assert plan.n_split == -(-max_blocks // plan.blocks_per_split)
    for b, h, d, bs, max_blocks in ((8, 32, 128, 64, 16), (3, 4, 64, 8, 5)):
        plan, ws = pa._workspace(torch.zeros(b, h, d), bs, max_blocks)
        assert plan == pa.split_plan(max_blocks, bs)
        assert ws.dtype == torch.float32
        assert ws.numel() == b * h * plan.n_split * (d + 2)


@pytest.mark.parametrize("max_blocks,bs", [(16, 64), (5, 16), (3, 8),
                                           (7, 1), (1, 64)])
def test_split_plan_covers_every_live_block_once(max_blocks, bs):
    """Split s walks live blocks [s P, min((s + 1) P, n_live)) with n_live
    = min(ceil(kv_len / bs), max_blocks), as the kernel does: at the
    lengths where a split turns, every live block is walked by exactly
    one of the plan's splits and no split walks a dead one."""
    plan = pa.split_plan(max_blocks, bs)
    p = plan.blocks_per_split
    for kv_len in _split_lengths(plan, bs, max_blocks):
        n_live = min(-(-kv_len // bs), max_blocks)
        walked = [j for s in range(plan.n_split)
                  for j in range(s * p, min((s + 1) * p, n_live))]
        assert sorted(walked) == list(range(n_live)), (kv_len, walked)


def test_cpu_path_never_launches_the_kernel():
    before = pa.paged_decode_attention.launches
    _port(_pool_case(7, b=2, h=4, kvh=2, d=16, bs=8, nbp=2, kv_len=[3, 9]))
    assert pa.paged_decode_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, None)])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    """The hand-written CUDA kernel against its plain version on the card
    (ragged lengths, idle slot, block crossing, the serving geometry).
    f32: 2e-5 (sums in another order). bf16: both finish in f32 and round
    once, so each element is within one bf16 ulp of the plain value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    case = _pool_case(8, b=6, h=32, kvh=8, d=128, bs=64, nbp=16,
                      kv_len=[0, 1, 64, 65, 1000, 300])
    args = _cuda_args(case, dtype)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    ref = pa.paged_decode_attention_reference(*args)
    assert torch.all(out[0] == 0)
    if tol is None:
        # one bf16 ulp at |ref|: 2^(e-8) for |ref| in [2^(e-1), 2^e)
        _, e = torch.frexp(ref.float())
        ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)
        diff = (out.float() - ref.float()).abs()
        assert torch.all(diff <= ulp), (diff / ulp).max().item()
    else:
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), rtol=tol,
                                   atol=tol)


def _cuda_args(case, dtype):
    q, kp, vp, tables, kv_len = case
    return (torch.tensor(q, dtype=dtype, device="cuda"),
            torch.tensor(kp, dtype=dtype, device="cuda"),
            torch.tensor(vp, dtype=dtype, device="cuda"),
            torch.tensor(tables, device="cuda"),
            torch.tensor(kv_len, device="cuda"))


def _ulps(out, ref, floored=False):
    """|out - ref| in bf16 ulps of ref (2^(e-8) for |ref| in
    [2^(e-1), 2^e)); ``floored``: the ulp floored at 2^-8 x rms(ref), half
    a bf16 ulp at rms magnitude. Where float32 sums cancel to near zero
    the ulp is tiny and the summation order decides the rounding: one
    output in tens of thousands, of magnitude ~1e-6, can read several
    ulps, with the slot walked serially by one thread block (the kernel
    before its split) as with the split (tools/paged_split.py)."""
    ref = ref.float()
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), e - 8)
    if floored:
        ulp = torch.maximum(ulp, 2.0 ** -8 * ref.pow(2).mean().sqrt())
    return ((out.float() - ref).abs() / ulp).max().item()


def _quantize(pool, kv):
    """Per-block per-KV-head symmetric quantization of a [NB, bs, KV_H, D]
    f32 pool -> (int8 or fp8-e4m3 pool, f32 scales [NB, KV_H])."""
    qmax = 127.0 if kv == torch.int8 else 448.0
    scale = (pool.abs().amax(dim=(1, 3)) / qmax).clamp(min=1e-30)
    x = pool / scale[:, None, :, None]
    if kv == torch.int8:
        x = x.round().clamp(-qmax, qmax)
    return x.to(kv).contiguous(), scale.contiguous()


SPLIT_GEOM = dict(b=6, h=32, kvh=8, d=128, bs=64, nbp=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_at_split_boundaries(dtype):
    """The kernel against its plain version where a slot's walk turns from
    one split to the next (f32: 2e-5; bf16: one ulp of the plain value,
    floored at 2^-8 rms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    g = SPLIT_GEOM
    lens = _split_lengths(pa.split_plan(g["nbp"], g["bs"]), g["bs"], g["nbp"])
    args = _cuda_args(_pool_case(9, kv_len=lens, **g), dtype)
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_reference(*args)
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()
    if dtype == torch.bfloat16:
        assert _ulps(out, ref, floored=True) <= 1.0
    else:
        assert (out - ref).abs().max().item() <= 2e-5


def _one_and_eight(call, q, rest, tables, kv_len):
    """Each slot's row of a batch-of-8 call beside the same slot called
    alone."""
    whole = call(q, *rest, tables, kv_len)
    for b in range(q.shape[0]):
        alone = call(q[b:b + 1].contiguous(), *rest,
                     tables[b:b + 1].contiguous(), kv_len[b:b + 1].clone())
        torch.cuda.synchronize()
        assert torch.equal(alone[0], whole[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_slot_output_is_the_same_alone_and_in_a_batch_of_8(dtype):
    """A slot's output does not depend on which other slots share its
    launch: bitwise equal in a batch of 1 and in a batch of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    lens = [0, 1, 127, 128, 129, 1024, 300, 1000]
    q, kp, vp, tables, kv_len = _cuda_args(_pool_case(
        10, b=8, h=32, kvh=8, d=128, bs=64, nbp=16, kv_len=lens), dtype)
    _one_and_eight(
        lambda q, kp, vp, t, n: pa.paged_decode_attention(q, kp, vp, t, n),
        q, (kp, vp), tables, kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [torch.int8, torch.float8_e4m3fn])
def test_cuda_quant_slot_output_is_the_same_alone_and_in_a_batch_of_8(kv):
    """The fused-dequant entry likewise, with q in bf16; and at the split
    lengths within one bf16 ulp (floored at 2^-8 rms) of its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    lens = [0, 1, 127, 128, 129, 1024, 300, 1000]
    q, kp, vp, tables, kv_len = _cuda_args(_pool_case(
        11, b=8, h=32, kvh=8, d=128, bs=64, nbp=16, kv_len=lens),
        torch.float32)
    (kq, ks), (vq, vs) = _quantize(kp, kv), _quantize(vp, kv)
    q = q.to(torch.bfloat16)
    call = lambda q, kq, vq, t, n: pa.paged_decode_attention(
        q, kq, vq, t, n, k_scale=ks, v_scale=vs)
    _one_and_eight(call, q, (kq, vq), tables, kv_len)
    out = call(q, kq, vq, tables, kv_len)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_reference(q, kq, vq, tables, kv_len,
                                              k_scale=ks, v_scale=vs)
    assert torch.all(out[0] == 0) and _ulps(out, ref, floored=True) <= 1.0

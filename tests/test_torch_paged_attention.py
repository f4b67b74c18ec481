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

"""The port's flash attention (``kubeflow_tpu_torch.ops.flash_attention``)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as its own tests run it; float32, numpy-seeded inputs through both.

On the CPU the port's autograd Function calls the plain versions of the
three kernels, so these tests exercise the same autograd wiring the card
runs with the CUDA kernels. Those are held against the plain versions by
the ``cuda``-marked tests (they skip here) and by ``chip_smoke.py``.

Tolerances: 2e-5 on values and 5e-5 on gradients, as
``tests/test_pallas_attention.py`` holds the JAX kernel to its einsum
reference: both sides compute in float32 and differ only in the order of
sums (blockwise online softmax against one dense softmax).
"""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import pallas_attention as jpa
from kubeflow_tpu_torch.ops import flash_attention as tfa

VAL_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def warm_up_cpu_exp():
    """Run one large ``torch.exp`` on the CPU before any comparison.

    The CPU build's float32 ``exp`` goes through MKL's vector math, which
    splits a call across its threads. On the first such call of a process
    on a loaded machine, one thread's share can come out with about 1.5e-4
    relative error instead of 6e-8 (seen on 7 of 48 fresh processes running
    8 at once, and on none of 48 after this call). Later calls are exact.
    The plain forward takes exp of the scores, so without this call the
    first comparison of a worker process could miss by up to 1e-4."""
    torch.exp(torch.zeros(1 << 20))


warm_up_cpu_exp()


def _qkv(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(b, s, h, d), f(b, s, kvh, d), f(b, s, kvh, d), f(b, s, h, d)


def _port(q, k, v, w, causal):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=causal)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), (qt, kt, vt))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax(q, k, v, w, causal, block_q, block_kv):
    def f(q, k, v):
        return jpa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                   block_kv=block_kv, interpret=True)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(w)),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _compare(port, ref):
    np.testing.assert_allclose(port[0], ref[0], **VAL_TOL)
    for a, b, name in zip(port[1], ref[1], "qkv"):
        np.testing.assert_allclose(a, b, **GRAD_TOL,
                                   err_msg=f"d{name} mismatch")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 2)])
def test_value_and_grads_match_jax_kernel(causal, h, kvh):
    q, k, v, w = _qkv(0, 2, 64, h, kvh, 32)
    _compare(_port(q, k, v, w, causal), _jax(q, k, v, w, causal, 16, 16))


@pytest.mark.parametrize("s", [33, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_unaligned_seq_lengths(s, causal):
    """The JAX wrapper pads to block multiples and masks the pad; the
    port has no padding copy and must give the same values."""
    q, k, v, w = _qkv(1, 1, s, 4, 2, 32)
    _compare(_port(q, k, v, w, causal), _jax(q, k, v, w, causal, 32, 32))


@pytest.mark.parametrize("block_q,block_kv", [(32, 16), (16, 32)])
def test_uneven_blocks(block_q, block_kv):
    """block_q != block_kv on the JAX side (the diagonal is not tiled
    evenly); the port's result does not depend on the block knobs."""
    q, k, v, w = _qkv(2, 1, 64, 2, 2, 32)
    port = _port(q, k, v, w, True)
    _compare(port, _jax(q, k, v, w, True, block_q, block_kv))
    out = tfa.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), block_q=block_q,
                              block_kv=block_kv)
    np.testing.assert_array_equal(out.numpy(), port[0])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_jax_fwd_and_bwd(causal):
    """Each plain version (forward with lse, dQ, dK/dV) against the JAX
    package's `_fwd` and `_bwd` on the same residuals."""
    b, s, h, kvh, d = 2, 64, 4, 2, 32
    q, k, v, do = _qkv(3, b, s, h, kvh, d)
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    o_j, lse8 = jpa._fwd(tr(q), tr(k), tr(v), causal, 16, 16, s, True)
    lse_j = lse8[:, :, 0, :]
    o_t, lse_t = tfa.flash_attention_fwd_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal)
    np.testing.assert_allclose(o_t.numpy(),
                               np.asarray(o_j.transpose(0, 2, 1, 3)),
                               **VAL_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **VAL_TOL)

    dq_j, dk_j, dv_j = jpa._bwd(causal, 16, 16, s, True,
                                (tr(q), tr(k), tr(v), o_j, lse_j), tr(do))
    back = lambda x: np.asarray(x.transpose(0, 2, 1, 3))
    # the same residuals on the port's side: o and lse from JAX, delta
    # from them as `_bwd` computes it
    o_np = back(o_j)
    delta = torch.tensor((do * o_np).sum(-1)).transpose(1, 2).contiguous()
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v),
            torch.tensor(do), torch.tensor(np.asarray(lse_j)), delta)
    dq_t = tfa.flash_attention_dq_reference(*args, causal=causal)
    dk_t, dv_t = tfa.flash_attention_dkv_reference(*args, causal=causal)
    np.testing.assert_allclose(dq_t.numpy(), back(dq_j), **GRAD_TOL)
    np.testing.assert_allclose(dk_t.numpy(), back(dk_j), **GRAD_TOL)
    np.testing.assert_allclose(dv_t.numpy(), back(dv_j), **GRAD_TOL)


def test_wrappers_run_plain_versions_on_the_cpu_without_counting():
    q, k, v, do = (torch.tensor(x) for x in _qkv(4, 1, 40, 4, 2, 64))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_dq.launches,
              tfa.flash_attention_dkv.launches)
    o, lse = tfa.flash_attention_fwd(q, k, v)
    ref_o, ref_lse = tfa.flash_attention_fwd_reference(q, k, v)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert lse.shape == (1, 4, 40) and lse.dtype == torch.float32
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    dq = tfa.flash_attention_dq(q, k, v, do, lse, delta)
    dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_dq.launches,
            tfa.flash_attention_dkv.launches) == before


def test_bf16_inputs_keep_their_dtype():
    q, k, v, _ = (torch.tensor(x).to(torch.bfloat16)
                  for x in _qkv(5, 1, 32, 4, 2, 32))
    q.requires_grad_()
    out = tfa.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert q.grad.dtype == torch.bfloat16


def test_rejects_bad_shapes_and_devices():
    q, k, v, _ = (torch.tensor(x) for x in _qkv(6, 1, 32, 4, 3, 32))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k, v)
    q, k, v, _ = (torch.tensor(x) for x in _qkv(6, 1, 32, 4, 2, 32))
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.check_kernel_geometry(96)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tfa.check_kernel_geometry(128, torch.float16)
    tfa.check_kernel_geometry(64, torch.bfloat16)


def test_kernel_build_needs_nvcc():
    """Without nvcc the build raises: there is no fallback toolchain."""
    from kubeflow_tpu_torch.ops import cuda_build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: the build would run")
    if cuda_build.library_path("flash_attention_fwd").exists():
        pytest.skip("a built library is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.load("flash_attention_fwd")


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _cuda_case(dtype, s=200, causal=True, h=8, kvh=2, d=128):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    q, k, v, do = _qkv(7, 2, s, h, kvh, d)
    cuda = lambda x: torch.tensor(x, device="cuda").to(dtype)
    q, k, v, do = cuda(q), cuda(k), cuda(v), cuda(do)
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _bf16_limit(ref):
    """One bf16 ulp of the plain value per element (both round once from
    float32), floored at 2^-8 x the plain tensor's rms for elements where
    float32 sums cancel to near zero."""
    _, e = torch.frexp(ref.float())
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)
    return torch.maximum(ulp, ref.float().pow(2).mean().sqrt() / 256)


def _check(out, ref, dtype):
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        # float32 sums of up to S terms in another order
        assert diff.max().item() <= 1e-4
    else:
        assert (diff <= _bf16_limit(ref)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_fwd_kernel_matches_plain_version(dtype, causal):
    q, k, v, _, _, _ = _cuda_case(dtype, causal=causal)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    ref_o, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    _check(o, ref_o, dtype)
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dq_kernel_matches_plain_version(dtype):
    args = _cuda_case(dtype)
    _check(tfa.flash_attention_dq(*args),
           tfa.flash_attention_dq_reference(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dkv_kernel_matches_plain_version(dtype):
    args = _cuda_case(dtype, d=64)
    for out, ref in zip(tfa.flash_attention_dkv(*args),
                        tfa.flash_attention_dkv_reference(*args)):
        _check(out, ref, dtype)


def test_scale_is_one_over_sqrt_head_dim():
    """A plain check of the shared convention: uniform keys give uniform
    probabilities, so the output is the mean of v whatever the scale."""
    v = torch.arange(8.0).reshape(1, 8, 1, 1).expand(1, 8, 2, 64).contiguous()
    q = torch.ones(1, 8, 2, 64)
    k = torch.ones(1, 8, 2, 64)
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal=False)
    assert torch.allclose(o, torch.full_like(o, 3.5))
    assert torch.allclose(lse, torch.full_like(lse, 64 / math.sqrt(64)
                                               + math.log(8)))

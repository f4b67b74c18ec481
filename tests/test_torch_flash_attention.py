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
from kubeflow_tpu_torch.tools import flash_parity as fp

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

def _cuda_case(dtype, s=200, causal=True, h=8, kvh=2, d=128, b=2):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    q, k, v, do = _qkv(7, b, s, h, kvh, d)
    cuda = lambda x: torch.tensor(x, device="cuda").to(dtype)
    q, k, v, do = cuda(q), cuda(k), cuda(v), cuda(do)
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _check(out, ref):
    """float32: within 1e-4 of the plain version (float32 sums of up to S
    terms in another order)."""
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_fwd_kernel_matches_plain_version(dtype, causal):
    """float32: O and lse within 1e-4 of the plain version. bf16: limits
    (a) and (b) of the parity contract and lse within 1e-4, read and
    judged by ``tools/flash_parity.py`` as ``chip_smoke.py`` phase 5
    holds them."""
    case = _cuda_case(dtype, causal=causal)
    if dtype == torch.bfloat16:
        r = fp.forward_readings(case, causal)["flash_attention_fwd"]
        assert fp.passes(r), fp.describe(r)
        return
    q, k, v = case[:3]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    ref_o, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    _check(o, ref_o)
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_fwd_kernel_is_deterministic(causal):
    """Remat "dots" runs the forward twice per micro batch: two launches
    on the same inputs give bitwise equal O and lse."""
    q, k, v = _cuda_case(torch.bfloat16, s=1000, causal=causal, h=16,
                         kvh=8)[:3]
    o1, lse1 = tfa.flash_attention_fwd(q, k, v, causal)
    o2, lse2 = tfa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def _check_backward(args, causal, dtype, kernels):
    """float32: each output of ``kernels`` within 1e-4 of the plain
    version. bf16: limits (a) and (b) of the parity contract, read and
    judged by ``tools/flash_parity.py`` as ``chip_smoke.py`` phase 5
    holds them."""
    if dtype == torch.bfloat16:
        readings = fp.backward_readings(args, causal)
        for name in kernels:
            assert fp.passes(readings[name]), (name,
                                               fp.describe(readings[name]))
        return
    if "flash_attention_dq" in kernels:
        _check(tfa.flash_attention_dq(*args, causal),
               tfa.flash_attention_dq_reference(*args, causal))
    if "flash_attention_dkv" in kernels:
        for out, ref in zip(tfa.flash_attention_dkv(*args, causal),
                            tfa.flash_attention_dkv_reference(*args,
                                                              causal)):
            _check(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dq_kernel_matches_plain_version(dtype):
    _check_backward(_cuda_case(dtype), True, dtype, ["flash_attention_dq"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dkv_kernel_matches_plain_version(dtype):
    _check_backward(_cuda_case(dtype, d=64), True, dtype,
                    ["flash_attention_dkv"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["train", "unaligned"])
def test_cuda_backward_kernels_at_main_path_shapes(shape, dtype):
    """The training shape (B=2, S=2048, H=16, KV_H=8, D=128, causal) and
    the unaligned non-causal S=1000 with G=4."""
    s, h, kvh, causal = {"train": (2048, 16, 8, True),
                         "unaligned": (1000, 16, 4, False)}[shape]
    args = _cuda_case(dtype, s=s, causal=causal, h=h, kvh=kvh)
    _check_backward(args, causal, dtype,
                    ["flash_attention_dq", "flash_attention_dkv"])


# ---------------------------------------------------------------------------
# The parity contract's rounding points, on the CPU
# ---------------------------------------------------------------------------

GROUPS = [1, 2, 4]     # G = H / KV_H with H = 4


def _bf16_case(seed, s, g, d, causal):
    """bf16 q, k, v, dO (numpy-seeded) with lse and delta from the plain
    forward, H = 4 and KV_H = 4 / G."""
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16)
                   for x in _qkv(seed, 1, s, 4, 4 // g, d))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("causal", [True, False])
def test_operand_dtype_none_is_the_float32_plain_output(causal, g):
    """``operand_dtype=None`` is bitwise the plain version as it was
    before the option: dS . k, P^T . dO and dS^T . q on float32 P and
    dS."""
    args = _bf16_case(10, 96, g, 32, causal)
    q, k = args[0], args[1]
    p, ds, qf, dof = tfa._dscores(*args, causal)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dq = dq.reshape(q.shape).to(q.dtype)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf).to(k.dtype)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof).to(k.dtype)
    assert torch.equal(tfa.flash_attention_dq_reference(
        *args, causal, operand_dtype=None), dq)
    got_k, got_v = tfa.flash_attention_dkv_reference(*args, causal,
                                                     operand_dtype=None)
    assert torch.equal(got_k, dk) and torch.equal(got_v, dv)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 1024])
def test_bf16_rounding_of_p_and_ds_stays_under_limit_b(s, causal, g):
    """P and dS rounded to bf16 where the kernels round them move dQ, dK
    and dV by less than limit (b) (rms relative) from the float32 plain
    version, which is the JAX function."""
    args = _bf16_case(11, s, g, 64, causal)
    rounded = [tfa.flash_attention_dq_reference(
        *args, causal, operand_dtype=torch.bfloat16),
        *tfa.flash_attention_dkv_reference(*args, causal,
                                           operand_dtype=torch.bfloat16)]
    plain = [tfa.flash_attention_dq_reference(*args, causal),
             *tfa.flash_attention_dkv_reference(*args, causal)]
    for got, ref, name in zip(rounded, plain, ("dq", "dk", "dv")):
        err = fp.rms_rel(got, ref)
        assert 0 < err <= fp.BF16_RMS_LIMIT, (name, err)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("causal", [True, False])
def test_float64_order_with_same_rounding_is_within_limit_a(causal, g):
    """What limit (a) holds a kernel to: a version that sums in another
    order (float64) but rounds P and dS at the same points lands within
    one bf16 ulp (floored at 2^-8 rms) plus the near-tie allowance of the
    plain version with ``operand_dtype=torch.bfloat16``."""
    args = _bf16_case(12, 512, g, 64, causal)
    plain = [tfa.flash_attention_dq_reference(
        *args, causal, operand_dtype=torch.bfloat16),
        *tfa.flash_attention_dkv_reference(*args, causal,
                                           operand_dtype=torch.bfloat16)]
    allow = fp.tie_allowances(args, causal)
    allow = allow["flash_attention_dq"] + allow["flash_attention_dkv"]
    for got, ref, a, name in zip(fp.float64_ordered(*args, causal), plain,
                                 allow, ("dq", "dk", "dv")):
        assert fp.ulp_ratio(got, ref, a) <= 1.0, name


@pytest.mark.parametrize("causal", [True, False])
def test_f32_inputs_are_unaffected_by_operand_rounding(causal):
    """The float32 kernels keep P and dS in float32: for f32 inputs the
    plain version rounded to float32 is bitwise the plain version, and
    the wrappers on the CPU give it."""
    args = tuple(torch.tensor(x) for x in _qkv(13, 1, 80, 4, 2, 32))
    o, lse = tfa.flash_attention_fwd_reference(*args[:3], causal)
    delta = (args[3] * o).sum(-1).transpose(1, 2).contiguous()
    args = (*args, lse, delta)
    dq = tfa.flash_attention_dq_reference(*args, causal)
    dk, dv = tfa.flash_attention_dkv_reference(*args, causal)
    assert torch.equal(tfa.flash_attention_dq_reference(
        *args, causal, operand_dtype=torch.float32), dq)
    k32, v32 = tfa.flash_attention_dkv_reference(
        *args, causal, operand_dtype=torch.float32)
    assert torch.equal(k32, dk) and torch.equal(v32, dv)
    assert torch.equal(tfa.flash_attention_dq(*args, causal), dq)
    assert all(torch.equal(a, b) for a, b in
               zip(tfa.flash_attention_dkv(*args, causal), (dk, dv)))


# ---------------------------------------------------------------------------
# The forward's rounding points, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_operand_dtype_none_is_the_dense_float32_plain_output(causal, g):
    """``operand_dtype=None`` (and the default) is bitwise the dense float32
    forward the JAX package computes: q pre-scaled, one softmax over all
    KV rows, P float32."""
    q, k, v = _bf16_case(14, 96, g, 32, causal)[:3]
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, d) * (1.0 / math.sqrt(d))
    sc = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    sc = torch.where(tfa._mask(s, s, causal, "cpu"), sc,
                     torch.tensor(tfa.NEG_INF))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    lc = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / lc
    o = o.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)
    lse = (m + torch.log(lc))[..., 0].reshape(b, h, s)
    for got in (tfa.flash_attention_fwd_reference(q, k, v, causal),
                tfa.flash_attention_fwd_reference(q, k, v, causal,
                                                  operand_dtype=None)):
        assert torch.equal(got[0], o) and torch.equal(got[1], lse)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 1000])
def test_fwd_bf16_rounding_of_p_stays_under_limit_b(s, causal, g):
    """P rounded to bf16 where the forward kernel rounds it (against the
    running max of a walk over 64-wide KV blocks) moves O by less than
    the forward's limit (b) (rms relative) from the float32 plain
    version, which is the JAX function; lse stays within its limit."""
    q, k, v = _bf16_case(15, s, g, 64, causal)[:3]
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal,
                                               operand_dtype=torch.bfloat16)
    ref_o, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    err = fp.rms_rel(o, ref_o)
    assert 0 < err <= fp.FWD_RMS_LIMIT, err
    assert (lse - ref_lse).abs().max().item() <= fp.LSE_TOL


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_float64_order_with_same_rounding_is_within_limit_a(causal, g):
    """What limit (a) holds the forward kernel to: a walk that sums the
    products, l and O in float64 but rounds P at the same points lands
    within one bf16 ulp (floored at 2^-8 rms) plus the near-tie allowance
    of the plain version with ``operand_dtype=torch.bfloat16``."""
    q, k, v = _bf16_case(16, 512, g, 64, causal)[:3]
    rounded, allow = fp.forward_rounded(q, k, v, causal)
    plain, _ = tfa.flash_attention_fwd_reference(
        q, k, v, causal, operand_dtype=torch.bfloat16)
    assert torch.equal(rounded, plain)
    control = tfa._fwd_walk(q, k, v, causal, torch.bfloat16, wide=True)[0]
    assert fp.ulp_ratio(control, rounded, allow) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_f32_inputs_are_unaffected_by_operand_dtype(causal):
    """The float32 forward keeps P in float32: for f32 inputs
    ``operand_dtype=torch.float32`` is bitwise the plain version, the
    wrapper on the CPU gives it, and the walk over 64-wide KV blocks with
    P unrounded agrees with it to float32 summation order."""
    q, k, v = (torch.tensor(x) for x in _qkv(17, 1, 200, 4, 2, 32)[:3])
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal)
    o32, lse32 = tfa.flash_attention_fwd_reference(
        q, k, v, causal, operand_dtype=torch.float32)
    assert torch.equal(o32, o) and torch.equal(lse32, lse)
    got = tfa.flash_attention_fwd(q, k, v, causal)
    assert torch.equal(got[0], o) and torch.equal(got[1], lse)
    walk_o, walk_lse, _ = tfa._fwd_walk(q, k, v, causal, torch.float32)
    torch.testing.assert_close(walk_o, o, **VAL_TOL)
    torch.testing.assert_close(walk_lse, lse, **VAL_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_plain_version_with_operand_dtype_matches_jax_fwd(causal):
    """The plain forward at ``operand_dtype=None`` against the JAX
    package's `_fwd` in interpret mode (float32, to 2e-5); the same
    inputs through the walk that rounds P to bf16 stay within the
    forward's limit (b) of it, and its lse within its limit."""
    b, s, h, kvh, d = 2, 128, 4, 2, 32
    q, k, v, _ = _qkv(18, b, s, h, kvh, d)
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    o_j, lse8 = jpa._fwd(tr(q), tr(k), tr(v), causal, 16, 16, s, True)
    o_j = np.asarray(o_j.transpose(0, 2, 1, 3))
    lse_j = np.asarray(lse8[:, :, 0, :])
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v), causal)
    o_t, lse_t = tfa.flash_attention_fwd_reference(*args, operand_dtype=None)
    np.testing.assert_allclose(o_t.numpy(), o_j, **VAL_TOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, **VAL_TOL)
    o_b, lse_b = tfa.flash_attention_fwd_reference(
        *args, operand_dtype=torch.bfloat16)
    assert 0 < fp.rms_rel(o_b, torch.tensor(o_j)) <= fp.FWD_RMS_LIMIT
    assert np.abs(lse_b.numpy() - lse_j).max() <= fp.LSE_TOL


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

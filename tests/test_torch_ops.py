"""The PyTorch port's plain ops against the JAX package's, on the CPU in
float32: the same numpy-seeded inputs go through both.

Tolerance 1e-5 (absolute and relative): single ops in float32, where the
two frameworks differ only in summation order and in the last ulp of
exp/sin/cos.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import norms as j_norms
from kubeflow_tpu.ops import rotary as j_rotary
from kubeflow_tpu_torch.ops import attention as t_attn
from kubeflow_tpu_torch.ops import norms as t_norms
from kubeflow_tpu_torch.ops import rotary as t_rotary

# the JAX package's ops/__init__ re-exports the function `attention`,
# which shadows the submodule of the same name
j_attn = importlib.import_module("kubeflow_tpu.ops.attention")

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 5, 64), _rand(rng, 64)
    _close(t_norms.rms_norm(torch.tensor(x), torch.tensor(w), 1e-5),
           j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("scaling", [None, "llama3"])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_rope_frequencies(scaling, head_dim):
    a = t_rotary.rope_frequencies(head_dim, 500000.0, scaling,
                                  original_max_seq=128)
    b = j_rotary.rope_frequencies(head_dim, 500000.0, scaling,
                                  original_max_seq=128)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scaling", [None, "llama3"])
def test_apply_rope(scaling):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 9, 4, 32)
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    inv = j_rotary.rope_frequencies(32, 10000.0, scaling,
                                    original_max_seq=64)
    _close(t_rotary.apply_rope(torch.tensor(x), torch.tensor(pos),
                               torch.tensor(inv)),
           j_rotary.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                               jnp.asarray(inv)))


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("causal,offset", [
    (False, 0), (True, 0), (True, 5), (True, "per_slot")])
def test_xla_attention(h, kvh, causal, offset):
    rng = np.random.default_rng(2)
    b, sq, skv, d = 3, 6, 11, 16
    q, k, v = _rand(rng, b, sq, h, d), _rand(rng, b, skv, kvh, d), \
        _rand(rng, b, skv, kvh, d)
    if offset == "per_slot":
        offset = np.array([0, 3, 5], np.int32)
        t_off, j_off = torch.tensor(offset), jnp.asarray(offset)
    else:
        t_off = j_off = offset
    out = t_attn._xla_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal,
                                q_offset=t_off)
    ref = j_attn._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                q_offset=j_off)
    assert out.shape == (b, sq, h, d) and out.dtype == torch.float32
    _close(out, ref)


def test_attention_dispatch_keeps_switch_values(monkeypatch):
    """"flash" and "pallas" both route to the flash-attention path (the
    same function as "xla"), and refuse a q_offset as the JAX dispatcher
    does."""
    from kubeflow_tpu_torch.ops import flash_attention as t_flash

    rng = np.random.default_rng(3)
    q = torch.tensor(_rand(rng, 1, 4, 2, 8))
    out = t_attn.attention(q, q, q, causal=True, impl="xla")
    assert out.shape == q.shape
    routed = []
    real = t_flash.FlashAttention.apply
    monkeypatch.setattr(t_flash.FlashAttention, "apply",
                        lambda *a: routed.append(1) or real(*a))
    for impl in ("flash", "pallas"):
        _close(t_attn.attention(q, q, q, impl=impl), out)
        with pytest.raises(ValueError, match="q_offset"):
            t_attn.attention(q, q, q, impl=impl, q_offset=3)
    assert len(routed) == 2
    with pytest.raises(ValueError, match="attn_impl"):
        t_attn.attention(q, q, q, impl="vortex")


@pytest.mark.parametrize("h,kvh", [(4, 2), (8, 8)])
def test_decode_attention(h, kvh):
    rng = np.random.default_rng(4)
    b, s, d = 4, 20, 32
    q = _rand(rng, b, 1, h, d)
    kc, vc = _rand(rng, b, s, kvh, d), _rand(rng, b, s, kvh, d)
    lens = np.array([1, 7, 20, 13], np.int32)
    _close(t_attn.decode_attention(torch.tensor(q), torch.tensor(kc),
                                   torch.tensor(vc), torch.tensor(lens)),
           j_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(lens)))


def test_bf16_inputs_cast_back():
    rng = np.random.default_rng(5)
    x = torch.tensor(_rand(rng, 2, 3, 2, 8)).to(torch.bfloat16)
    assert t_attn._xla_attention(x, x, x, causal=True).dtype == torch.bfloat16
    w = torch.ones(8, dtype=torch.bfloat16)
    assert t_norms.rms_norm(x, w).dtype == torch.bfloat16
    inv = torch.tensor(t_rotary.rope_frequencies(8, scaling=None))
    pos = torch.arange(3)[None, :].expand(2, 3)
    assert t_rotary.apply_rope(x, pos, inv).dtype == torch.bfloat16

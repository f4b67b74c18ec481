"""The port's quantized serving path (``serving/quant.py``, the quantized
branches of ``serving/paged_kv.py`` and ``models/llama.py``, the
fused-dequant paged decode kernel's plain version, the engine, stats and
the runtime's env contract) against the JAX package on the CPU, in
float32, on the same weights (converted by ``interop.params_from_jax``).

Tolerances, each with its reason:

- ``quantize_weights``, the pool write path and the dequant view: EXACT.
  Both packages run the same IEEE operations in the same order on the
  same inputs (amax, one division, round half to even, clip, cast).
- The kernel's plain version against the JAX quantized kernel in
  interpret mode: rtol = atol = 2e-5, the unquantized parity limit (two
  softmax implementations summing in different orders over the same f32
  dequantized values). The plain quantized version equals the plain
  unquantized version over the f32 dequant view EXACTLY (it is that
  function).
- Decode step and chunked prefill: logits within 1e-5. Pool payloads
  within ONE quantization step (adjacent int8 values, adjacent fp8
  codes): the K/V rows entering the quantizer come out of two layers of
  f32 arithmetic summed in other orders, so a value a last-ulp away from
  a rounding boundary may land on the neighbouring step, as the JAX
  package's own lockstep test allows. Scales within 1e-6 relative (an
  amax of those rows over 127 or 448).
- Engine streams: token for token; only at the first divergence, a near
  tie is accepted when both tokens are within 1e-3 of the maximum of the
  JAX quantized path's logits at that position (``_jax_quant_logits``
  replays it at batch 1; 1e-3 covers the replay's other summation order
  and a quantized element landing on its neighbouring step, which moves
  a logit of this model by ~1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.ops.pallas_paged_attention import (
    paged_decode_attention as jax_paged,
)
from kubeflow_tpu.serving import paged_kv as j_kv
from kubeflow_tpu.serving import quant as j_quant
from kubeflow_tpu.serving.llm import LLMEngine as JEngine
from kubeflow_tpu.serving.llm import SamplingParams as JSampling
from kubeflow_tpu.serving.scheduler import QuantConfig as JQuant
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.ops import paged_attention as pa
from kubeflow_tpu_torch.serving import paged_kv as t_kv
from kubeflow_tpu_torch.serving import quant as t_quant
from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serving.scheduler import QuantConfig, SchedulerConfig

from test_torch_paged_attention import _pool_case

KV_DTYPES = {"int8": (jnp.int8, 127.0), "fp8_e4m3": (jnp.float8_e4m3fn,
                                                     448.0)}
STEP_LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
TIE_MARGIN = 1e-3


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def tiny_q(tiny):
    """The int8 trees: JAX's quantize_weights, carried into the port."""
    jcfg, jp, tcfg, _ = tiny
    jq = j_quant.quantize_weights(jp, jcfg)
    return jq, interop.params_from_jax(jax.device_get(jq), device="cpu")


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def _bytes(x) -> np.ndarray:
    """Stored bytes of a JAX array or port tensor (int8, fp8, f32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            x = x.view(torch.uint8)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype == ml_dtypes.float8_e4m3fn else x


def _steps_apart(a, b, kv: str) -> np.ndarray:
    """How many quantization steps apart two stored payloads are: int8
    values, or fp8 codes (same-sign adjacent e4m3 values are adjacent
    codes)."""
    a, b = _bytes(a), _bytes(b)
    if kv == "int8":
        return np.abs(a.astype(np.int32) - b.astype(np.int32))
    sign = lambda c: np.where(c & 0x80, -1, 1) * (c & 0x7F).astype(np.int32)
    return np.abs(sign(a) - sign(b))


# ------------------------------------------------------ weights, config --

@pytest.mark.parametrize("tied", [True, False])
def test_quantize_weights_matches_jax_exactly(tied):
    """int8 payloads and f32 scales bit for bit, tied and untied heads;
    the full-precision names are gone; MoE is refused."""
    jcfg = dataclasses.replace(jl.llama_tiny(dtype=jnp.float32),
                               tie_embeddings=tied)
    jp = jl.init_params(jax.random.key(1), jcfg)
    tcfg = interop.config_from_jax(jcfg)
    tp = interop.params_from_jax(jax.device_get(jp), device="cpu")
    want = dict(_leaves(jax.device_get(j_quant.quantize_weights(jp, jcfg))))
    got = dict(_leaves(t_quant.quantize_weights(tp, tcfg)))
    assert got.keys() == want.keys()
    assert ("lm_head_q" in got) == (not tied)
    for key, val in want.items():
        assert got[key].dtype == interop.torch_dtype(val.dtype), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(val),
                                      err_msg=key)
    qp = t_quant.quantize_weights(tp, tcfg)
    assert t_quant.is_weight_quantized(qp)
    assert not t_quant.is_weight_quantized(tp)
    assert "wq" not in qp["layers"] and "embed" not in qp
    with pytest.raises(ValueError, match="MoE"):
        t_quant.quantize_weights(tp, dataclasses.replace(tcfg, n_experts=2))


_RESOLVE_CASES = {
    "none": None,
    "all-none": dict(),
    "exact_parity": dict(kv_dtype="int8", weight_dtype="int8",
                         exact_parity=True),
    "int8/int8": dict(kv_dtype="int8", weight_dtype="int8"),
    "fp8": dict(kv_dtype="fp8_e4m3"),
    "fp8/int8": dict(kv_dtype="fp8_e4m3", weight_dtype="int8"),
}


def _resolved(pair):
    eff, downs = pair
    return ((eff.kv_dtype, eff.weight_dtype, eff.exact_parity, eff.tag()),
            [tuple(d) for d in downs])


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("case", list(_RESOLVE_CASES))
def test_resolve_quant_matches_jax(case, moe):
    """The same effective config and downgrade list as the JAX resolver,
    dense and MoE (whose int8 weights downgrade with a reason)."""
    kw = _RESOLVE_CASES[case]
    jcfg = jl.llama_tiny()
    if moe:
        jcfg = jl.llama_moe_8x(jcfg, n_experts=2)
    tcfg = interop.config_from_jax(jcfg)
    want = j_quant.resolve_quant(None if kw is None else JQuant(**kw),
                                 cfg=jcfg)
    got = t_quant.resolve_quant(None if kw is None else QuantConfig(**kw),
                                cfg=tcfg)
    assert _resolved(got) == _resolved(want)


def test_fp8_downgrade_is_counted(monkeypatch):
    """Without an fp8 dtype the request resolves to unquantized KV with a
    counted, logged reason; unknown strings are rejected outright."""
    monkeypatch.setattr(t_quant, "fp8_unsupported_reason",
                        lambda platform=None: "no fp8 here")
    eff, downs = t_quant.resolve_quant(QuantConfig(kv_dtype="fp8_e4m3"))
    assert eff == QuantConfig() and downs == [("kv_dtype=fp8_e4m3",
                                               "no fp8 here")]
    with pytest.raises(ValueError, match="kv_dtype"):
        t_quant.resolve_quant(QuantConfig(kv_dtype="int4"))
    with pytest.raises(ValueError, match="weight_dtype"):
        t_quant.resolve_quant(QuantConfig(weight_dtype="fp8_e4m3"))


# ------------------------------------------------------ pool write path --

@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quant_scatter_rows_and_view_match_jax(kv):
    """A sequence of quantize-on-write scatters with growing amplitude
    (scale growth requantizes resident rows) and duplicate block entries:
    payload bytes and scales equal the JAX write path's outside the
    scratch block 0; the dequant view equals JAX's."""
    jdt, _ = KV_DTYPES[kv]
    rng = np.random.default_rng(3)
    jpool = jnp.zeros((6, 8, 2, 16), jdt)
    jscale = jnp.zeros((6, 2), jnp.float32)
    tpool = torch.zeros((6, 8, 2, 16), dtype=t_quant.kv_store_dtype(kv))
    tscale = torch.zeros((6, 2))
    writes = [([1, 2, 0], [0, 0, 3]), ([1, 1, 3], [1, 2, 0]),
              ([2, 0, 1], [1, 5, 3]), ([4, 4, 4], [0, 1, 2]),
              ([1, 3, 0], [4, 1, 5])]
    for step, (blk, off) in enumerate(writes):
        rows = (rng.standard_normal((3, 2, 16)) * 4.0 ** step).astype(
            np.float32)
        jpool, jscale = j_kv.quant_scatter_rows(
            jpool, jscale, jnp.asarray(blk), jnp.asarray(off),
            jnp.asarray(rows))
        out = t_kv.quant_scatter_rows(tpool, tscale, torch.tensor(blk),
                                      torch.tensor(off), torch.tensor(rows))
        assert out[0] is tpool and out[1] is tscale      # in place
        np.testing.assert_array_equal(_bytes(tpool)[1:], _bytes(jpool)[1:])
        np.testing.assert_array_equal(tscale.numpy()[1:],
                                      np.asarray(jscale)[1:])
    assert np.asarray(jscale)[1].min() > 0 and not tscale[5].any()
    tables = np.array([[1, 2, 3], [4, 0, 0]], np.int32)
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    want = j_kv.dequant_gather_view(jpool, jscale, jnp.asarray(tables), jcfg)
    got = t_kv.dequant_gather_view(tpool, tscale, torch.tensor(tables),
                                   interop.config_from_jax(jcfg))
    live = np.asarray(tables)[:, :, None].repeat(8, 2).reshape(2, -1) > 0
    np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quantized_insert_batch_matches_jax(tiny, kv):
    """Quantize-on-insert with poisoned pad rows past each request's
    length (zeroed before the amax), a skipped shared block (id 0) and a
    pad row (slot -1): payload bytes and scales equal JAX's outside
    block 0, lengths as JAX writes them (mirrors
    tests/test_quant.py::test_quantized_insert_batch_masks_pad_rows)."""
    jcfg, _, tcfg, _ = tiny
    L, kvh, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jcache = j_kv.init_paged_cache(jcfg, 3, 32, 8, 9, quant_kv=kv)
    tcache = t_kv.init_paged_cache(tcfg, 3, 32, 8, 9, device="cpu",
                                   quant_kv=kv)
    assert set(tcache) == set(jcache)
    rng = np.random.default_rng(1)
    k_new = rng.standard_normal((L, 3, 16, kvh, hd)).astype(np.float32)
    v_new = rng.standard_normal((L, 3, 16, kvh, hd)).astype(np.float32)
    k_new[:, 0, 5:] = 1e6
    v_new[:, 0, 5:] = -1e6
    blk = np.array([[1, 2], [0, 4], [0, 0]], np.int32)
    lengths = np.array([5, 16, 0], np.int32)
    slots = np.array([0, 2, -1], np.int32)
    jcache = j_kv.paged_insert_batch(
        jcache, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(blk),
        jnp.asarray(lengths), jnp.asarray(slots))
    t_kv.paged_insert_batch(tcache, torch.tensor(k_new), torch.tensor(v_new),
                            torch.tensor(blk), torch.tensor(lengths),
                            torch.tensor(slots))
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bytes(tcache[key])[:, 1:],
                                      _bytes(jcache[key])[:, 1:])
    assert tcache["k"].dtype == t_quant.kv_store_dtype(kv)
    assert float(tcache["k_scale"][:, 1].max()) < 1.0   # not the poison
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()


# ---------------------------------------------------- the kernel's plain --

def _quantize_pool(pool, kv):
    """Per-block per-kv-head symmetric quantization of an f32 pool with
    JAX (tests/test_quant.py's helper) -> (stored pool, scale [NB, KVH])."""
    jdt, qmax = KV_DTYPES[kv]
    pool = jnp.asarray(pool)
    scale = jnp.maximum(jnp.max(jnp.abs(pool), axis=(1, 3)) / qmax, 1e-30)
    q = pool / scale[:, None, :, None]
    if kv == "int8":
        q = jnp.clip(jnp.round(q), -qmax, qmax)
    return q.astype(jdt), scale.astype(jnp.float32)


def _quant_case(kv, seed, **kw):
    q, kp, vp, tables, kv_len = _pool_case(seed, **kw)
    kq, ks = _quantize_pool(kp, kv)
    vq, vs = _quantize_pool(vp, kv)
    return q, kq, vq, ks, vs, tables, kv_len


def _to_port(arrays):
    return [interop.params_from_jax({"x": jax.device_get(a)},
                                    device="cpu")["x"] for a in arrays]


_KERNEL_CASES = {
    # tests/test_quant.py:93-131: ragged / idle / boundary lengths, GQA
    "ragged": dict(seed=10, b=8, h=4, kvh=2, d=32, bs=8, nbp=3,
                   kv_len=[0, 1, 5, 8, 9, 24, 0, 13]),
    "gqa": dict(seed=11, b=5, h=4, kvh=2, d=64, bs=16, nbp=4,
                kv_len=[1, 7, 16, 17, 64]),
    "serving-geometry": dict(seed=12, b=3, h=8, kvh=2, d=128, bs=64, nbp=3,
                             kv_len=[0, 65, 130]),
}


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", list(_KERNEL_CASES))
def test_quant_plain_version_matches_jax_kernel(case, kv):
    """The quantized kernel's plain version against the JAX quantized
    Pallas kernel (interpret mode) on the same stored pools and scales,
    and EXACTLY the plain unquantized version over the f32 dequant view;
    idle slots are zeros and the CPU path launches no kernel."""
    kw = dict(_KERNEL_CASES[case])
    q, kq, vq, ks, vs, tables, kv_len = _quant_case(kv, kw.pop("seed"), **kw)
    want = jax_paged(jnp.asarray(q), kq, vq, jnp.asarray(tables),
                     jnp.asarray(kv_len), interpret=True, k_scale=ks,
                     v_scale=vs)
    tq, tkq, tvq, tks, tvs = _to_port([q, kq, vq, ks, vs])
    args = (tq, tkq, tvq, torch.tensor(tables), torch.tensor(kv_len))
    before = (pa.paged_decode_attention.launches,
              pa.paged_decode_attention_quant.launches)
    got = pa.paged_decode_attention(*args, k_scale=tks, v_scale=tvs)
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention_quant.launches) == before
    assert got.dtype == torch.float32
    live = kv_len > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=2e-5, atol=2e-5)
    assert not got.numpy()[~live].any()
    kd = tkq.float() * tks[:, None, :, None]
    vd = tvq.float() * tvs[:, None, :, None]
    plain = pa.paged_decode_attention_reference(tq, kd, vd, *args[3:])
    assert torch.equal(got, plain)


def test_quant_scale_validation():
    """The JAX wrapper's errors: both scales or neither, each [NB, KV_H]
    (tests/test_quant.py:109-121)."""
    q, kq, vq, ks, vs, tables, kv_len = _quant_case(
        "int8", 12, b=2, h=4, kvh=2, d=32, bs=8, nbp=2, kv_len=[4, 4])
    tq, tkq, tvq, tks, tvs = _to_port([q, kq, vq, ks, vs])
    args = (tq, tkq, tvq, torch.tensor(tables), torch.tensor(kv_len))
    with pytest.raises(ValueError, match="scale"):
        pa.paged_decode_attention(*args, k_scale=tks)
    with pytest.raises(ValueError, match="scale"):
        pa.paged_decode_attention(*args, k_scale=tks[:, :1], v_scale=tvs)
    with pytest.raises(ValueError, match="scale"):
        pa.paged_decode_attention_reference(*args, v_scale=tvs)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quant_kernel_matches_plain_version(kv, dtype):
    """The fused-dequant CUDA kernel against its plain version on the card
    (serving geometry, ragged lengths, an idle slot). f32: 2e-5, and
    bitwise the unquantized kernel over the f32 dequant view. bf16: one
    bf16 ulp of the plain value (both finish in f32 and round once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    q, kq, vq, ks, vs, tables, kv_len = _quant_case(
        kv, 8, b=6, h=32, kvh=8, d=128, bs=64, nbp=16,
        kv_len=[0, 1, 64, 65, 1000, 300])
    tq, tkq, tvq, tks, tvs = (t.cuda() for t in _to_port([q, kq, vq, ks,
                                                         vs]))
    tq = tq.to(dtype)
    args = (tq, tkq, tvq, torch.tensor(tables, device="cuda"),
            torch.tensor(kv_len, device="cuda"))
    before = pa.paged_decode_attention_quant.launches
    out = pa.paged_decode_attention(*args, k_scale=tks, v_scale=tvs)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention_quant.launches == before + 1
    ref = pa.paged_decode_attention_reference(*args, k_scale=tks,
                                              v_scale=tvs)
    assert torch.all(out[0] == 0)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 2e-5
        kd = (tkq.float() * tks[:, None, :, None]).contiguous()
        vd = (tvq.float() * tvs[:, None, :, None]).contiguous()
        assert torch.equal(out, pa.paged_decode_attention(tq, kd, vd,
                                                          *args[3:]))
    else:
        _, e = torch.frexp(ref.float())
        ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)
        assert torch.all(diff <= ulp)


# ---------------------------------------------- decode step, prefill chunk --

def _quant_pools(jcfg, tcfg, kv, max_batch=3, max_seq=32, bs=8, nb=13):
    """Identical quantized pools in both packages: random resident KV
    inserted by the JAX insert path, carried over byte for byte."""
    jpk = j_kv.PagedKV(cfg=jcfg, max_batch=max_batch, max_seq=max_seq,
                       block_size=bs, num_blocks=nb, quant_kv=kv)
    tpk = t_kv.PagedKV(cfg=tcfg, max_batch=max_batch, max_seq=max_seq,
                       block_size=bs, num_blocks=nb, device="cpu",
                       quant_kv=kv)
    rng = np.random.default_rng(0)
    L, kvh, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    kn = rng.standard_normal((L, 1, (nb - 1) * bs, kvh, hd)).astype(
        np.float32)
    vn = rng.standard_normal(kn.shape).astype(np.float32)
    blk = np.arange(1, nb, dtype=np.int32)[None]
    jcache = j_kv.paged_insert_batch(
        jpk.cache, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(blk),
        jnp.asarray([0], jnp.int32), jnp.asarray([-1], jnp.int32))
    # length 0 zeroes every row: insert real rows through a full length
    jcache = j_kv.paged_insert_batch(
        jcache, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(blk),
        jnp.asarray([kn.shape[2]], jnp.int32), jnp.asarray([-1], jnp.int32))
    tcache = {k: v.clone() for k, v in interop.params_from_jax(
        jax.device_get(jcache), device="cpu").items()}
    assert tcache["k"].dtype == t_quant.kv_store_dtype(kv)
    return jpk, tpk, dict(jcache), tcache


def _compare_pools(tcache, jcache, kv, blocks=slice(1, None)):
    for key in ("k", "v"):
        apart = _steps_apart(tcache[key][:, blocks], jcache[key][:, blocks],
                             kv)
        assert apart.max() <= 1, (key, apart.max())
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tcache[key].numpy()[:, blocks],
                                   np.asarray(jcache[key])[:, blocks],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("kernel", ["auto", "gather"])
def test_quant_decode_step_matches_jax(tiny, tiny_q, kernel, kv):
    """Decode steps over a quantized pool with int8 weights: one slot
    crosses a block boundary (7 -> 8 -> 9 with block 8) while another sits
    idle. Port "auto" (the fused-dequant kernel's plain version) faces
    the JAX quantized kernel in interpret mode, "gather" the JAX gather
    oracle."""
    jcfg, _, tcfg, _ = tiny
    jq, tq = tiny_q
    jpk, tpk, jcache, tcache = _quant_pools(jcfg, tcfg, kv)
    for pk in (jpk, tpk):
        assert pk.reserve(0, 7, 8) is not None
        assert pk.reserve(2, 3, 8) is not None     # slot 1 stays idle
    jcache["len"] = jnp.asarray([7, 0, 3], jnp.int32)
    tcache["len"] = torch.tensor([7, 0, 3], dtype=torch.int32)
    jtab, ttab = jnp.asarray(jpk.tables), torch.tensor(tpk.tables)
    tok = np.array([5, 0, 9], np.int32)
    live = [0, 2]
    for _ in range(3):
        jlog, jcache = j_kv.paged_decode_step(
            jq, jnp.asarray(tok), jcfg, jcache, jtab,
            kernel="pallas" if kernel == "auto" else "gather")
        tlog, tcache = t_kv.paged_decode_step(
            tq, torch.tensor(tok), tcfg, tcache, ttab, kernel=kernel)
        np.testing.assert_allclose(tlog.numpy()[live],
                                   np.asarray(jlog)[live], **STEP_LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    _compare_pools(tcache, jcache, kv)


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quant_prefill_chunk_matches_jax(tiny, tiny_q, kv):
    """Two chunks of a long prompt into a quantized pool (quantize-on-
    write, dequant view), the second with a radix-shared prefix masked to
    scratch: the hidden row and the slot's blocks match the JAX chunk."""
    jcfg, _, tcfg, _ = tiny
    jq, tq = tiny_q
    jpk, tpk = (j_kv.PagedKV(cfg=jcfg, max_batch=2, max_seq=32,
                             block_size=4, num_blocks=17, quant_kv=kv),
                t_kv.PagedKV(cfg=tcfg, max_batch=2, max_seq=32,
                             block_size=4, num_blocks=17, device="cpu",
                             quant_kv=kv))
    for pk in (jpk, tpk):
        assert pk.reserve(1, 13, 4) is not None
    prompt = np.random.default_rng(1).integers(1, 250, 13).astype(np.int32)
    jcache, tcache = jpk.cache, tpk.cache
    jtab, ttab = jnp.asarray(jpk.tables), torch.tensor(tpk.tables)
    for offset, share in ((0, 0), (8, 4)):
        piece = np.zeros((1, 8), np.int32)
        part = prompt[offset:offset + 8]
        piece[0, :len(part)] = part
        jx, jcache = j_kv.paged_prefill_chunk(
            jq, jnp.asarray(piece), jcfg, jcache, jtab, 1, offset, 13, share)
        tx, tcache = t_kv.paged_prefill_chunk(
            tq, torch.tensor(piece), tcfg, tcache, ttab, 1, offset, 13,
            share)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                   **STEP_LOGIT_TOL)
    _compare_pools(tcache, jcache, kv, blocks=tpk.slot_blocks(1))


# ---------------------------------------------------------------- engine --

def _jax_quant_logits(jq, jcfg, kv, prompt, gen, buckets, bs):
    """The JAX quantized serving path's logits for generated token
    ``len(gen)`` of one request, replayed at batch 1 with the engine's
    own steps: bucketed prefill + quantize-on-insert (or chunked prefill
    for a prompt past the largest bucket), then quantized decode steps
    over ``gen``."""
    from kubeflow_tpu.serving.paged_kv import blocks_for

    n = len(prompt)
    nb = blocks_for(max(n + len(gen) + 1, buckets[-1]), bs)
    cache = j_kv.init_paged_cache(jcfg, 1, nb * bs, bs, nb + 1, quant_kv=kv)
    tables = jnp.arange(1, nb + 1, dtype=jnp.int32)[None]
    if n <= buckets[-1]:
        bucket = next(b for b in buckets if n <= b)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prompt
        logits, filled = jl.prefill(jq, jnp.asarray(toks), jcfg,
                                    jl.init_cache(jcfg, 1, bucket),
                                    lengths=jnp.asarray([n], jnp.int32))
        blk = np.zeros((1, bucket // bs), np.int32)
        blk[0, :blocks_for(n, bs)] = np.arange(1, blocks_for(n, bs) + 1)
        cache = j_kv.paged_insert_batch(
            cache, filled["k"], filled["v"], jnp.asarray(blk),
            jnp.asarray([n], jnp.int32), jnp.asarray([0], jnp.int32))
    else:
        w = buckets[-1]
        for off in range(0, n, w):
            piece = np.zeros((1, w), np.int32)
            part = prompt[off:off + w]
            piece[0, :len(part)] = part
            x_last, cache = j_kv.paged_prefill_chunk(
                jq, jnp.asarray(piece), jcfg, cache, tables, 0, off, n, 0)
        logits = j_kv._lm_head(jq, x_last, jcfg)
        cache["len"] = jnp.asarray([n], jnp.int32)
    for tok in gen:
        logits, cache = j_kv.paged_decode_step(
            jq, jnp.asarray([tok], jnp.int32), jcfg, cache, tables,
            kernel="gather")
    return np.asarray(logits[0])


def _assert_same_quant_stream(jq, jcfg, kv, prompt, ours, theirs, buckets,
                              bs):
    assert len(ours) == len(theirs), (ours, theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if a == b:
            continue
        logits = _jax_quant_logits(jq, jcfg, kv, prompt, ours[:i], buckets,
                                   bs)
        top = logits.max()
        assert logits[a] >= top - TIE_MARGIN and \
            logits[b] >= top - TIE_MARGIN, (prompt, i, ours, theirs)
        return


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quant_engine_streams_match_jax(tiny, tiny_q, kv):
    """int8 weights with int8 or fp8 KV through both engines (the JAX one
    with synchronous decode, ROADMAP queue 3): mixed prompt lengths over
    two buckets plus a prompt longer than the largest (chunked prefill
    with quantize-on-write). The port quantizes the f32 tree itself; the
    JAX engine quantizes its own."""
    jcfg, jp, tcfg, tp = tiny
    jq, _ = tiny_q
    q = dict(kv_dtype=kv, weight_dtype="int8")
    kw = dict(max_batch=4, max_seq=64, prefill_buckets=(8, 16),
              decode_chunk=3)
    je = JEngine(jp, jcfg, decode_pipeline=False, kernel="gather",
                 quant=JQuant(**q), **kw)
    te = LLMEngine(tp, tcfg, device="cpu", quant=QuantConfig(**q), **kw)
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [3, 1, 4, 1, 5, 9, 2, 6, 5],
               [(7 * i) % 250 + 1 for i in range(40)]]
    jr = je.generate(prompts, JSampling(max_tokens=7))
    tr = te.generate(prompts, SamplingParams(max_tokens=7))
    assert te.cache["k"].dtype == t_quant.kv_store_dtype(kv)
    assert t_quant.is_weight_quantized(te.params)
    assert te.sched.chunked_admitted == je.sched.chunked_admitted == 1
    for p, a, b in zip(prompts, tr, jr):
        assert a.finish_reason == b.finish_reason == "length"
        _assert_same_quant_stream(jq, jcfg, kv, p, a.generated, b.generated,
                                  (8, 16), te.paged.block_size)


def test_exact_parity_is_structural(tiny):
    """quant=None, QuantConfig() and exact_parity=True build the same
    engine: no _q/_s keys, no scale tables, identical streams and pools
    (tests/test_quant.py::test_exact_parity_is_structural_and_bitwise)."""
    _, _, tcfg, tp = tiny
    runs = []
    for q in (None, QuantConfig(), QuantConfig(exact_parity=True),
              QuantConfig(kv_dtype="int8", weight_dtype="int8",
                          exact_parity=True)):
        eng = LLMEngine(tp, tcfg, max_batch=2, max_seq=64,
                        prefill_buckets=(16,), device="cpu", quant=q)
        reqs = eng.generate([[5, 6, 7, 8, 5, 6, 7], [9, 10, 11, 9, 10]],
                            SamplingParams(max_tokens=8))
        assert "k_scale" not in eng.cache
        assert not any(k.endswith(("_q", "_s"))
                       for k, _ in _leaves(eng.params))
        assert eng.quant.tag() == "quant=off" and eng.quant_downgrades == 0
        runs.append((eng, [r.generated for r in reqs]))
    base_eng, base = runs[0]
    for eng, toks in runs[1:]:
        assert toks == base
        for key in ("k", "v"):
            assert torch.equal(eng.cache[key], base_eng.cache[key])


# ------------------------------------------------- stats and entry points --

def test_stats_expose_active_quant_and_downgrades(tiny):
    """stats()["quant"] as the JAX LLMModel's
    (tests/test_quant.py::test_stats_expose_active_quant_and_downgrades)."""
    from kubeflow_tpu_torch.serving import LLMModel

    _, _, tcfg, tp = tiny
    model = LLMModel("q", tp, tcfg, max_batch=2, max_seq=64,
                     prefill_buckets=(16,), device="cpu",
                     quant=QuantConfig(kv_dtype="int8", weight_dtype="int8"))
    model.load()
    try:
        st = model.stats()
        assert st["quant"] == {"kv_dtype": "int8", "weight_dtype": "int8",
                               "exact_parity": False,
                               "active": "quant=kv:int8,w:int8",
                               "requested": "quant=kv:int8,w:int8"}
        assert st["quant_downgrades_total"] == 0
        assert st["kernel_downgrades_total"] == 0
    finally:
        model.unload()


def test_fp8_downgrade_reaches_engine_counters(tiny, monkeypatch):
    """A downgrade is counted on both surfaces and the engine serves
    unquantized."""
    _, _, tcfg, tp = tiny
    monkeypatch.setattr(t_quant, "fp8_unsupported_reason",
                        lambda platform=None: "no fp8 here")
    eng = LLMEngine(tp, tcfg, max_batch=2, max_seq=64, prefill_buckets=(16,),
                    device="cpu", quant=QuantConfig(kv_dtype="fp8_e4m3"))
    assert eng.quant_downgrades == 1 and eng.kernel_downgrades == 1
    assert "k_scale" not in eng.cache
    reqs = eng.generate([[5, 6, 7]], SamplingParams(max_tokens=3))
    assert len(reqs[0].generated) == 3


def test_scheduler_embedded_quant_reaches_engine(tiny):
    """SchedulerConfig.quant is honored when the engine gets no explicit
    quant= argument; an explicit one wins."""
    _, _, tcfg, tp = tiny
    sched = SchedulerConfig()
    sched.quant = QuantConfig(kv_dtype="int8")
    eng = LLMEngine(tp, tcfg, max_batch=2, max_seq=64, prefill_buckets=(16,),
                    device="cpu", scheduler=sched)
    assert eng.cache["k"].dtype == torch.int8
    assert eng.quant.tag() == "quant=kv:int8,w:none"
    eng = LLMEngine(tp, tcfg, max_batch=2, max_seq=64, prefill_buckets=(16,),
                    device="cpu", scheduler=sched,
                    quant=QuantConfig(kv_dtype="fp8_e4m3"))
    assert eng.cache["k"].dtype == torch.float8_e4m3fn


def test_runtime_serves_quantized_from_env(tmp_path):
    """The runtime with KFT_FORCE_PLATFORM=cpu, KFT_QUANT_KV=int8 and
    KFT_QUANT_WEIGHTS=int8 builds a quantized model and answers one
    request over HTTP."""
    from test_torch_serving import _fixture_checkpoint

    from kubeflow_tpu_torch.serving import (
        InferenceClient, InferRequest, InferTensor, ModelRepository,
        ModelServer,
    )
    from kubeflow_tpu_torch.serving.runtime import build_model_from_env

    env = {"KFT_MODEL_NAME": "tiny", "KFT_MODEL_DIR":
           _fixture_checkpoint(tmp_path), "KFT_DTYPE": "float32",
           "KFT_MAX_BATCH": "2", "KFT_MAX_SEQ": "64",
           "KFT_FORCE_PLATFORM": "cpu", "KFT_QUANT_KV": "int8",
           "KFT_QUANT_WEIGHTS": "int8"}
    model = build_model_from_env(env)
    repo = ModelRepository()
    repo.register(model)
    srv = ModelServer(repo).start()
    try:
        out = InferenceClient(srv.url).infer(InferRequest(
            "tiny", [InferTensor("text", [1], "BYTES", ["hello world"])],
            parameters={"max_tokens": 4}))
        assert int(out.as_numpy("lengths")[0]) >= 1
        st = model.stats()
        assert st["quant"]["active"] == "quant=kv:int8,w:int8"
        assert model.engine.cache["k"].dtype == torch.int8
        assert t_quant.is_weight_quantized(model.engine.params)
    finally:
        srv.stop()
        model.unload()


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_interop_carries_quantized_arrays_bit_for_bit(kind):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32) * 100
    arr = (np.clip(np.round(x), -127, 127).astype(np.int8) if kind == "int8"
           else x.astype(ml_dtypes.float8_e4m3fn))
    out = interop.params_from_jax({"w": arr, "s": x}, device="cpu",
                                  dtype=torch.bfloat16)
    assert out["w"].dtype == (torch.int8 if kind == "int8"
                              else torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bytes(out["w"]), _bytes(arr))
    assert out["s"].dtype == torch.bfloat16
    assert interop.torch_dtype(arr.dtype) == out["w"].dtype

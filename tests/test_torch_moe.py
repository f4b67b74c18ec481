"""The port's Mixture-of-Experts (``kubeflow_tpu_torch.parallel.moe`` and the
MoE paths of the model, engine, checkpoint reader and trainer) against the
JAX package's on the CPU in float32, on numpy-seeded inputs and weights
carried over from the JAX tree by ``interop.params_from_jax``.

Tolerances, each from float32 sums taken in another order:
- the MoE layer: outputs 1e-5 absolute, aux losses 1e-6 relative (one
  router product, one softmax, a few sums), the dropped fraction exactly
  (it counts integers);
- its gradients: 1e-5 (the same products run backwards);
- the 2-layer MoE model's logits, prefill cache and ``moe_aux``: 1e-4, as
  test_torch_llama (two layers of matmuls and softmaxes);
- the trainer: as test_torch_training (loss 1e-5 relative, grad norm
  1e-4 relative, parameters 2e-5 absolute), ``moe_aux`` 1e-5 relative;
- the engines: greedy streams token for token, logprobs 1e-4;
- the checkpoint reader: the tree bit for bit (both read the same f32
  bytes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu.models import hf_llama as j_hf
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel import moe as j_moe
from kubeflow_tpu.parallel.mesh import single_device_mesh
from kubeflow_tpu.serving.llm import LLMEngine as JEngine
from kubeflow_tpu.serving.llm import SamplingParams as JSampling
from kubeflow_tpu.serving.scheduler import SchedulerConfig as JSched
from kubeflow_tpu.training import data as j_data
from kubeflow_tpu.training import trainer as j_trainer
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import hf_llama as t_hf
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel import moe as t_moe
from kubeflow_tpu_torch.serving import InferRequest, InferTensor
from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serving.scheduler import SchedulerConfig
from kubeflow_tpu_torch.serving.torch_model import LLMModel
from kubeflow_tpu_torch.training import optim as t_optim
from kubeflow_tpu_torch.training import trainer as t_trainer
from test_torch_flash_attention import warm_up_cpu_exp

LAYER_TOL = dict(rtol=0, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=0)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact


def _layer_pair(capacity_factor, top_k=2, seed=0):
    kw = dict(dim=16, mlp_dim=32, n_experts=4, top_k=top_k,
              capacity_factor=capacity_factor)
    jc, tc = j_moe.MoEConfig(**kw), t_moe.MoEConfig(**kw)
    jp = j_moe.init_moe_params(jax.random.key(seed), jc)
    return jc, jp, tc, interop.params_from_jax(jax.device_get(jp),
                                               device="cpu")


def _inputs(seed=1, shape=(2, 6, 16), masked=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    mask = rng.random(shape[:2]) > 0.3 if masked else None
    return x, mask


# capacity_factor, top_k, the capacity (None: from the factor), masked
LAYER_CASES = {
    "dropless": (0.0, 2, None, True),
    "dropless_unmasked": (0.0, 2, None, False),
    "capacity": (1.25, 2, None, True),
    "capacity_drops": (0.3, 2, None, True),
    "capacity_given_top1": (1.25, 1, 2, True),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_layer_matches_jax(case):
    """Both dispatch paths with a token mask: outputs, aux losses and the
    dropped fraction (nonzero where the capacity drops choices)."""
    cf, k, capacity, masked = LAYER_CASES[case]
    jc, jp, tc, tp = _layer_pair(cf, top_k=k)
    x, mask = _inputs(masked=masked)
    jy, jaux = j_moe.moe_layer(
        jp, jnp.asarray(x), jc, capacity=capacity,
        token_mask=None if mask is None else jnp.asarray(mask))
    ty, taux = t_moe.moe_layer(
        tp, torch.tensor(x), tc, capacity=capacity,
        token_mask=None if mask is None else torch.tensor(mask))
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    assert set(taux) == set(jaux)
    for key in ("moe_load_balance", "moe_router_z"):
        np.testing.assert_allclose(taux[key].item(), float(jaux[key]),
                                   **AUX_TOL)
    dropped = taux["moe_dropped_fraction"].item()
    assert dropped == float(jaux["moe_dropped_fraction"])
    assert (dropped > 0) == (case in ("capacity_drops",
                                      "capacity_given_top1"))
    np.testing.assert_allclose(
        t_moe.moe_aux_total(taux).item(),
        float(j_moe.moe_aux_total(jaux)), **AUX_TOL)
    if masked:
        # masked rows take no expert on the dropless path
        rows = ty.reshape(-1, 16)[~torch.tensor(mask).reshape(-1)]
        if cf <= 0:
            assert torch.count_nonzero(rows) == 0


class _HostReads(TorchDispatchMode):
    """Records the ops that read a device value back to the host or give
    a shape that depends on the data: a captured CUDA graph cannot hold
    them."""

    BANNED = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
              "_unique2", "is_nonzero")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in self.BANNED:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cf", [0.0, 1.25])
def test_moe_layer_never_reads_back_to_the_host(cf):
    """Forward and backward of both paths run no op that synchronises
    with the host or makes a data-dependent shape (both captured programs
    replay this body)."""
    _, _, tc, tp = _layer_pair(cf)
    x, mask = _inputs(seed=3)
    tx = torch.tensor(x, requires_grad=True)
    with _HostReads() as mode:
        y, aux = t_moe.moe_layer(tp, tx, tc, token_mask=torch.tensor(mask))
        (y.sum() + t_moe.moe_aux_total(aux)).backward()
    assert mode.seen == []


def test_top_k_breaks_ties_to_the_lower_index():
    """Rows with exact ties (and an all-equal row): lax.top_k's values and
    indices, where torch.topk promises no order among equals."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.5, 0.0],
                      [0.7, 0.1, 0.1, 0.1]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = t_moe.top_k(torch.tensor(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf", [0.0, 1.25, 0.3])
def test_moe_layer_gradients_match_jax(cf):
    """d(sum(y^2) + load balance + z-loss) by every weight and the input,
    against jax.grad, on both paths."""
    jc, jp, tc, tp = _layer_pair(cf)
    x, mask = _inputs(seed=2)

    def jloss(p, x):
        y, aux = j_moe.moe_layer(p, x, jc, token_mask=jnp.asarray(mask))
        return jnp.sum(y ** 2) + j_moe.moe_aux_total(aux)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    for v in tp.values():
        v.requires_grad_(True)
    y, aux = t_moe.moe_layer(tp, tx, tc, token_mask=torch.tensor(mask))
    (y.square().sum() + t_moe.moe_aux_total(aux)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    for key, g in jg.items():
        np.testing.assert_allclose(tp[key].grad.numpy(), np.asarray(g),
                                   err_msg=key, **GRAD_TOL)
    assert tp["router"].grad.abs().sum() > 0        # the router learns


def test_init_params_layout_draws_and_generator():
    """The MoE tree has the JAX tree's keys and shapes, the JAX package's
    fan-ins (std 1/sqrt(fan_in)), lands in the asked dtype, and one seed
    gives one tree; init_moe_params likewise."""
    jcfg = jl.llama_moe_8x(jl.llama_tiny(), n_experts=4)
    tcfg = tl.llama_moe_8x(tl.llama_tiny(), n_experts=4)
    assert tcfg.moe_config() == t_moe.MoEConfig(
        dim=64, mlp_dim=128, n_experts=4, top_k=2, capacity_factor=1.25,
        dtype=torch.bfloat16)
    want = jax.eval_shape(lambda: jl.init_params(jax.random.key(0), jcfg))
    p1 = tl.init_params(torch.Generator().manual_seed(5), tcfg,
                        device="cpu", dtype=torch.bfloat16)
    p2 = tl.init_params(torch.Generator().manual_seed(5), tcfg,
                        device="cpu", dtype=torch.bfloat16)
    assert set(p1["layers"]) == set(want["layers"])
    for key, leaf in want["layers"].items():
        assert tuple(p1["layers"][key].shape) == leaf.shape, key
        assert p1["layers"][key].dtype == torch.bfloat16
        assert torch.equal(p1["layers"][key], p2["layers"][key])
    assert tl.param_shapes(tcfg)["layers"]["w_down"] == (2, 4, 128, 64)
    assert tl.param_logical_axes(tcfg)["layers"]["w_gate"] == \
        jl.param_logical_axes(jcfg)["layers"]["w_gate"]
    for key, fan in (("moe_router", 64), ("w_gate", 64), ("w_up", 64),
                     ("w_down", 128)):
        std = p1["layers"][key].float().std().item() * fan ** 0.5
        assert 0.9 < std < 1.1, (key, std)
    mp = t_moe.init_moe_params(torch.Generator().manual_seed(0),
                               tcfg.moe_config(), device="cpu")
    jmp = jax.eval_shape(lambda: j_moe.init_moe_params(
        jax.random.key(0), jcfg.moe_config()))
    assert {k: tuple(v.shape) for k, v in mp.items()} == \
        {k: v.shape for k, v in jmp.items()}
    assert t_moe.moe_param_logical_axes(tcfg.moe_config()) == \
        j_moe.moe_param_logical_axes(jcfg.moe_config())


# ------------------------------------------------------------ the model --

@pytest.fixture(scope="module")
def tiny_moe():
    jcfg = jl.llama_tiny(n_experts=4, dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("cf", [1.25, 0.0])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_forward_logits_and_aux_match_jax(tiny_moe, remat, cf):
    """forward(return_aux=True) under every remat mode, both dispatch
    paths: logits and the layers' summed penalties, and gradients of
    both through the remat wrapper."""
    jcfg, jp, tcfg, tp = tiny_moe
    jcfg = dataclasses.replace(jcfg, remat=remat, moe_capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, remat=remat, moe_capacity_factor=cf)
    toks = _tokens(1, 2, 24, jcfg.vocab_size)

    def jloss(p):
        logits, aux = jl.forward(p, jnp.asarray(toks), jcfg,
                                 return_aux=True)
        return jnp.mean(logits ** 2) + aux["moe_aux"], (logits, aux)

    jg, (jlog, jaux) = jax.grad(jloss, has_aux=True)(jp)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tp["layers"].items()}
    params = {**tp, "layers": leaves}
    tlog, taux = tl.forward(params, torch.tensor(toks), tcfg,
                            return_aux=True)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               **MODEL_TOL)
    np.testing.assert_allclose(taux["moe_aux"].item(),
                               float(jaux["moe_aux"]), **MODEL_TOL)
    (tlog.square().mean() + taux["moe_aux"]).backward()
    for key, g in jg["layers"].items():
        np.testing.assert_allclose(leaves[key].grad.numpy(), np.asarray(g),
                                   err_msg=key, **MODEL_TOL)
    # a dense config's aux is 0
    dense = tl.llama_tiny(dtype=torch.float32)
    dp = tl.init_params(torch.Generator().manual_seed(0), dense,
                        device="cpu")
    _, daux = tl.forward(dp, torch.tensor(toks), dense, return_aux=True)
    assert daux["moe_aux"].item() == 0.0


def test_prefill_ragged_lengths_matches_jax(tiny_moe):
    """Ragged prompts: positions past each length do not route (they
    would take capacity from real tokens), so logits and cache match the
    JAX prefill, which masks the same way."""
    jcfg, jp, tcfg, tp = tiny_moe
    toks = _tokens(2, 3, 16, jcfg.vocab_size)
    lengths = np.array([16, 5, 1], np.int32)
    jlog, jcache = jl.prefill(jp, jnp.asarray(toks), jcfg,
                              jl.init_cache(jcfg, 3, 16),
                              lengths=jnp.asarray(lengths))
    tlog, tcache = tl.prefill(tp, torch.tensor(toks), tcfg,
                              tl.init_cache(tcfg, 3, 16, device="cpu"),
                              lengths=torch.tensor(lengths))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL_TOL)
    np.testing.assert_array_equal(tcache["len"].numpy(), lengths)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **MODEL_TOL)


# ---------------------------------------------------------- the trainer --

def test_trainer_three_steps_match_jax():
    """llama_tiny with 4 experts (capacity path, adamw, grad_accum 2, a
    mask): per step the loss (with moe_aux added), the grad norm and the
    moe_aux metric; the parameters after three steps."""
    jcfg = jl.llama_tiny(n_experts=4, dtype=jnp.float32, remat="dots")
    kw = dict(optimizer="adamw", grad_accum=2, warmup_steps=2,
              total_steps=10)
    jp = jl.init_params(jax.random.key(0), jcfg)
    host = jax.device_get(jp)
    mesh = single_device_mesh()
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jl.init_params(rng, jcfg),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(jl.forward, jcfg),
        config=j_trainer.TrainerConfig(**kw))
    jt.init_state(jax.random.key(0))
    tcfg = interop.config_from_jax(jcfg)
    tt = t_trainer.Trainer(
        lambda g: interop.params_from_jax(host, device="cpu"),
        t_trainer.lm_loss_fn(tl.forward, tcfg),
        t_trainer.TrainerConfig(**kw), device="cpu")
    tt.init_state()
    rng = np.random.default_rng(4)
    batches = j_data.synthetic_lm_batches(jcfg.vocab_size, 4, 16)
    for _ in range(3):
        b = next(batches)
        b["mask"] = (rng.random(b["tokens"].shape) < 0.8).astype(np.int32)
        jm = jt.train_step(j_data.put_batch(mesh, b))
        tm = tt.train_step(b)
        assert "moe_aux" in tm and "moe_aux" in jm
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(tm["moe_aux"].item(),
                                   float(jm["moe_aux"]), rtol=1e-5)
    j_final = jax.device_get(jt.params)
    for key, x in tt.params["layers"].items():
        np.testing.assert_allclose(x.detach().numpy(),
                                   np.asarray(j_final["layers"][key]),
                                   rtol=0, atol=2e-5, err_msg=key)
    np.testing.assert_allclose(tt.params["embed"].detach().numpy(),
                               np.asarray(j_final["embed"]), rtol=0,
                               atol=2e-5)
    assert all(torch.isfinite(g.grad).all()
               for g in t_optim.tree_leaves(tt.params))


def test_moe_train_state_keeps_addresses():
    """The static step (what ``precompile`` captures) with an MoE body:
    from the first step on, every state tensor keeps its address, the
    moe_aux metric has its static sum and output, and each step returns
    clones."""
    cfg = tl.llama_tiny(n_experts=4, dtype=torch.float32, remat="dots")
    tr = t_trainer.Trainer(
        lambda g: tl.init_params(g, cfg, device="cpu"),
        t_trainer.lm_loss_fn(tl.forward, cfg),
        t_trainer.TrainerConfig(optimizer="adafactor", grad_accum=2,
                                warmup_steps=2, total_steps=10),
        device="cpu")
    tr.init_state(torch.Generator().manual_seed(0))
    batches = j_data.synthetic_lm_batches(cfg.vocab_size, 4, 16)
    first = tr.train_step(next(batches))
    ptrs = {k: t.data_ptr() for k, t in tr._state_tensors().items()}
    assert {"metric/moe_aux", "out/moe_aux"} <= set(ptrs)
    aux0 = first["moe_aux"].item()
    for _ in range(2):
        m = tr.train_step(next(batches))
        assert np.isfinite(m["loss"].item()) and m["moe_aux"].item() > 0
    assert {k: t.data_ptr() for k, t in tr._state_tensors().items()} == ptrs
    assert first["moe_aux"].item() == aux0        # a clone, not the buffer


def test_moe_engine_cache_keeps_addresses(tiny_moe):
    """Admission, chunked prefill, decode and verify of an MoE engine
    write the pool and lengths in place (the decode program's state)."""
    _, _, tcfg, tp = tiny_moe
    eng = LLMEngine(tp, dataclasses.replace(tcfg, moe_capacity_factor=0.0),
                    device="cpu", max_batch=3, max_seq=64,
                    prefill_buckets=(8, 16), decode_chunk=3,
                    scheduler=SchedulerConfig(spec_decode=True, spec_k=2))
    cache = eng.cache
    ptrs = {k: t.data_ptr() for k, t in cache.items()}
    reqs = eng.generate([[1, 2, 3, 1, 2, 3, 1, 2],
                         [(7 * i) % 250 + 1 for i in range(40)], [4, 5]],
                        SamplingParams(max_tokens=10))
    assert eng.cache is cache
    assert {k: t.data_ptr() for k, t in cache.items()} == ptrs
    assert all(len(r.generated) == 10 for r in reqs)
    assert eng.scheduler_stats()["spec_dispatches_total"] > 0


# ------------------------------------------------------------ the engine --

def _engine_pair(tiny_moe, cf, spec, **kw):
    jcfg, jp, tcfg, tp = tiny_moe
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    jkw = dict(kw, decode_pipeline=False, kernel="pallas")
    if spec:
        jkw["scheduler"] = JSched(spec_decode=True, spec_k=3)
        kw["scheduler"] = SchedulerConfig(spec_decode=True, spec_k=3)
    return (JEngine(jp, jcfg, **jkw),
            LLMEngine(tp, tcfg, device="cpu", **kw))


@pytest.mark.parametrize("cf,spec", [(0.0, False), (1.25, False),
                                     (0.0, True)])
def test_engine_streams_match_jax(tiny_moe, cf, spec):
    """Greedy streams of ragged prompts (two buckets, one chunked, one
    repeating so the drafter proposes) through the port's engine and the
    synchronous JAX engine: token for token, logprobs within 1e-4. Covers
    the routing masks of admission (pad rows), decode (idle slots),
    chunked prefill (the final chunk's pad) and, with spec_decode, the
    verify step (rows past a slot's limit)."""
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [1, 2, 3, 1, 2, 3, 1, 2],
               [(7 * i) % 250 + 1 for i in range(40)]]
    kw = dict(max_batch=3, max_seq=96, prefill_buckets=(8, 16),
              decode_chunk=3)
    je, te = _engine_pair(tiny_moe, cf, spec, **kw)
    jr = je.generate(prompts, JSampling(max_tokens=9))
    tr = te.generate(prompts, SamplingParams(max_tokens=9))
    assert [r.generated for r in tr] == [r.generated for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.logprobs, b.logprobs, **MODEL_TOL)
    assert te.sched.chunked_admitted == je.sched.chunked_admitted == 1
    if spec:
        st, jst = te.scheduler_stats(), je.scheduler_stats()
        assert st["spec_dispatches_total"] == \
            jst["spec_dispatches_total"] > 0


def test_dropless_stream_is_batch_invariant(tiny_moe):
    """Dropless routing: a prompt decodes the same alone and beside
    others (capacity buffers would couple it to its neighbours)."""
    _, _, tcfg, tp = tiny_moe
    cfg = dataclasses.replace(tcfg, moe_capacity_factor=0.0)
    eng = LLMEngine(tp, cfg, device="cpu", max_batch=4, max_seq=64,
                    prefill_buckets=(16,))
    target = [3, 1, 4, 1, 5, 9, 2, 6]
    [alone] = eng.generate([target], SamplingParams(max_tokens=8))
    crowd = eng.generate([[7] * 12, target, [11, 12, 13]],
                         SamplingParams(max_tokens=8))
    assert crowd[1].generated == alone.generated
    np.testing.assert_allclose(crowd[1].logprobs, alone.logprobs,
                               rtol=1e-5, atol=1e-5)


def test_mixtral_checkpoint_matches_jax(tmp_path):
    """A Mixtral-layout directory written by the JAX package's
    save_pretrained: LLMModel.from_pretrained reads it into the tree JAX's
    load_pretrained gives, bit for bit, serves dropless, and its greedy
    streams equal the JAX engine's over JAX's own load."""
    cfg = dataclasses.replace(
        jl.llama_moe_8x(jl.llama_tiny(dtype=jnp.float32), n_experts=4),
        vocab_size=512, tie_embeddings=False)
    model_dir = str(tmp_path / "mixtral")
    j_hf.save_pretrained(model_dir, cfg,
                         jl.init_params(jax.random.key(3), cfg))
    jcfg, jp = j_hf.load_pretrained(model_dir, dtype=jnp.float32,
                                    moe_capacity_factor=0.0)
    model = LLMModel.from_pretrained("moe", model_dir, dtype=torch.float32,
                                     device="cpu", max_batch=2, max_seq=64,
                                     prefill_buckets=(16,))
    assert model.cfg.n_experts == 4 and model.cfg.moe_top_k == 2
    assert model.cfg.moe_capacity_factor == 0.0
    tree = model._params
    want = jax.device_get(jp)
    assert set(tree["layers"]) == set(want["layers"])
    for key, leaf in want["layers"].items():
        np.testing.assert_array_equal(tree["layers"][key].numpy(),
                                      np.asarray(leaf), err_msg=key)
    for key in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(tree[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    prompts = [[5, 6, 7, 8], [(3 * i) % 500 + 1 for i in range(20)]]
    ids = np.zeros((2, 20), np.int32)                # right-padded with 0
    for row, prompt in zip(ids, prompts):
        row[:len(prompt)] = prompt
    assert model.load()
    try:
        out = model.predict(InferRequest(
            "moe", [InferTensor("ids", [2, 20], "INT32", ids.tolist())],
            parameters={"max_tokens": 6}))
    finally:
        model.unload()
    ours = [row[:n].tolist() for row, n in zip(out.as_numpy("tokens"),
                                                out.as_numpy("lengths"))]
    theirs = JEngine(jp, jcfg, max_batch=2, max_seq=64,
                     prefill_buckets=(16,), decode_pipeline=False,
                     kernel="pallas").generate(
        prompts, JSampling(max_tokens=6))
    assert ours == [r.generated for r in theirs]


# ------------------------------------------------------------- the mesh --

def test_moe_under_a_mesh_raises_naming_item_8_7(tiny_moe, tmp_path):
    """Of MoE under a serving mesh, an axis beyond ``expert`` and
    ``tensor`` (``context`` beside ``expert``) still raises, naming item
    8.7 (the JAX package has no test of it). A tensor mesh draws and
    loads each rank's ``mlp`` slice of every expert, the router whole
    (tests/test_torch_moe_tp.py and tests/test_torch_moe_expert_serving.py
    hold the engine, the shards and the runtime to the JAX package)."""
    from kubeflow_tpu_torch.parallel import TensorMesh
    from kubeflow_tpu_torch.parallel.mesh import mesh_from_topology_env

    _, _, tcfg, _ = tiny_moe
    with pytest.raises(NotImplementedError, match="queue 1 item 8.7"):
        mesh_from_topology_env({"KFT_MESH": "context=2,expert=2",
                                "KFT_FORCE_PLATFORM": "cpu"})
    mesh = TensorMesh(2, ["cpu"] * 2)
    mesh.rank = 1
    part = tl.init_params(torch.Generator().manual_seed(0), tcfg,
                          device="cpu", mesh=mesh)
    assert part["layers"]["w_gate"].shape == (2, 4, 64, 64)
    assert part["layers"]["w_down"].shape == (2, 4, 64, 64)
    assert part["layers"]["moe_router"].shape == (2, 64, 4)
    model_dir = str(tmp_path / "m")
    jcfg = jl.llama_tiny(n_experts=4, dtype=jnp.float32)
    j_hf.save_pretrained(model_dir, jcfg,
                         jl.init_params(jax.random.key(0), jcfg))
    _, params = t_hf.load_params(model_dir, dtype=torch.float32,
                                 device="cpu", mesh=mesh)
    assert params["layers"]["w_up"].shape == (2, 4, 64, 64)
    _, params = t_hf.load_params(model_dir, dtype=torch.float32,
                                 device="cpu")
    assert params["layers"]["w_gate"].shape == (2, 4, 64, 128)


def test_moe_quality_readings_hold_the_paths_together(tiny_moe):
    """tools/moe_quality.readings (phase 5m (c)'s method) on a float32
    MoE engine on the CPU: the decode path and the capacity-path forward
    agree to float32 noise, free and with the decode path's routing, and
    take the same experts everywhere."""
    from kubeflow_tpu_torch.tools import moe_quality

    _, _, tcfg, tp = tiny_moe
    eng = LLMEngine(tp, dataclasses.replace(tcfg, moe_capacity_factor=0.0),
                    device="cpu", max_batch=2, max_seq=64,
                    prefill_buckets=(16,))
    prompt = [5, 9, 2, 7, 7, 1, 3, 8]
    [req] = eng.generate([prompt], SamplingParams(max_tokens=8))
    res = moe_quality.readings(eng, prompt, req.generated)
    assert res["positions"] == 8
    assert res["routing_decisions"] == 15 * tcfg.n_layers
    assert res["routing_flips"] == 0
    assert res["rms_over_rms"] < 1e-5 and res["free_rms_over_rms"] < 1e-5
    assert res["greedy_agreement"] == 1.0
    assert moe_quality.mixtral_8x7b().n_layers == 16

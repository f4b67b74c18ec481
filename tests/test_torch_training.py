"""The port's training slice against the JAX package's on the CPU in
float32: losses, the model's forward and gradients under each remat mode,
the optimizers, and ``Trainer`` over several steps from the same weights
(converted by ``interop.params_from_jax``) and the same numpy batches.

Tolerances, each from float32 sums taken in another order:
- loss and ops: 1e-5 relative (single reductions);
- logits and gradients of the 2-layer model: 1e-4 (two layers of matmuls,
  softmaxes and the flash path's blockwise sums, as test_torch_llama);
- trainer: per-step loss 1e-5 relative, grad_norm 1e-4 relative, final
  parameters 2e-5 absolute (three updates of at most lr = 3e-4 each;
  adamw's first steps divide a gradient by its own magnitude, so an
  element whose gradient is within float32 noise of zero may move by a
  few ulps of lr more on one side).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.ops import losses as j_losses
from kubeflow_tpu.parallel.mesh import single_device_mesh
from kubeflow_tpu.training import data as j_data
from kubeflow_tpu.training import trainer as j_trainer
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.ops import losses as t_losses
from kubeflow_tpu_torch.training import data as t_data
from kubeflow_tpu_torch.training import loop as t_loop
from kubeflow_tpu_torch.training import optim as t_optim
from kubeflow_tpu_torch.training import trainer as t_trainer
from kubeflow_tpu_torch.training.metrics import read_metrics
from test_torch_flash_attention import warm_up_cpu_exp

OP_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


warm_up_cpu_exp()      # the first CPU exp of a process can be inexact


def _np_tree(t):
    return t_optim.tree_map(lambda x: x.detach().numpy(), t)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_cross_entropy_matches_jax(masked, z_loss):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    t_loss, t_aux = t_losses.softmax_cross_entropy(
        torch.tensor(logits), torch.tensor(labels),
        None if mask is None else torch.tensor(mask), z_loss=z_loss)
    j_loss, j_aux = j_losses.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), z_loss=z_loss)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), **OP_TOL)
    for key in ("total_weight", "sum_loss"):
        np.testing.assert_allclose(t_aux[key].item(), float(j_aux[key]),
                                   **OP_TOL)
    acc_t = t_losses.accuracy(torch.tensor(logits), torch.tensor(labels),
                              None if mask is None else torch.tensor(mask))
    acc_j = j_losses.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(acc_t.item(), float(acc_j), **OP_TOL)


# ---------------------------------------------------------------------------
# Model: forward and gradients under each remat mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, jax.device_get(jp)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_forward_and_param_grads_match_jax(tiny_pair, remat):
    jcfg, jp, host = tiny_pair
    jcfg = jl.llama_tiny(dtype=jnp.float32, attn_impl="pallas", remat=remat,
                         attn_block=16)
    tcfg = interop.config_from_jax(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    w = rng.standard_normal((2, 24, jcfg.vocab_size)).astype(np.float32)

    def j_obj(p):
        logits = jl.forward(p, jnp.asarray(toks), jcfg)
        return jnp.sum(logits * jnp.asarray(w)), logits

    (_, j_logits), j_grads = jax.value_and_grad(j_obj, has_aux=True)(jp)
    tp = interop.params_from_jax(host, device="cpu")
    tp = t_optim.tree_map(lambda x: x.requires_grad_(True), tp)
    t_logits = tl.forward(tp, torch.tensor(toks), tcfg)
    (t_logits * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), **MODEL_TOL)
    t_grads = _flat(t_optim.tree_map(lambda x: x.grad.numpy(), tp))
    for name, g in _flat(jax.device_get(j_grads)).items():
        np.testing.assert_allclose(t_grads[name], g, **MODEL_TOL,
                                   err_msg=name)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_dots_remat_saves_weight_products_and_recomputes_the_rest(
        tiny_pair):
    """"full" recomputes the block's weight products in backward (all
    but the last, whose output nothing saves: non-reentrant checkpoints
    stop recomputing once every saved tensor is back); "dots" keeps them,
    as "none" does, and recomputes the rest, the flash forward
    included."""
    _, _, host = tiny_pair
    counts, flash_fwd = {}, {}
    from kubeflow_tpu_torch.ops import flash_attention as tfa

    real = tfa.flash_attention_fwd_reference
    for remat in ("none", "full", "dots"):
        cfg = tl.llama_tiny(dtype=torch.float32, attn_impl="pallas",
                            remat=remat)
        tp = t_optim.tree_map(lambda x: x.requires_grad_(True),
                              interop.params_from_jax(host, device="cpu"))
        calls = []
        tfa.flash_attention_fwd_reference = \
            lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            with _CountMM() as mode:
                tl.forward(tp, torch.zeros((1, 8), dtype=torch.long),
                           cfg).sum().backward()
        finally:
            tfa.flash_attention_fwd_reference = real
        counts[remat], flash_fwd[remat] = mode.mm, len(calls)
    n = cfg.n_layers
    assert counts["full"] - counts["dots"] == 6 * n
    assert counts["dots"] == counts["none"]
    assert flash_fwd == {"none": n, "full": 2 * n, "dots": 2 * n}


def test_flops_per_token_matches_jax():
    for seq in (None, 2048):
        assert tl.llama_1b().flops_per_token(seq) == \
            jl.llama_1b().flops_per_token(seq)


# ---------------------------------------------------------------------------
# Optimizer pieces
# ---------------------------------------------------------------------------

def test_schedule_matches_optax():
    cfg = t_trainer.TrainerConfig(learning_rate=3e-4, warmup_steps=4,
                                  total_steps=12)
    ours = t_optim.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_steps, cfg.total_steps,
        end_value=cfg.learning_rate * 0.1)
    ref = optax.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_steps, cfg.total_steps,
        end_value=cfg.learning_rate * 0.1)
    assert ours(0) == 0.0
    for step in range(16):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_global_norm_clip_matches_optax(scale):
    rng = np.random.default_rng(2)
    tree = {"a": (scale * rng.standard_normal((3, 4))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(5)).astype(np.float32)}}
    ours, _ = t_optim.clip_by_global_norm(1.0).update(
        t_optim.tree_map(torch.tensor, tree), (), None)
    ref, _ = optax.clip_by_global_norm(1.0).update(
        jax.tree_util.tree_map(jnp.asarray, tree), optax.EmptyState())
    for name, x in _flat(jax.device_get(ref)).items():
        np.testing.assert_allclose(_flat(_np_tree(ours))[name], x, **OP_TOL)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_optax(name):
    """Three updates of the hand port against optax on a tree with
    factored (>= 128 x 128 two largest dims) and unfactored leaves."""
    rng = np.random.default_rng(3)
    shapes = {"w": (2, 128, 160), "v": (200,), "m": (130, 4, 128)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = t_trainer.TrainerConfig(optimizer=name, warmup_steps=2,
                                  total_steps=10)
    j_tx = j_trainer.make_optimizer(cfg)
    t_tx = t_trainer.make_optimizer(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = t_optim.tree_map(torch.tensor, params)
    j_state, t_state = j_tx.init(jp), t_tx.init(tp)
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        j_up, j_state = j_tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), j_state, jp)
        jp = optax.apply_updates(jp, j_up)
        t_up, t_state = t_tx.update(t_optim.tree_map(torch.tensor, g),
                                    t_state, tp)
        t_optim.apply_updates(tp, t_up)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} step {step} {k}")


# ---------------------------------------------------------------------------
# Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

def _masked_batches(vocab, batch, seq, steps):
    """synthetic_lm_batches plus a mask whose density varies by row."""
    rng = np.random.default_rng(4)
    out = []
    for b in j_data.synthetic_lm_batches(vocab, batch, seq):
        density = np.linspace(0.3, 1.0, batch)[:, None]
        b["mask"] = (rng.random((batch, seq + 1)) < density).astype(np.int32)
        out.append(b)
        if len(out) == steps:
            return out


def _run_both(jcfg, t_attn, tcfg_kw, batches, seed=0, precompile=False):
    """The JAX trainer and the port's from the same weights over
    ``batches``; with ``precompile`` the JAX trainer's steps run its
    ``precompile``d executable (no depot)."""
    jp = jl.init_params(jax.random.key(seed), jcfg)
    host = jax.device_get(jp)
    mesh = single_device_mesh()
    jt = j_trainer.Trainer(
        mesh=mesh, init_params_fn=lambda rng: jl.init_params(rng, jcfg),
        params_logical_axes=jl.param_logical_axes(jcfg),
        loss_fn=j_trainer.lm_loss_fn(jl.forward, jcfg),
        config=j_trainer.TrainerConfig(**tcfg_kw))
    jt.init_state(jax.random.key(seed))
    if precompile:
        assert jt.precompile(j_data.put_batch(mesh, batches[0])) \
            == "no_depot"
    tcfg = interop.config_from_jax(jcfg)
    tcfg = tl.LlamaConfig(**{**tcfg.__dict__, "attn_impl": t_attn})
    tt = t_trainer.Trainer(
        lambda g: interop.params_from_jax(host, device="cpu"),
        t_trainer.lm_loss_fn(tl.forward, tcfg),
        t_trainer.TrainerConfig(**tcfg_kw), device="cpu")
    tt.init_state()
    for b in batches:
        jm = jt.train_step(j_data.put_batch(mesh, b))
        tm = tt.train_step(b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert tm["tokens"].item() == float(jm["tokens"])
    j_final = _flat(jax.device_get(jt.params))
    for name, x in _flat(_np_tree(tt.params)).items():
        np.testing.assert_allclose(x, j_final[name], rtol=0, atol=2e-5,
                                   err_msg=name)
    return tt


def test_trainer_adamw_grad_accum_matches_jax():
    """llama_tiny, grad_accum=2, a mask of varying density: the
    token-weighted accumulation gives the JAX trainer's loss, grad norm
    and parameters."""
    jcfg = jl.llama_tiny(dtype=jnp.float32, remat="none")
    _run_both(jcfg, "pallas",
              dict(optimizer="adamw", grad_accum=2, warmup_steps=2,
                   total_steps=10),
              _masked_batches(jcfg.vocab_size, 4, 16, 3))


def test_trainer_adafactor_factored_matches_jax():
    """dim 128 and mlp 256, so the embedding and the MLP weights factor
    (their two largest dims are >= 128) while the attention weights
    do not."""
    jcfg = jl.LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                          n_kv_heads=2, mlp_dim=256, max_seq=64,
                          rope_scaling=None, tie_embeddings=True,
                          dtype=jnp.float32, remat="none")
    assert t_optim._factored_dims((2, 128, 256), 128) == (1, 2)
    assert t_optim._factored_dims((2, 128, 4, 32), 128) is None
    _run_both(jcfg, "pallas",
              dict(optimizer="adafactor", grad_accum=2, warmup_steps=2,
                   total_steps=10),
              _masked_batches(jcfg.vocab_size, 4, 16, 3))


def test_trainer_single_step_through_both_flash_kernels():
    """One step with attn_impl="pallas" on both sides: the JAX kernel in
    interpret mode against the port's flash path."""
    jcfg = jl.llama_tiny(dtype=jnp.float32, attn_impl="pallas",
                         remat="dots", attn_block=16)
    batches = [next(j_data.synthetic_lm_batches(jcfg.vocab_size, 2, 16))]
    _run_both(jcfg, "pallas", dict(optimizer="adamw", warmup_steps=0,
                                   total_steps=10), batches)


def test_synthetic_batches_identical_in_both_packages():
    a = j_data.synthetic_lm_batches(1000, 4, 32, seed=3, start_step=5)
    b = t_data.synthetic_lm_batches(1000, 4, 32, seed=3, start_step=5)
    for _ in range(3):
        x, y = next(a), next(b)
        assert y["tokens"].dtype == np.int32
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

def _tiny_trainer():
    cfg = tl.llama_tiny(dtype=torch.float32, attn_impl="pallas")
    return t_trainer.Trainer(
        lambda g: tl.init_params(g, cfg, device="cpu"),
        t_trainer.lm_loss_fn(tl.forward, cfg),
        t_trainer.TrainerConfig(warmup_steps=1, total_steps=10),
        device="cpu"), cfg


def test_fit_writes_metrics_beats_and_profiles(tmp_path, monkeypatch):
    monkeypatch.setenv("KFT_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setenv("KFT_PROFILE_STEPS", "1:2")
    monkeypatch.setenv("KFT_HEARTBEAT_FILE", str(tmp_path / "hb" / "beat"))
    trainer, cfg = _tiny_trainer()
    writer = t_loop.MetricsWriter(str(tmp_path / "metrics.jsonl"))
    seen = []
    res = t_loop.fit(
        trainer, lambda start: t_data.synthetic_lm_batches(
            cfg.vocab_size, 2, 16, start_step=start),
        generator=torch.Generator().manual_seed(0), max_steps=3,
        metrics=writer, metrics_every=1,
        on_step=lambda s, m: seen.append(s))
    assert res.final_step == 3 and seen == [1, 2, 3]
    records = read_metrics(str(tmp_path / "metrics.jsonl"))
    assert [r["step"] for r in records] == [1, 2, 3, 3]
    assert all(np.isfinite(r["loss"]) and r["tokens"] == 32.0
               for r in records)
    assert (tmp_path / "hb" / "beat").read_text() == "3"
    assert res.profile is not None
    assert res.profile["t_start"] <= res.profile["t_stop"]
    with open(res.profile["trace"]) as f:
        assert "traceEvents" in json.load(f)
    assert os.path.dirname(res.profile["trace"]) == str(tmp_path / "prof")


def test_profile_from_env_malformed_is_off():
    assert t_loop.profile_from_env({"KFT_PROFILE_STEPS": "5:2"}) == \
        (None, None)
    assert t_loop.profile_from_env({"KFT_PROFILE_DIR": "/x",
                                    "KFT_PROFILE_STEPS": "2,4"}) == \
        ("/x", (2, 4))


def test_unported_training_paths_raise_naming_their_slice():
    trainer, cfg = _tiny_trainer()
    with pytest.raises(NotImplementedError, match="checkpoint"):
        t_loop.fit(trainer, [], max_steps=1, checkpoint_dir="/tmp/x")
    with pytest.raises(ValueError, match="precompile needs init_state"):
        trainer.precompile({})
    # MoE losses are ported (tests/test_torch_moe.py): the loss function
    # builds, and a step adds moe_aux to the loss and the metrics
    moe_cfg = tl.llama_tiny(n_experts=4, dtype=torch.float32)
    moe_params = tl.init_params(torch.Generator().manual_seed(0), moe_cfg,
                                device="cpu")
    loss, metrics = t_trainer.lm_loss_fn(tl.forward, moe_cfg)(
        moe_params, {"tokens": torch.zeros((1, 5), dtype=torch.long)})
    assert torch.isfinite(loss) and metrics["moe_aux"].item() > 0
    with pytest.raises(ValueError, match="train_step needs init_state"):
        trainer.train_step({"tokens": np.zeros((2, 5), np.int32)})
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_trainer.make_optimizer(t_trainer.TrainerConfig(optimizer="sgd"))

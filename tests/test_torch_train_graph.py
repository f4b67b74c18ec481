"""The port's training step as static bodies (``Trainer._micro_body`` and
``_finish_body`` over static tensors) on the CPU, and its CUDA-graph
replay (``Trainer.precompile``, ``training/step_graph.py``) on the card.

- Every state tensor keeps its address across steps (a captured graph
  holds them): exact ``data_ptr`` equality, adamw and adafactor.
- The device counts: the schedule, adamw's bias corrections and
  adafactor's decay computed on the device from 0-d count tensors against
  optax's, at the counts where the schedule turns (rtol 1e-6: both sides
  compute in float32, pow and cos may differ by an ulp).
- The JAX trainer's ``precompile``d steps against the port's static body
  on ``llama_tiny``: tests/test_torch_training.py's ``_run_both`` and its
  tolerances.
- ``precompile``'s contract on the CPU.
- The ``cuda``-marked case runs on the card only: replayed steps bitwise
  equal to eager ones.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import _decay_rate_pow

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.training import data as t_data
from kubeflow_tpu_torch.training import optim as t_optim
from kubeflow_tpu_torch.training import trainer as t_trainer
from test_torch_training import _run_both

WARMUP, TOTAL = 4, 12
COUNTS = [0, 1, WARMUP - 1, WARMUP, WARMUP + 1, TOTAL, TOTAL + 5]
ADAFACTOR_CFG = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                     n_kv_heads=2, mlp_dim=256, max_seq=64,
                     rope_scaling=None, tie_embeddings=True)


def _trainer(optimizer, accum, device="cpu", **cfg_kw):
    if optimizer == "adafactor":
        cfg = tl.LlamaConfig(**ADAFACTOR_CFG, **cfg_kw)
    else:
        cfg = tl.llama_tiny(**cfg_kw)
    tr = t_trainer.Trainer(
        lambda g: tl.init_params(g, cfg, device=device),
        t_trainer.lm_loss_fn(tl.forward, cfg),
        t_trainer.TrainerConfig(optimizer=optimizer, grad_accum=accum,
                                warmup_steps=2, total_steps=10),
        device=device)
    return tr, cfg


def _masked_batches(vocab, batch, seq, steps):
    """The port's synthetic batches (the JAX package's tokens) plus a
    mask whose density varies by row, as tests/test_torch_training.py
    makes them."""
    rng = np.random.default_rng(4)
    out = []
    for b in t_data.synthetic_lm_batches(vocab, batch, seq):
        density = np.linspace(0.3, 1.0, batch)[:, None]
        b["mask"] = (rng.random((batch, seq + 1)) < density).astype(np.int32)
        out.append(b)
        if len(out) == steps:
            return out


def _addresses(tensors: dict) -> dict:
    return {k: t.data_ptr() for k, t in tensors.items()}


# ------------------------------------------------ the state stays in place --

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_state_tensors_keep_their_addresses(optimizer):
    """Across ``init_state`` and three ``train_step``s the parameters,
    their gradient accumulators, every optimizer-state leaf (the device
    counts included) keep their addresses, and from the first step on
    the sums, the outputs and the staged batch too; the counts advance on
    the device, and each step returns clones of the static outputs."""
    tr, cfg = _trainer(optimizer, 2, dtype=torch.float32,
                       attn_impl="pallas")
    tr.init_state(torch.Generator().manual_seed(0))
    state = tr._state_tensors()
    assert any(k.startswith("grad/") for k in state)
    if optimizer == "adafactor":     # the factored leaves are there
        assert any(k.endswith("v_row") for k in state)
    at_init = _addresses(state)
    batches = _masked_batches(cfg.vocab_size, 4, 16, 3)
    first = tr.train_step(batches[0])
    after_one = _addresses(tr._state_tensors())
    assert {k: after_one[k] for k in at_init} == at_init
    assert any(k.startswith("batch/") for k in after_one)
    loss0 = first["loss"].item()
    for b in batches[1:]:
        tr.train_step(b)
    assert _addresses(tr._state_tensors()) == after_one
    assert first["loss"].item() == loss0       # a clone, not the buffer
    counts = {k: int(t) for k, t in t_optim.named_leaves(
        tr.opt_state).items() if k.endswith("count")}
    assert counts and set(counts.values()) == {3}
    assert all(p.grad.abs().max().item() == 0.0
               for p in t_optim.tree_leaves(tr.params))


def test_batch_buffers_stage_packs_one_copy():
    """``BatchBuffers`` holds every key in one packed buffer, stages bit
    for bit, and ``matches`` only a batch of its keys, shapes and
    dtypes."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 100, (4, 17), dtype=np.int32),
             "mask": rng.random((4, 17)) < 0.5,
             "weights": rng.random((4, 3)).astype(np.float32)}
    buf = t_data.BatchBuffers(batch, torch.device("cpu"))
    buf.stage(batch)
    storages = {t.untyped_storage().data_ptr()
                for t in buf.tensors.values()}
    assert len(storages) == 1
    for k, v in batch.items():
        np.testing.assert_array_equal(buf.tensors[k].numpy(), v)
        assert buf.tensors[k].dtype == torch.as_tensor(v).dtype
    assert buf.matches(batch)
    assert not buf.matches({**batch, "tokens": batch["tokens"][:2]})
    assert not buf.matches({k: batch[k] for k in ("tokens", "mask")})
    assert not buf.matches({**batch,
                            "mask": batch["mask"].astype(np.int32)})


# ------------------------------------------------------ counts on device --

@pytest.mark.parametrize("quantity", ["schedule", "adamw_bias_correction",
                                      "adafactor_decay"])
def test_device_counts_match_optax(quantity):
    lr = 3e-4
    for count in COUNTS:
        c = torch.tensor(count, dtype=torch.int32)
        if quantity == "schedule":
            ours = [t_optim.device_warmup_cosine_decay_schedule(
                0.0, lr, WARMUP, TOTAL, end_value=lr * 0.1)(c)]
            ref = [optax.warmup_cosine_decay_schedule(
                0.0, lr, WARMUP, TOTAL, end_value=lr * 0.1)(jnp.int32(count))]
        elif quantity == "adamw_bias_correction":
            # optax divides the moment by 1 - decay ** count
            ours = [1 / t_optim.bias_correction(b, c) for b in (0.9, 0.95)]
            ref = [optax.tree_utils.tree_bias_correction(
                jnp.ones((), jnp.float32), b, jnp.int32(count))
                for b in (0.9, 0.95)]
        else:
            ours = [t_optim.adafactor_decay(c, 0.8)]
            ref = [_decay_rate_pow(jnp.int32(count), 0.8)]
        for o, r in zip(ours, ref):
            assert o.dtype == torch.float32 and o.shape == ()
            np.testing.assert_allclose(o.item(), float(r), rtol=1e-6,
                                       err_msg=f"{quantity} at {count}")


# ---------------------------------------------- the static body vs JAX's --

def test_jax_precompiled_steps_match_the_static_body():
    """The JAX trainer ``precompile``d (no depot: "no_depot") against the
    port's static step body over three masked steps of ``llama_tiny``,
    grad_accum 2."""
    jcfg = jl.llama_tiny(dtype=jnp.float32, remat="none")
    tt = _run_both(jcfg, "pallas",
                   dict(optimizer="adamw", grad_accum=2, warmup_steps=2,
                        total_steps=10),
                   _masked_batches(jcfg.vocab_size, 4, 16, 3),
                   precompile=True)
    assert tt.step == 3 and tt.step_graph is None


def test_precompile_contract_on_the_cpu():
    """JAX's check before ``init_state``; a CPU trainer has no graph (and
    no stand-in); a depot and ``lower_step`` name their later slices;
    an eager trainer takes batches of any shape."""
    tr, cfg = _trainer("adamw", 2, dtype=torch.float32)
    batch = {"tokens": np.zeros((4, 9), np.int32)}
    with pytest.raises(ValueError, match="precompile needs init_state"):
        tr.precompile(batch)
    tr.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="queue 1 item 6.4"):
        tr.precompile(batch, depot=object())
    with pytest.raises(ValueError, match="CUDA graphs"):
        tr.precompile(batch)
    with pytest.raises(NotImplementedError, match="queue 1 item 8.11"):
        tr.lower_step(None, None, batch)
    with pytest.raises(ValueError, match="grad_accum=2"):
        tr.train_step({"tokens": np.zeros((3, 9), np.int32)})
    tr.train_step(batch)
    m = tr.train_step({"tokens": np.ones((2, 5), np.int32)})
    assert np.isfinite(m["loss"].item()) and tr.step == 2


# --------------------------------------------------------------- the card --

@pytest.mark.cuda
def test_cuda_replay_bitwise_equals_eager():
    """On the card: ``llama_tiny`` widened to head_dim 64 (the flash
    kernels' smallest), flash attention, remat "dots", bf16 compute,
    grad_accum 2, adafactor. ``precompile`` leaves the state bitwise as
    it was; an eager trainer and a precompiled one from the same
    parameters give bitwise equal losses, grad norms and parameters over
    3 steps (the same kernels on the same inputs); each replayed step
    adds the captured flash launches (per micro batch 2 x n_layers
    forward under remat dots, n_layers dQ and dK/dV); a batch of another
    shape raises, and so does a replay after a parameter was replaced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    kw = dict(dtype=torch.bfloat16, attn_impl="pallas", remat="dots",
              dim=256, n_heads=4, n_kv_heads=2)
    pair = {}
    for name in ("eager", "graph"):
        cfg = dataclasses.replace(tl.LlamaConfig(**ADAFACTOR_CFG), **kw)
        tr = t_trainer.Trainer(
            lambda g: tl.init_params(g, cfg, device="cuda"),
            t_trainer.lm_loss_fn(tl.forward, cfg),
            t_trainer.TrainerConfig(optimizer="adafactor", grad_accum=2,
                                    warmup_steps=2, total_steps=10),
            device="cuda")
        tr.init_state(torch.Generator(device="cuda").manual_seed(0))
        pair[name] = tr
    batches = _masked_batches(cfg.vocab_size, 4, 32, 4)
    graph = pair["graph"]
    # detached: a clone that records autograd would keep the parameters'
    # gradient accumulator nodes alive on the default stream
    before = {k: t.detach().clone()
              for k, t in graph._state_tensors().items()}
    assert graph.precompile(batches[0]) == graph.depot_outcome == "no_depot"
    after = graph._state_tensors()
    for k, t in before.items():
        assert torch.equal(after[k], t), k
    sg = graph.step_graph
    n = cfg.n_layers
    assert sg.launches == {"flash_attention_fwd": 2 * 2 * n,
                           "flash_attention_dq": 2 * n,
                           "flash_attention_dkv": 2 * n}
    out = {}
    for name, tr in pair.items():
        for c in t_trainer._COUNTERS:
            c.launches = 0
        out[name] = [tr.train_step(b) for b in batches[:3]]
        if name == "graph":
            assert {c.__name__: c.launches for c in t_trainer._COUNTERS} \
                == {k: 3 * v for k, v in sg.launches.items()}
    assert sg.replays == 3
    for a, b in zip(out["eager"], out["graph"]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for (k, p), q in zip(t_optim.named_leaves(pair["eager"].params).items(),
                         t_optim.tree_leaves(graph.params)):
        assert torch.equal(p, q), k
    with pytest.raises(ValueError, match="differs in its keys, shapes"):
        graph.train_step({"tokens": batches[3]["tokens"][:, :17]})
    graph.params["final_norm"] = graph.params["final_norm"].detach() \
        .clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="in place"):
        graph.train_step(batches[3])

"""Checkpoints of the PyTorch port (``kubeflow_tpu_torch.training.
checkpoint``, ``loop.restore_latest``, ``fit(checkpoint_dir=...)``) on the
CPU, against the reference's contract and against the JAX package's own
resumed ``fit``.

Bitwise throughout, except against JAX: the port saves and restores
bytes, and a killed-and-resumed run takes the same float32 steps as an
uninterrupted one. Against the JAX package's resumed ``fit`` (Orbax
checkpoints) the per-step losses are held to ``tests/
test_torch_training.py``'s trainer tolerance, 1e-5 relative (float32
sums taken in another order).
"""

import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.mesh import single_device_mesh
from kubeflow_tpu.training import data as j_data
from kubeflow_tpu.training import loop as j_loop
from kubeflow_tpu.training import trainer as j_trainer
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.training import optim as t_optim
from kubeflow_tpu_torch.training import (
    CheckpointManager, Trainer, TrainerConfig, fit, lm_loss_fn,
    restore_latest, synthetic_lm_batches,
)
from test_torch_flash_attention import warm_up_cpu_exp

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

LOSS_RTOL = 1e-5       # tests/test_torch_training.py's per-step loss


class Killed(Exception):
    """Stands for the kill: raised from ``on_step``, after the step's
    save was queued."""


def _kill_at(step_to_die):
    def on_step(step, m):
        if step == step_to_die:
            raise Killed
    return on_step


def _cfg(**kw):
    return tl.llama_tiny(dtype=torch.float32, **kw)


def _trainer(optimizer="adamw", grad_accum=1, init=None, cfg=None):
    cfg = cfg or _cfg()
    init = init or (lambda g: tl.init_params(g, cfg, device="cpu"))
    return Trainer(init, lm_loss_fn(tl.forward, cfg),
                   TrainerConfig(learning_rate=1e-3, warmup_steps=2,
                                 total_steps=10, optimizer=optimizer,
                                 grad_accum=grad_accum), device="cpu")


def _batches(start=0, cfg=None):
    cfg = cfg or _cfg()
    return synthetic_lm_batches(cfg.vocab_size, 4, 16, start_step=start)


def _leaves(trainer) -> dict:
    return t_optim.named_leaves({"params": trainer.params,
                                 "opt_state": trainer.opt_state})


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        assert torch.equal(la[name], lb[name]), name
    assert a.step == b.step


# --------------------------------------------------------- the manager --

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_round_trip_is_bitwise_and_keeps_every_address(tmp_path, optimizer):
    """Two trained steps saved, restored into a fresh trainer by
    ``restore_latest``: every parameter and optimizer leaf bitwise, the
    device counts included (int32), each tensor still at its address;
    both then train the same third step bitwise."""
    cfg = tl.LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                         n_kv_heads=2, mlp_dim=256, max_seq=64,
                         rope_scaling=None, tie_embeddings=True,
                         dtype=torch.float32)
    src = _trainer(optimizer, grad_accum=2, cfg=cfg)
    src.init_state()
    it = _batches(cfg=cfg)
    for _ in range(2):
        src.train_step(next(it))
    counts = {k: v for k, v in _leaves(src).items() if k.endswith("count")}
    assert counts and all(v.dtype == torch.int32 and int(v) == 2
                          for v in counts.values())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(src.step, {"params": src.params,
                               "opt_state": src.opt_state})
    mgr.wait()

    dst = _trainer(optimizer, grad_accum=2, cfg=cfg)
    dst.init_state(torch.Generator().manual_seed(7))
    ptrs = {k: t.data_ptr() for k, t in _leaves(dst).items()}
    grads = [p.grad.data_ptr() for p in t_optim.tree_leaves(dst.params)]
    assert restore_latest(dst, mgr) == 2
    mgr.close()
    assert {k: t.data_ptr() for k, t in _leaves(dst).items()} == ptrs
    assert [p.grad.data_ptr()
            for p in t_optim.tree_leaves(dst.params)] == grads
    _assert_same_state(src, dst)
    batch = next(it)
    ma, mb = src.train_step(batch), dst.train_step(batch)
    assert ma["loss"].item() == mb["loss"].item()
    _assert_same_state(src, dst)


def test_the_copy_is_taken_at_save(tmp_path):
    """The state is written in place after ``save`` returns (as the
    trainer's optimizer does), while the background write may still run:
    the saved step holds the values at ``save``."""
    state = {"w": torch.arange(1 << 16, dtype=torch.float32),
             "opt": ({"count": torch.zeros((), dtype=torch.int32)},)}
    want = {"w": state["w"].clone(), "count": 0}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    assert mgr.save(1, state)
    state["w"].mul_(-3.0).add_(1.0)
    state["opt"][0]["count"].add_(5)
    mgr.wait()
    step, got = mgr.restore()
    mgr.close()
    assert step == 1
    assert torch.equal(got["w"], want["w"])
    assert int(got["opt"][0]["count"]) == 0
    assert isinstance(got["opt"], tuple) and got["opt"][0]["count"].dtype \
        == torch.int32
    assert len(mgr.save_seconds) == len(mgr.write_seconds) == 1
    assert mgr.write_bytes[0] > (1 << 18)


def test_max_to_keep_and_half_written_steps(tmp_path):
    """Only the newest ``max_to_keep`` steps stay; a temporary directory
    (a write cut by a kill) and a step directory without its manifest
    are never taken for a step; save's step rules follow Orbax."""
    d = tmp_path / "ckpt"
    mgr = CheckpointManager(str(d), max_to_keep=2, async_save=False)
    for step in (1, 2, 3, 4):
        assert mgr.save(step, {"x": torch.full((3,), float(step))})
    assert sorted(os.listdir(d)) == ["3", "4"]
    assert not mgr.save(4, {"x": torch.zeros(3)})       # exists
    assert not mgr.save(2, {"x": torch.zeros(3)})       # older
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(4, {"x": torch.zeros(3)}, force=True)
    mgr.close()
    os.makedirs(d / ".tmp-9-123-abc")
    (d / ".tmp-9-123-abc" / "state.pt").write_bytes(b"partial")
    os.makedirs(d / "7")                                 # no manifest
    again = CheckpointManager(str(d), async_save=False)
    assert again.latest_step() == 4 and again.all_steps() == [3, 4]
    step, got = again.restore()
    assert step == 4 and torch.equal(got["x"], torch.full((3,), 4.0))
    # a numpy / python leaf comes back as numpy, a template gives its
    # structure and checks shapes
    assert again.save(8, {"w": np.arange(4.0), "n": 3, "l": [1.0, 2.0]})
    _, got = again.restore(8)
    np.testing.assert_array_equal(got["w"], np.arange(4.0))
    assert isinstance(got["l"], list) and got["n"] == 3
    _, got = again.restore(8, template={"w": np.zeros(4), "n": 0,
                                        "l": [0.0, 0.0]})
    np.testing.assert_array_equal(got["w"], np.arange(4.0))
    with pytest.raises(ValueError, match="leaf"):
        again.restore(4, template={"x": torch.zeros(2)})
    again.close()


def test_remote_directory_raises_and_file_scheme_is_stripped(tmp_path):
    for url in ("gs://bucket/ckpt", "s3://bucket/ckpt"):
        with pytest.raises(NotImplementedError,
                           match="no object-store client"):
            CheckpointManager(url)
    mgr = CheckpointManager(f"file://{tmp_path}/ckpt", async_save=False)
    assert mgr.directory == str(tmp_path / "ckpt")
    assert mgr.save(1, {"x": torch.ones(2)})
    mgr.close()
    assert os.path.isdir(tmp_path / "ckpt" / "1")


# ----------------------------------------------------------- the mirror --

def test_mirror_survives_local_disk_loss(tmp_path):
    """tests/test_elastic.py's case: every finished step is mirrored, and
    restore falls back to the mirror when the local directory is gone,
    the newest step or a named one."""
    local, mirror = str(tmp_path / "local"), str(tmp_path / "mirror")
    state = {"w": np.arange(8.0), "step": np.asarray(3)}
    mgr = CheckpointManager(local, mirror=f"file://{mirror}",
                            async_save=False)
    assert mgr.save(1, {"w": state["w"] * 0, "step": np.asarray(1)})
    assert mgr.save(3, state)
    mgr.wait()
    assert sorted(os.listdir(mirror)) == ["1", "3"]
    mgr.close()

    shutil.rmtree(local)
    mgr2 = CheckpointManager(local, mirror=mirror, async_save=False)
    step, restored = mgr2.restore(template=state)
    assert step == 3
    np.testing.assert_array_equal(restored["w"], state["w"])
    mgr2.close()

    shutil.rmtree(local)
    mgr3 = CheckpointManager(local, mirror=mirror, async_save=False)
    step, restored = mgr3.restore(step=1, template=state)
    assert step == 1
    np.testing.assert_array_equal(restored["w"], state["w"] * 0)
    mgr3.close()


def test_restore_prefers_newer_mirror_over_stale_local(tmp_path):
    local, mirror = str(tmp_path / "local"), str(tmp_path / "mirror")
    state2 = {"w": np.arange(4.0) * 2}
    state4 = {"w": np.arange(4.0) * 4}
    mgr = CheckpointManager(local, mirror=mirror)
    assert mgr.save(2, state2) and mgr.save(4, state4)
    mgr.wait()
    mgr.close()

    shutil.rmtree(os.path.join(local, "4"))     # the local disk rolled back
    mgr2 = CheckpointManager(local, mirror=mirror, async_save=False)
    step, restored = mgr2.restore(template=state4)
    assert step == 4
    np.testing.assert_array_equal(restored["w"], state4["w"])
    mgr2.close()

    shutil.rmtree(os.path.join(local, "2"))
    mgr3 = CheckpointManager(local, mirror=mirror, async_save=False)
    step, restored = mgr3.restore(step=2, template=state2)
    assert step == 2
    np.testing.assert_array_equal(restored["w"], state2["w"])
    mgr3.close()


def test_dead_mirror_is_counted_and_raises_the_operator_warning(
        tmp_path, monkeypatch):
    """tests/test_chaos.py's case on the port's manager: a mirror whose
    copy always fails keeps the step loop alive, counts the failure and
    appends the KFT_WARNING_FILE line that the JAX operator's warning
    sweep turns into a job Warning condition; ``fit`` reports the count
    as ``ckpt_mirror_errors``."""
    from kubeflow_tpu.api.types import jax_job
    from kubeflow_tpu.controller import FakeCluster, JobController, Operator

    cluster = FakeCluster()
    ctl = JobController(cluster)
    op = Operator(ctl, heartbeat_dir=str(tmp_path / "hb"))
    op.submit(jax_job("mirror-job", workers=1, mesh={"data": 1}))
    ctl.reconcile("default", "mirror-job")
    [pod] = cluster.list_pods("default", {"job-name": "mirror-job"})
    monkeypatch.setenv("KFT_WARNING_FILE", pod.env["KFT_WARNING_FILE"])

    def broken_copy(src, dst):
        raise OSError("mirror bucket unreachable")

    mgr = CheckpointManager(str(tmp_path / "local"),
                            mirror=str(tmp_path / "mirror"),
                            async_save=False, copy_fn=broken_copy)
    mgr.save(1, {"w": [1.0, 2.0]})
    deadline = time.time() + 30
    while time.time() < deadline and mgr.mirror_errors == 0:
        time.sleep(0.05)
    assert mgr.mirror_errors >= 1
    assert "mirror bucket unreachable" in mgr.last_mirror_error
    assert mgr.save(2, {"w": [3.0, 4.0]})
    mgr.close()
    op._collect_warnings("default", "mirror-job")
    warns = ctl.get("default", "mirror-job").status.warnings()
    assert warns and warns[0].reason == "CheckpointMirrorDegraded"
    assert "mirror bucket unreachable" in warns[0].message

    # fit over a dead mirror: training completes, the count is reported
    monkeypatch.setattr(CheckpointManager, "_default_copy",
                        staticmethod(broken_copy))
    tr = _trainer()
    r = fit(tr, _batches, max_steps=3, checkpoint_dir=str(tmp_path / "c"),
            checkpoint_every=1, checkpoint_mirror=str(tmp_path / "m"))
    assert r.final_step == 3
    assert r.last_metrics.get("ckpt_mirror_errors", 0) >= 1


# -------------------------------------------------- fit's kill and resume --

def _losses():
    out = {}

    def on_step(step, m):
        out[step] = m["loss"]
    return out, on_step


@pytest.mark.parametrize("feed", ["callable", "iterable"])
def test_killed_and_resumed_fit_is_bitwise_uninterrupted(tmp_path, feed):
    """``fit`` at llama_tiny f32, killed after its step-2 save, resumed by
    a fresh trainer to step 6 from the batches callable (seeking) or
    from a plain iterable (the first ``resumed_from`` skipped): the
    losses of steps 3..6 and the final state are bitwise those of an
    uninterrupted run."""
    ref = _trainer()
    ref_losses, on_step = _losses()
    fit(ref, _batches, max_steps=6, on_step=on_step)

    ckpt = str(tmp_path / "ckpt")
    src = (lambda: _batches) if feed == "callable" \
        else (lambda: list(_take(_batches(0), 8)))
    with pytest.raises(Killed):
        fit(_trainer(), src(), max_steps=6, checkpoint_dir=ckpt,
            checkpoint_every=2, on_step=_kill_at(3))
    assert CheckpointManager(ckpt).latest_step() == 2
    tr = _trainer()
    losses, on_step = _losses()
    r = fit(tr, src(), max_steps=6, checkpoint_dir=ckpt,
            checkpoint_every=2, on_step=on_step)
    assert r.resumed_from == 2 and r.final_step == 6
    assert losses == {s: ref_losses[s] for s in (3, 4, 5, 6)}
    _assert_same_state(ref, tr)
    assert sorted(os.listdir(ckpt)) == ["2", "4", "6"]
    # a resumed run with nothing left to train saves nothing new
    again = _trainer()
    r = fit(again, src(), max_steps=6, checkpoint_dir=ckpt)
    assert r.resumed_from == 6 and r.final_step == 6
    _assert_same_state(ref, again)


def _take(it, n):
    for _ in range(n):
        yield next(it)


def test_already_resumed_skips_the_restore_and_beats_the_takeover(
        tmp_path):
    """A caller that restored first (the pod restores before it
    captures) passes ``already_resumed``: fit does not restore again,
    beats the heartbeat at the takeover step before the first step, and
    reports ``resumed_from``."""
    ckpt = str(tmp_path / "ckpt")
    fit(_trainer(), _batches, max_steps=2, checkpoint_dir=ckpt)
    tr = _trainer()
    tr.init_state()
    mgr = CheckpointManager(ckpt)
    assert restore_latest(tr, mgr) == 2
    mgr.close()

    beats = []

    class Beats:
        def beat(self, step, warning=None):
            beats.append(step)

    calls = []
    import kubeflow_tpu_torch.training.loop as t_loop

    real = t_loop.restore_latest
    t_loop.restore_latest = lambda *a: calls.append(a) or real(*a)
    try:
        r = fit(tr, _batches, max_steps=4, checkpoint_dir=ckpt,
                already_resumed=2, heartbeat=Beats())
    finally:
        t_loop.restore_latest = real
    assert calls == [] and r.resumed_from == 2 and r.final_step == 4
    assert beats == [2, 3, 4]


def test_restore_latest_refuses_a_different_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    tr = _trainer()
    with pytest.raises(ValueError, match="init_state"):
        restore_latest(tr, mgr)
    tr.init_state()
    assert restore_latest(tr, mgr) is None
    mgr.save(1, {"params": tr.params, "opt_state": ()})
    with pytest.raises(ValueError, match="leaves"):
        restore_latest(tr, mgr)
    mgr.close()


# ----------------------------------------------------- against the JAX fit --

def test_resumed_fit_matches_the_jax_packages_resumed_fit(tmp_path):
    """The JAX package's ``fit`` with ``checkpoint_dir`` (Orbax) and the
    port's, from the same parameters (``interop.params_from_jax``) and
    the same batches, each killed after its step-2 save and resumed to
    step 6 by a fresh trainer: the same steps resumed, and per-step
    losses within 1e-5 relative, the resumed ones included."""
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    host = jax.device_get(jl.init_params(jax.random.key(0), jcfg))
    mesh = single_device_mesh()
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)

    def j_make():
        return j_trainer.Trainer(
            mesh=mesh, init_params_fn=lambda r: jl.init_params(r, jcfg),
            params_logical_axes=jl.param_logical_axes(jcfg),
            loss_fn=j_trainer.lm_loss_fn(jl.forward, jcfg),
            config=j_trainer.TrainerConfig(**kw))

    def j_batches(start):
        return (j_data.put_batch(mesh, b) for b in j_data.
                synthetic_lm_batches(jcfg.vocab_size, 4, 16,
                                     start_step=start))

    j_ckpt = str(tmp_path / "jax")
    with pytest.raises(Killed):
        j_loop.fit(j_make(), j_batches, rng=jax.random.key(0), max_steps=6,
                   checkpoint_dir=j_ckpt, checkpoint_every=2,
                   on_step=_kill_at(3))
    deadline = time.time() + 60        # Orbax finalizes step 2 async
    while time.time() < deadline and not os.path.isdir(
            os.path.join(j_ckpt, "2")):
        time.sleep(0.05)
    j_losses, on_step = _losses()
    jr = j_loop.fit(j_make(), j_batches, rng=jax.random.key(0),
                    max_steps=6, checkpoint_dir=j_ckpt, checkpoint_every=2,
                    on_step=on_step)

    tcfg = interop.config_from_jax(jcfg)
    init = lambda g: interop.params_from_jax(host, device="cpu")
    t_ckpt = str(tmp_path / "port")
    with pytest.raises(Killed):
        fit(_trainer(init=init, cfg=tcfg), _batches, max_steps=6,
            checkpoint_dir=t_ckpt, checkpoint_every=2, on_step=_kill_at(3))
    t_losses, on_step = _losses()
    tr = fit(_trainer(init=init, cfg=tcfg), _batches, max_steps=6,
             checkpoint_dir=t_ckpt, checkpoint_every=2, on_step=on_step)
    assert jr.resumed_from == tr.resumed_from == 2
    assert jr.final_step == tr.final_step == 6
    assert sorted(t_losses) == sorted(j_losses) == [3, 4, 5, 6]
    for step in t_losses:
        np.testing.assert_allclose(t_losses[step], j_losses[step],
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")

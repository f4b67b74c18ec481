"""The PyTorch port's MPMD pipeline runtime
(``kubeflow_tpu_torch.parallel.mpmd``) against the JAX package's
(``kubeflow_tpu.parallel.mpmd``) on the CPU: the schedules and the stash
and bubble formulas, the measurement math, the transport (the TCP cases
of tests/test_mpmd.py), the bitwise contract across schedules, the
losses against JAX's ``run_inproc`` on JAX's own parameters and batches
(``interop.mpmd_mlp_from_jax``), and against the port's ``run_oracle``
(the SPMD ``pipeline_apply`` over ``total_stages`` gloo processes).

Tolerances, each with its reason:
- the schedules, stash bounds, bubble bounds and the measurement math
  are pure Python and compared for equality;
- GPipe, 1F1B and interleaved 1F1B over one partition: bitwise (the same
  per-microbatch programs on the same inputs, gradients reduced in one
  fixed order by the same add);
- against JAX's ``run_inproc``: step 0 within 1e-6 relative, every step
  within 1e-5 (float32 products and tanh in another library: a few ulps
  at step 0, compounded over the SGD steps after it);
- the port's ``run_oracle`` against its ``run_inproc``: the same limits
  (another program for the same arithmetic; measured bitwise here).
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel import mpmd as jm
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.parallel import mpmd as tm
from kubeflow_tpu_torch.parallel.depot import DepotHandle, DepotStats

TINY = dict(n_stages=2, microbatches=4, global_batch=32, dim=48,
            layers_per_stage=2, steps=4)
STEP0_RTOL, RTOL = 1e-6, 1e-5


def interleaved_cfg(module, schedule, n_stages, virtual_stages=1):
    """tests/test_mpmd_interleaved.py's config (4 chunks of 1 layer)."""
    return module.PipelineRunConfig(
        schedule=schedule, n_stages=n_stages,
        virtual_stages=virtual_stages, microbatches=4, global_batch=8,
        dim=16, layers_per_stage=1, steps=3)


def jax_spec(jcfg) -> tm.MLPSpec:
    """The port's spec over JAX's parameters and batches."""
    return tm.MLPSpec(**interop.mpmd_mlp_from_jax(
        [jax.device_get(jm.init_stage_params(jcfg, c))
         for c in range(jcfg.total_stages)],
        jax.device_get(jm.init_head_params(jcfg)),
        [tuple(np.asarray(a) for a in jm.step_batch(jcfg, k))
         for k in range(jcfg.steps)]))


def assert_losses_close(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0], want[0], rtol=STEP0_RTOL, atol=0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


# ------------------------------------------------------------ schedules --

GRID = [(2, 4, 1), (2, 1, 1), (3, 6, 1), (4, 8, 1), (4, 2, 1), (2, 4, 2),
        (2, 8, 2), (2, 4, 4), (3, 6, 2), (4, 8, 2)]


@pytest.mark.parametrize("S,M,V", GRID)
def test_schedules_and_bounds_equal_jax(S, M, V):
    """``schedule_ticks`` of every stage and schedule, ``max_live_stash``,
    ``interleaved_stash_bound`` and ``analytic_bubble_bound``: equal to
    the reference's."""
    schedules = ["gpipe", "1f1b"] if V == 1 else ["interleaved-1f1b"]
    for sched in schedules:
        for s in range(S):
            mine = tm.schedule_ticks(sched, S, s, M, V)
            assert mine == jm.schedule_ticks(sched, S, s, M, V)
            assert tm.max_live_stash(mine) == jm.max_live_stash(mine)
            if V > 1:
                assert tm.interleaved_stash_bound(S, s, M, V) == \
                    jm.interleaved_stash_bound(S, s, M, V)
                assert tm.max_live_stash(mine) <= \
                    tm.interleaved_stash_bound(S, s, M, V)
    assert tm.analytic_bubble_bound(S, M, V) == jm.analytic_bubble_bound(
        S, M, V)
    assert tm.analytic_bubble_bound(S, M) == jm.analytic_bubble_bound(S, M)


@pytest.mark.parametrize("kw", [
    dict(n_stages=1), dict(global_batch=30), dict(schedule="zigzag"),
    dict(virtual_stages=0), dict(schedule="interleaved-1f1b"),
    dict(schedule="interleaved-1f1b", virtual_stages=2, microbatches=5,
         global_batch=40),
    dict(schedule="1f1b", virtual_stages=2)])
def test_config_validation_equals_jax(kw):
    with pytest.raises(ValueError) as want:
        jm.PipelineRunConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        tm.PipelineRunConfig(**kw).validate()
    assert str(got.value) == str(want.value)


def test_config_from_env_equals_jax():
    env = {"KFT_NUM_STAGES": "3", "KFT_MPMD_MICROBATCHES": "6",
           "KFT_MPMD_BATCH": "48", "KFT_MPMD_DIM": "32",
           "KFT_MPMD_LAYERS": "1", "KFT_MPMD_STEPS": "2",
           "KFT_MPMD_LR": "0.1", "KFT_MPMD_SEED": "7",
           "KFT_MPMD_SCHEDULE": "interleaved-1f1b",
           "KFT_MPMD_DCN_DELAY_MS": "2.5", "KFT_VIRTUAL_STAGES": "2"}
    for e in (env, {}):
        assert dataclasses.asdict(tm.PipelineRunConfig.from_env(e)) == \
            dataclasses.asdict(jm.PipelineRunConfig.from_env(e))


# ---------------------------------------------------------- measurement --

def synthetic_reports(n_stages: int):
    mk = lambda busy: [{"t0": float(k), "t1": float(k) + 1.0,
                        "busy_s": busy, "send_block_s": 0.0}
                       for k in range(3)]
    return [{"stage": s, "step_stats": mk(0.8 - 0.2 * s),
             "max_stash": 4 - s,
             "transport": {"wire_s": 1.0, "send_block_s": 0.25 + 0.5 * s,
                           "recv_block_s": 0.0}}
            for s in range(n_stages)]


@pytest.mark.parametrize("kw", [
    dict(schedule="gpipe"), dict(schedule="1f1b", n_stages=3,
                                 microbatches=6, global_batch=48),
    dict(schedule="interleaved-1f1b", virtual_stages=2)])
def test_aggregate_stats_equal_jax(kw):
    """The same synthetic per-stage reports (test_mpmd.py's, one per
    stage) through both: the same dict, the known bubble and overlap."""
    cfg = {**dict(n_stages=2, microbatches=4, global_batch=32, dim=8,
                  steps=3), **kw}
    reports = synthetic_reports(cfg["n_stages"])
    got = tm.aggregate_stats(reports, tm.PipelineRunConfig(**cfg))
    assert got == jm.aggregate_stats(reports, jm.PipelineRunConfig(**cfg))
    if cfg["n_stages"] == 2:
        assert got["bubble_fraction"] == pytest.approx(0.3)
        assert got["dcn_overlap_fraction"] == pytest.approx(0.5)


def test_aggregate_stats_requires_all_stages():
    report = {"stage": 0, "step_stats": [], "max_stash": 1, "transport": {}}
    with pytest.raises(ValueError, match="need all 2 stage reports"):
        tm.aggregate_stats([report], tm.PipelineRunConfig(**TINY))


# ------------------------------------------------------------ transport --

def test_tcp_channel_roundtrip_and_out_of_order_keys():
    a = tm.TCPStageChannel("127.0.0.1:0", prev=None, next=None, stage=0)
    b = tm.TCPStageChannel("127.0.0.1:0", prev=a.address, next=None,
                           stage=1)
    a.next_addr = b.address
    try:
        a.send_act(0, 1, np.full((2, 2), 1.0, np.float32))
        a.send_act(0, 0, np.full((2, 2), 7.0, np.float32))
        got0 = b.recv_act(0, 0)
        got1 = b.recv_act(0, 1)
        assert got0[0, 0] == 7.0 and got1[0, 0] == 1.0
        b.send_grad(0, 0, np.zeros((1,), np.float32))
        assert a.recv_grad(0, 0).shape == (1,)
        s = a.stats.snapshot()
        assert s["sends"] == 2 and s["bytes_sent"] > 0 and s["wire_s"] > 0
        assert b.stats.snapshot()["recvs"] == 2
    finally:
        a.close()
        b.close()


def test_bind_falls_back_to_all_interfaces_for_service_names():
    ch = tm.TCPStageChannel("job-stage-0.default.svc:0", prev=None,
                            next=None, stage=0)
    try:
        assert ch.address.startswith("job-stage-0.default.svc:")
        assert int(ch.address.rsplit(":", 1)[1]) > 0
    finally:
        ch.close()


def test_async_sender_failure_poisons_recv_promptly():
    tx = tm.TCPStageChannel("127.0.0.1:0", prev=None, next="127.0.0.1:1",
                            stage=0, blocking=False, timeout_s=30.0)
    tx.timeout_s = 0.3
    try:
        tx.send_act(0, 0, np.zeros((2,), np.float32))
        time.sleep(1.0)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="stage transport failed"):
            tx.recv_grad(0, 0)
        assert time.perf_counter() - t0 < 1.0      # poison, not timeout
        assert tx.counts.snapshot()["mailbox_poisons"] == 1
    finally:
        tx.close()


def test_recv_timeout_raises():
    a = tm.TCPStageChannel("127.0.0.1:0", prev=None, next=None, stage=0,
                           timeout_s=0.2)
    try:
        with pytest.raises(TimeoutError):
            a.recv_act(0, 0)
        assert a.stats.snapshot()["recv_block_s"] >= 0.2
        assert a.counts.snapshot()["recv_timeouts"] == 1
    finally:
        a.close()


def test_async_send_hides_wire_time_blocking_exposes_it():
    delay = 0.05
    payload = np.zeros((64, 64), np.float32)

    def run(blocking):
        rx = tm.TCPStageChannel("127.0.0.1:0", prev=None, next=None,
                                stage=1)
        tx = tm.TCPStageChannel("127.0.0.1:0", prev=None, next=rx.address,
                                stage=0, blocking=blocking, delay_s=delay)
        try:
            for i in range(3):
                tx.send_act(0, i, payload)
            for i in range(3):
                rx.recv_act(0, i)
            return tx.stats.snapshot()
        finally:
            tx.close()
            rx.close()

    blocked = run(True)
    assert blocked["send_block_s"] >= 3 * delay
    hidden = run(False)
    assert hidden["wire_s"] >= 3 * delay
    assert hidden["send_block_s"] < delay


def test_barrier_and_stale_frames():
    """The chain barrier releases both stages; a frame of another epoch
    is fenced at ingress; parked frames are drained and counted."""
    import threading

    a = tm.TCPStageChannel("127.0.0.1:0", prev=None, next=None, stage=0,
                           timeout_s=10.0)
    b = tm.TCPStageChannel("127.0.0.1:0", prev=a.address, next=None,
                           stage=1, timeout_s=10.0)
    a.next_addr = b.address
    try:
        t = threading.Thread(target=a.barrier_ready)
        t.start()
        b.barrier_ready()
        t.join(timeout=10.0)
        assert not t.is_alive()
        old = tm.TCPStageChannel("127.0.0.1:0", prev=None, next=b.address,
                                 stage=0, epoch=1)
        old.send_act(0, 0, np.ones((2,), np.float32))
        old.close()
        a.send_act(0, 1, np.ones((2,), np.float32))
        deadline = time.monotonic() + 5.0
        while b.counts.snapshot()["stale_frames_fenced"] < 1 or \
                b.stats.snapshot()["recvs"] < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert b.drain_stale() == 1
        assert b.counts.snapshot()["stale_frames_fenced"] == 2
    finally:
        a.close()
        b.close()


# ------------------------------------------------------------- numerics --

def test_gpipe_and_1f1b_bitwise_identical():
    res_g, losses_g = tm.run_inproc(
        tm.PipelineRunConfig(schedule="gpipe", **TINY), device="cpu")
    res_f, losses_f = tm.run_inproc(
        tm.PipelineRunConfig(schedule="1f1b", **TINY), device="cpu")
    assert len(losses_g) == TINY["steps"]
    assert losses_g == losses_f
    assert [r.max_stash for r in res_g] == [4, 4]
    assert [r.max_stash for r in res_f] == [2, 1]


def test_interleaved_bitwise_vs_gpipe_and_1f1b():
    """tests/test_mpmd_interleaved.py's 4-chunk partition: interleaved
    1F1B (S=2, V=2), GPipe and 1F1B at S=4, bitwise; every worker's
    stash within its bound, stage 0 holding more than stage 1."""
    res_i, li = tm.run_inproc(
        interleaved_cfg(tm, "interleaved-1f1b", 2, 2), device="cpu")
    _, lg = tm.run_inproc(interleaved_cfg(tm, "gpipe", 4), device="cpu")
    _, lf = tm.run_inproc(interleaved_cfg(tm, "1f1b", 4), device="cpu")
    assert li == lg == lf
    for r in res_i:
        assert r.max_stash <= tm.interleaved_stash_bound(2, r.stage, 4, 2)
    assert res_i[0].max_stash > res_i[1].max_stash


def test_measured_run_reports_bubble_and_overlap():
    cfg = tm.PipelineRunConfig(schedule="gpipe", **TINY)
    res, _ = tm.run_inproc(cfg, device="cpu")
    agg = tm.aggregate_stats(res, cfg)
    assert 0.0 < agg["bubble_fraction"] < 1.0
    assert agg["dcn_overlap_fraction"] is not None
    assert agg["dcn_wire_s"] > 0
    assert agg["max_activation_stash"] == cfg.microbatches


@pytest.mark.parametrize("case", ["tiny", "interleaved"])
def test_losses_match_jax_run_inproc_and_oracle(case):
    """On JAX's parameters and batches: the port's ``run_inproc`` against
    JAX's, and the port's ``run_oracle`` against its ``run_inproc``."""
    if case == "tiny":
        jcfg = jm.PipelineRunConfig(schedule="1f1b", **TINY)
        cfg = tm.PipelineRunConfig(schedule="1f1b", **TINY)
    else:
        jcfg = interleaved_cfg(jm, "interleaved-1f1b", 2, 2)
        cfg = interleaved_cfg(tm, "interleaved-1f1b", 2, 2)
    _, want = jm.run_inproc(jcfg)
    spec = jax_spec(jcfg)
    _, got = tm.run_inproc(cfg, spec=spec, device="cpu")
    assert_losses_close(got, want)
    assert_losses_close(tm.run_oracle(cfg, spec=spec, device="cpu"), got)


def test_oracle_matches_run_inproc_on_own_draws():
    """The port's own seeded draws (three stages, as test_mpmd.py's
    three-stage case): the oracle reproduces the MPMD run."""
    cfg = tm.PipelineRunConfig(n_stages=3, microbatches=3, global_batch=24,
                               dim=32, layers_per_stage=1, steps=3,
                               schedule="1f1b")
    _, losses = tm.run_inproc(cfg, device="cpu")
    assert_losses_close(tm.run_oracle(cfg, device="cpu"), losses)


def test_own_draws_are_seeded():
    """Parameters from (seed, chunk), batches from (seed + 100003,
    step): the same in every process, distinct across keys."""
    cfg = tm.PipelineRunConfig(**TINY)
    a, b = tm.init_stage_params(cfg, 0, "cpu"), tm.init_stage_params(
        cfg, 0, "cpu")
    assert torch.equal(a["w"], b["w"]) and not torch.equal(
        a["w"], tm.init_stage_params(cfg, 1, "cpu")["w"])
    assert a["w"].shape == (2, 48, 48) and not a["b"].any()
    x0, t0 = tm.step_batch(cfg, 0)
    assert x0.shape == (32, 48) and t0.shape == (32, 1)
    assert np.array_equal(x0, tm.step_batch(cfg, 0)[0])
    assert not np.array_equal(x0, tm.step_batch(cfg, 1)[0])


def test_runtime_depot_outcomes_and_cpu_only_when_asked(monkeypatch):
    """``depot_summary`` reports each program under the reference's keys
    (``fwd.c{chunk}`` under interleaving, ``head`` on the last worker)
    through ``local_capture``: "compiled" with one compile and one
    serialize failure each under a depot."""
    cfg = interleaved_cfg(tm, "interleaved-1f1b", 2, 2)
    stats = DepotStats()
    rt = tm.StageRuntime(cfg, 1, device="cpu", depot=DepotHandle("/x"),
                         depot_stats=stats)
    summary = rt.depot_summary()
    assert set(summary["outcomes"]) == {"fwd.c1", "bwd.c1", "fwd.c3",
                                        "bwd.c3", "head.c3"}
    assert set(summary["outcomes"].values()) == {"compiled"}
    assert summary["counters"] == {"compiles": 5, "serialize_failures": 5}
    plain = tm.StageRuntime(tm.PipelineRunConfig(**TINY), 0, device="cpu")
    assert plain.depot_summary()["outcomes"] == {"fwd": "no_depot",
                                                 "bwd": "no_depot"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.StageRuntime(tm.PipelineRunConfig(**TINY), 0)

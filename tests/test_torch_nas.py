"""The PyTorch port's DARTS (``kubeflow_tpu_torch.hpo.nas``) against the
JAX package's ``darts_search`` on the CPU, on the two contracts of
tests/test_nas.py (the cell must select ``square`` for ``y = (x·w)²``;
the linear target must fit), on the same numpy data.

JAX's initial weights are threefry draws that torch cannot reproduce,
so the port is handed them (``weights0``, through
``interop.darts_weights0``). JAX's searched alphas and weights are read
by recording what its jitted steps return (``jax.jit`` seen through a
recorder in the module under test; the JAX package is unchanged).

Tolerances, each with its reason: after 60 steps the alphas and both
weight sets within 1e-5 absolute (float32 products and gradients in
another order than XLA's, over a few dozen small steps); after the JAX
tests' 800 steps the same ops selected and the val loss within 1e-3 of
JAX's (the same discrete cell, retrained 800 steps from the same
weights: the round-off of the two libraries' gradients compounds but
stays far below the contracts' limits).

``tests/golden/darts_jax_weights0.json`` holds JAX's draws of the two
contracts, which ``chip_smoke.py`` (no JAX there) runs on the card;
``test_golden_weights0_are_jax_draws`` checks them against JAX's draws
now (regenerate deliberately with ``UPDATE_GOLDEN=1``).
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.hpo import nas as jn
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.hpo import nas as tn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "darts_jax_weights0.json")
OPS = ("identity", "relu", "tanh", "square")
STATE_ATOL = 1e-5
VAL_ATOL = 1e-3


def contract_data(name: str):
    """tests/test_nas.py's data: (x_train, y_train, x_val, y_val), the
    search's n_nodes and seed."""
    rng = np.random.default_rng(0 if name == "square" else 1)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    w = rng.normal(size=(4, 2)).astype(np.float32)
    y = (((x @ w) ** 2) if name == "square" else (x @ w)).astype(np.float32)
    n_nodes, seed = (1, 0) if name == "square" else (2, 1)
    return (x[:192], y[:192], x[192:], y[192:]), n_nodes, seed


def jax_draw(seed: int, d_in: int, d_out: int, width: int) -> dict:
    """``darts_search``'s draw of initial weights from ``seed``."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    return {"w_in": np.asarray(jax.random.normal(k1, (d_in, width))
                               / math.sqrt(d_in)),
            "w_out": np.asarray(jax.random.normal(k2, (width, d_out))
                                / math.sqrt(width))}


def jax_weights0(seed: int) -> dict:
    return interop.darts_weights0(jax_draw(seed, 4, 2, 8),
                                  jax_draw(seed + 1, 4, 2, 8))


class _Recorder:
    """``jax`` as ``kubeflow_tpu.hpo.nas`` sees it, except that ``jit``
    records the last value each jitted step returned, by its name."""

    def __init__(self):
        self.last = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        compiled = jax.jit(fn)

        def call(*args):
            out = compiled(*args)
            self.last[fn.__name__] = jax.device_get(out)
            return out
        return call


def jax_run(monkeypatch, name: str, steps: int):
    data, n_nodes, seed = contract_data(name)
    rec = _Recorder()
    monkeypatch.setattr(jn, "jax", rec)
    selected, val = jn.darts_search(*data, ops=OPS, n_nodes=n_nodes,
                                    steps=steps, seed=seed)
    return selected, val, rec.last


def port_run(name: str, steps: int, weights0=None):
    data, n_nodes, seed = contract_data(name)
    return tn.darts_run(*data, ops=OPS, n_nodes=n_nodes, steps=steps,
                        seed=seed, device="cpu", weights0=weights0)


@pytest.mark.parametrize("name", ["square", "linear"])
def test_darts_state_matches_jax_after_60_steps(monkeypatch, name):
    """From JAX's initial weights, 60 steps (15 of warm-up): the alphas,
    the searched weights and the retrained weights within 1e-5 of
    JAX's, and the same ops selected."""
    selected, val, last = jax_run(monkeypatch, name, 60)
    run = port_run(name, 60, jax_weights0(contract_data(name)[2]))
    assert run.selected == selected
    np.testing.assert_allclose(run.alphas.numpy(), last["a_step"],
                               rtol=0, atol=STATE_ATOL)
    for got, want in ((run.weights, last["w_step"]),
                      (run.retrained, last["retrain_step"])):
        for k in ("w_in", "w_out"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=STATE_ATOL, err_msg=k)
    assert abs(run.val - val) <= STATE_ATOL


@pytest.mark.parametrize("name", ["square", "linear"])
def test_darts_contracts_match_jax_at_800_steps(monkeypatch, name):
    """tests/test_nas.py's runs: from JAX's initial weights the port
    selects JAX's ops (``["square"]`` for the square target), its val
    is within 1e-3 of JAX's, and the contract's limit holds."""
    selected, val, _ = jax_run(monkeypatch, name, 800)
    mine, mine_val = tn.darts_search(
        *contract_data(name)[0], ops=OPS, n_nodes=contract_data(name)[1],
        steps=800, seed=contract_data(name)[2], device="cpu",
        weights0=jax_weights0(contract_data(name)[2]))
    assert mine == selected
    assert abs(mine_val - val) <= VAL_ATOL, (mine_val, val)
    if name == "square":
        assert mine == ["square"] and mine_val < 0.5
    else:
        assert mine_val < 0.06


def test_darts_linear_contract_on_own_generator():
    """The linear target fits (val < 0.06) from the port's own seeded
    draw, as from JAX's."""
    selected, val = tn.darts_search(*contract_data("linear")[0], ops=OPS,
                                    n_nodes=2, steps=800, seed=1,
                                    device="cpu")
    assert len(selected) == 2 and val < 0.06, (selected, val)


def test_own_generator_is_seeded_and_device_independent():
    """The port's draw is a function of the seed alone: two runs agree
    bitwise, another seed differs."""
    data, n_nodes, _ = contract_data("square")
    a = tn.darts_run(*data, ops=OPS, n_nodes=n_nodes, steps=5, seed=3,
                     device="cpu")
    b = tn.darts_run(*data, ops=OPS, n_nodes=n_nodes, steps=5, seed=3,
                     device="cpu")
    c = tn.darts_run(*data, ops=OPS, n_nodes=n_nodes, steps=5, seed=4,
                     device="cpu")
    assert torch.equal(a.weights["w_in"], b.weights["w_in"])
    assert a.val == b.val and a.val != c.val


@pytest.mark.parametrize("op", sorted(tn.CANDIDATE_OPS))
def test_candidate_ops_match_jax(op):
    x = np.random.default_rng(5).normal(size=(16, 8)).astype(np.float32)
    x[0, :3] = 0.0                               # relu's kink
    want = np.asarray(jn.CANDIDATE_OPS[op](jax.numpy.asarray(x)))
    got = tn.CANDIDATE_OPS[op](torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_weights0_shapes_are_checked():
    data, n_nodes, _ = contract_data("square")
    w0 = jax_weights0(0)
    w0["retrain"]["w_out"] = w0["retrain"]["w_out"][:, :1]
    with pytest.raises(ValueError, match="weights0"):
        tn.darts_search(*data, ops=OPS, n_nodes=n_nodes, steps=1,
                        device="cpu", weights0=w0)


def test_golden_weights0_are_jax_draws():
    """The card's copy of JAX's draws (``chip_smoke.py`` phase 10d)."""
    want = {name: jax_weights0(contract_data(name)[2])
            for name in ("square", "linear")}
    as_lists = {name: {part: {k: v.tolist() for k, v in tree.items()}
                       for part, tree in w.items()}
                for name, w in want.items()}
    if os.environ.get("UPDATE_GOLDEN"):
        with open(GOLDEN, "w") as f:
            json.dump(as_lists, f, indent=1)
            f.write("\n")
    with open(GOLDEN) as f:
        golden = json.load(f)
    for name, w in want.items():
        for part, tree in w.items():
            for k, v in tree.items():
                assert np.array_equal(
                    np.asarray(golden[name][part][k], np.float32), v), \
                    (name, part, k)

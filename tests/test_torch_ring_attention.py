"""Ring and Ulysses attention over the ``context`` axis
(``kubeflow_tpu_torch/parallel/ring_attention.py``) against the JAX
package's ``ring_attention`` / ``ulysses_attention`` on the CPU, in
float32, on the same numpy-seeded inputs.

The port's ranks are spawned as processes that talk over gloo
(``tools/world_train.run``): one world of four processes, which runs
``context=4`` and ``data=2 x context=2`` one after the other
(``world_train.plans_rank``). Each rank takes its rows (its place in the
batch axes) and its chunk of the sequence of whole inputs, runs the
layer (each ring step through the flash wrappers, whose plain versions
run on CPU tensors) and the backward of ``sum(o * w)``; the test puts
the chunks back together. The oracle is the JAX function under
``shard_map`` on ``build_mesh(MeshConfig(data=, context=))`` over
tests/conftest.py's host devices, and ``jax.grad`` of the same loss.

Tolerances, each with its reason:
- the layer's output and its input gradients: 1e-5 absolute on values
  of magnitude up to ~10 (both sides float32; the port merges each
  block's flash output by log-sum-exp where the JAX function rescales a
  running sum, and sums the blocks' dK/dV in another order; the outputs
  read up to 6e-7);
- llama's ring forward against JAX's: 2e-5 absolute on logits of
  magnitude up to ~3 (two float32 layers of products and norms in
  another order around the attention; reads 2.7e-6);
- the Ulysses error message: equal to JAX's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.parallel.ring_attention import (
    ring_attention as j_ring, ulysses_attention as j_ulysses,
)
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel import ring_attention as t_ring
from kubeflow_tpu_torch.tools import world_train as wt
from test_torch_flash_attention import warm_up_cpu_exp

warm_up_cpu_exp()      # the first CPU exp of a process can be inexact

LAYER_ATOL = 1e-5
LOGITS_ATOL = 2e-5

# (name, impl, causal, H, KV): the heads of each case (Ulysses needs KV
# divisible by the context axis: 4 divides over context=4 and 2)
CASES = [("ring-causal", "ring", True, 4, 2),
         ("ring-full", "ring", False, 4, 2),
         ("ring-gqa4", "ring", True, 8, 2),
         ("ulysses-causal", "ulysses", True, 8, 4),
         ("ulysses-full", "ulysses", False, 8, 4)]
# (data, context) of each layout of the four processes
LAYOUTS = [(1, 4), (2, 2)]
B, S, D = 2, 32, 16


def layer_inputs(h, kv, seed):
    """q [B, S, h, D], k/v [B, S, kv, D] and the loss weights on the
    output, float32, from ``seed``."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"q": f(B, S, h, D), "k": f(B, S, kv, D), "v": f(B, S, kv, D),
            "w": f(B, S, h, D)}


def layer_rank(mesh) -> dict:
    """Each case of CASES on this rank's rows and chunk: its output and
    the gradients of its q, k and v under ``sum(o * w)``, and where they
    lie ((row start, row stop), (token start, token stop))."""
    nb, b = mesh.axis_size("batch"), mesh.axis_index("batch")
    n, c = mesh.axis_size("context"), mesh.axis_index("context")
    rows = slice(b * B // nb, (b + 1) * B // nb)
    toks = slice(c * S // n, (c + 1) * S // n)
    out = []
    for i, (_, impl, causal, h, kv) in enumerate(CASES):
        whole = layer_inputs(h, kv, i)
        part = {k: torch.tensor(x[rows, toks]) for k, x in whole.items()}
        q, k, v = (part[x].requires_grad_(True) for x in "qkv")
        fn = t_ring.ring_attention if impl == "ring" \
            else t_ring.ulysses_attention
        o = fn(q, k, v, mesh, causal=causal)
        (o * part["w"]).sum().backward()
        out.append({"o": o.detach(), "q": q.grad, "k": k.grad,
                    "v": v.grad})
    return {"rows": (rows.start, rows.stop), "toks": (toks.start, toks.stop),
            "cases": out, "timings": dict(mesh.timings)}


def _tiny_ring():
    return jl.llama_tiny(dtype=jnp.float32, attn_impl="ring")


def _llama_inputs():
    params = jax.device_get(jl.init_params(jax.random.key(2), _tiny_ring()))
    tokens = np.tile(np.arange(32, dtype=np.int32)[None], (4, 1))
    return params, tokens


def llama_rank(mesh) -> dict:
    """llama's forward with ring attention over the world on this rank's
    chunk of tests/test_ring_attention.py's tokens (four rows of 0..31),
    from the JAX parameters: its logits and its token range."""
    params, tokens = _llama_inputs()
    cfg = interop.config_from_jax(_tiny_ring())
    n, c = mesh.axis_size("context"), mesh.axis_index("context")
    sl = tokens.shape[1] // n
    logits = tl.forward(interop.params_from_jax(params, device="cpu"),
                        torch.tensor(tokens[:, c * sl:(c + 1) * sl]), cfg,
                        mesh=mesh)
    return {"toks": (c * sl, (c + 1) * sl), "logits": logits.detach()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One world of four processes: the layer under each of LAYOUTS,
    then llama's ring forward under context=4."""
    plans = [(d, 1, 1, 1, c, layer_rank, ()) for d, c in LAYOUTS]
    plans.append((1, 1, 1, 1, 4, llama_rank, ()))
    root = tmp_path_factory.mktemp("ring")
    return wt.run(wt.plans_rank, (plans,), 1, 1, ["cpu"] * 4,
                  str(root / "world"), context=4)


def _jax_mesh(data, context):
    return build_mesh(MeshConfig(data=data, context=context, fsdp=1,
                                 tensor=1),
                      devices=jax.devices()[:data * context])


def _assemble(results, case, key):
    """The whole [B, S, ...] tensor of ``key`` from every rank's part."""
    first = results[0]["cases"][case][key]
    out = torch.zeros((B, S, *first.shape[2:]))
    for r in results:
        (a, b), (s, t) = r["rows"], r["toks"]
        out[a:b, s:t] = r["cases"][case][key]
    return out.numpy()


@pytest.mark.parametrize("layout", range(len(LAYOUTS)),
                         ids=[f"data{d}-context{c}" for d, c in LAYOUTS])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_layer_matches_the_jax_function_and_jax_grad(ranks, layout, case):
    """The ranks' outputs and input gradients, put together, against the
    JAX function on the same layout's mesh and ``jax.grad`` of
    ``sum(o * w)``; the context collectives were counted."""
    data, context = LAYOUTS[layout]
    _, impl, causal, h, kv = CASES[case]
    results = [r[layout] for r in ranks]
    whole = layer_inputs(h, kv, case)
    mesh = _jax_mesh(data, context)
    fn = j_ring if impl == "ring" else j_ulysses

    def loss(q, k, v):
        o = fn(q, k, v, mesh, causal=causal)
        return (o * jnp.asarray(whole["w"])).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(whole[x]) for x in "qkv"))
    want = {"o": o, "q": grads[0], "k": grads[1], "v": grads[2]}
    for key, ref in want.items():
        np.testing.assert_allclose(
            _assemble(results, case, key), np.asarray(ref), rtol=0,
            atol=LAYER_ATOL, err_msg=f"{impl} causal={causal} {key}")
    for r in results:
        assert r["timings"]["context_calls"] > 0
        assert r["timings"]["context_bytes"] > 0


def test_ulysses_rejects_indivisible_heads_with_the_jax_message():
    """KV heads that the context axis does not divide raise ValueError
    with the JAX package's message, before any collective."""
    whole = layer_inputs(4, 2, 0)
    with pytest.raises(ValueError) as want:
        j_ulysses(*(jnp.asarray(whole[x]) for x in "qkv"), _jax_mesh(1, 4))
    world = types.SimpleNamespace(axis_size=lambda axis: 4)
    with pytest.raises(ValueError) as got:
        t_ring.ulysses_attention(
            *(torch.tensor(whole[x]) for x in "qkv"), world)
    assert str(got.value) == str(want.value)
    assert "divisible by mesh axis 'context' (4)" in str(got.value)


def test_context_impls_need_a_world():
    """Without a world, ring and Ulysses raise as the JAX model does
    (``attn_impl=... requires mesh=``); over one rank they are the plain
    flash call."""
    cfg = tl.llama_tiny(dtype=torch.float32, attn_impl="ring")
    params = tl.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.arange(8)[None]
    with pytest.raises(ValueError, match="requires mesh="):
        tl.forward(params, tokens, cfg)
    whole = layer_inputs(4, 2, 0)
    q, k, v = (torch.tensor(whole[x]) for x in "qkv")
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention

    one = types.SimpleNamespace(axis_size=lambda axis: 1)
    for fn in (t_ring.ring_attention, t_ring.ulysses_attention):
        assert torch.equal(fn(q, k, v, one), flash_attention(q, k, v))


def test_llama_ring_forward_matches_the_jax_forward(ranks):
    """tests/test_ring_attention.py's end-to-end case: llama_tiny's
    forward with ring attention over context=4, each rank its chunk of
    the tokens, against the JAX forward with ring attention on a
    context=4 mesh."""
    from jax.sharding import NamedSharding

    from kubeflow_tpu.parallel.sharding import pspec, tree_shardings

    params, tokens = _llama_inputs()
    cfg = _tiny_ring()
    mesh = _jax_mesh(1, 4)
    sharded = jax.device_put(
        params, tree_shardings(mesh, jl.param_logical_axes(cfg)))
    tokens_sh = jax.device_put(jnp.asarray(tokens),
                               NamedSharding(mesh, pspec(("batch", "seq"))))
    ref = np.asarray(jax.jit(
        lambda p, t: jl.forward(p, t, cfg, mesh=mesh))(sharded, tokens_sh))
    got = np.zeros_like(ref)
    for r in ranks:
        a, b = r[len(LAYOUTS)]["toks"]
        got[:, a:b] = r[len(LAYOUTS)]["logits"].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGITS_ATOL)

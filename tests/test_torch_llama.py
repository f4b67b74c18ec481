"""The port's Llama model (``kubeflow_tpu_torch.models``) against the JAX
package's on the CPU in float32, on weights converted from the JAX tree
by ``interop.params_from_jax``.

Tolerance ~1e-4 on logits: two layers of float32 matmuls and softmaxes
whose sums run in another order in each framework.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import hf_llama as j_hf
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import hf_llama as t_hf
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.safetensors_io import SafetensorsFile

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(jcfg, seed=0):
    jp = jl.init_params(jax.random.key(seed), jcfg)
    return jp, interop.config_from_jax(jcfg), \
        interop.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp, tcfg, tp = _pair(jcfg)
    return jcfg, jp, tcfg, tp


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_params_from_jax_round_trip(tiny):
    jcfg, jp, tcfg, tp = tiny
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(tp["layers"]) + 2   # embed, final_norm
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tcfg.head_dim == jcfg.head_dim and tcfg.dtype == torch.float32
    for f in dataclasses.fields(tl.LlamaConfig):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    bf = interop.params_from_jax(jax.device_get(
        jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)), device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["embed"].float().numpy(),
        np.asarray(jp["embed"].astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("variant", ["tiny", "llama3_rope_untied"])
def test_forward_matches_jax(variant):
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    if variant != "tiny":
        jcfg = dataclasses.replace(jcfg, rope_scaling="llama3",
                                   tie_embeddings=False, n_layers=3)
    jp, tcfg, tp = _pair(jcfg, seed=1)
    toks = _tokens(1, 2, 24, jcfg.vocab_size)
    ref = np.asarray(jl.forward(jp, jnp.asarray(toks), jcfg))
    out = tl.forward(tp, torch.tensor(toks), tcfg)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)


def test_prefill_ragged_lengths_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    toks = _tokens(2, 3, 16, jcfg.vocab_size)
    lengths = np.array([16, 5, 1], np.int32)
    jlog, jcache = jl.prefill(jp, jnp.asarray(toks), jcfg,
                              jl.init_cache(jcfg, 3, 16),
                              lengths=jnp.asarray(lengths))
    tcache = tl.init_cache(tcfg, 3, 16, device="cpu")
    tlog, tcache = tl.prefill(tp, torch.tensor(toks), tcfg, tcache,
                              lengths=torch.tensor(lengths))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    np.testing.assert_array_equal(tcache["len"].numpy(), lengths)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **LOGIT_TOL)


def test_moe_and_int8_raise_naming_the_slice(tiny):
    jcfg, jp, tcfg, tp = tiny
    moe = dataclasses.replace(tcfg, n_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.forward(tp, torch.zeros((1, 4), dtype=torch.long), moe)
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.init_params(torch.Generator().manual_seed(0), moe, device="cpu")
    q8 = dict(tp, layers={**tp["layers"], "wq_q": tp["layers"]["wq"]})
    with pytest.raises(NotImplementedError, match="int8"):
        tl.forward(q8, torch.zeros((1, 4), dtype=torch.long), tcfg)


def test_init_params_layout_and_generator():
    cfg = tl.llama_tiny()
    p1 = tl.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    p2 = tl.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    jshapes = jax.eval_shape(lambda: jl.init_params(
        jax.random.key(0), jl.llama_tiny()))
    assert tuple(p1["layers"]["wq"].shape) == jshapes["layers"]["wq"].shape
    assert set(p1["layers"]) == set(jshapes["layers"])
    torch.testing.assert_close(p1["layers"]["wo"], p2["layers"]["wo"])
    std = p1["layers"]["w_gate"].std().item()
    assert abs(std - cfg.dim ** -0.5) < 0.02


def _save(tmp_path, jcfg, jp):
    model_dir = str(tmp_path / "ckpt")
    j_hf.save_pretrained(model_dir, jcfg, jp)
    return model_dir


@pytest.mark.parametrize("tie", [True, False])
def test_safetensors_checkpoint_logits(tmp_path, tie):
    """A checkpoint written by the JAX package's save_pretrained, read by
    the port's own safetensors reader, gives the JAX logits."""
    jcfg = dataclasses.replace(jl.llama_tiny(dtype=jnp.float32),
                               tie_embeddings=tie)
    jp = jl.init_params(jax.random.key(4), jcfg)
    model_dir = _save(tmp_path, jcfg, jp)
    tcfg, tp = t_hf.load_pretrained(model_dir, dtype=torch.float32,
                                    device="cpu")
    assert tcfg.tie_embeddings == tie and tcfg.n_kv_heads == jcfg.n_kv_heads
    assert ("lm_head" in tp) == (not tie)
    toks = _tokens(4, 2, 12, jcfg.vocab_size)
    np.testing.assert_allclose(
        tl.forward(tp, torch.tensor(toks), tcfg).numpy(),
        np.asarray(jl.forward(jp, jnp.asarray(toks), jcfg)), **LOGIT_TOL)


def test_safetensors_sharded_index_and_bf16(tmp_path):
    """The sharded model.safetensors.index.json form, with the shards
    stored in bf16, loads to the same values as the single file."""
    from safetensors.flax import load_file, save_file

    jcfg = jl.llama_tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(5), jcfg)
    model_dir = _save(tmp_path, jcfg, jp)
    _, single = t_hf.load_pretrained(model_dir, dtype=torch.float32,
                                     device="cpu")
    flat = load_file(os.path.join(model_dir, "model.safetensors"))
    names = sorted(flat)
    parts = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
             "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    weight_map = {}
    for fname, keys in parts.items():
        save_file({k: flat[k].astype(jnp.bfloat16) for k in keys},
                  os.path.join(model_dir, fname))
        weight_map.update({k: fname for k in keys})
    os.remove(os.path.join(model_dir, "model.safetensors"))
    with open(os.path.join(model_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"weight_map": weight_map}, f)
    tcfg, sharded = t_hf.load_pretrained(model_dir, dtype=torch.bfloat16,
                                         device="cpu")
    assert tcfg.dtype == torch.bfloat16
    assert sharded["embed"].dtype == torch.bfloat16
    for key in ("wq", "wo", "w_down"):
        np.testing.assert_array_equal(
            sharded["layers"][key].float().numpy(),
            single["layers"][key].to(torch.bfloat16).float().numpy())
    st = SafetensorsFile(os.path.join(model_dir,
                                      "model-00001-of-00002.safetensors"))
    assert set(st.keys()) == set(parts["model-00001-of-00002.safetensors"])
    st.close()

"""HF-layout Llama checkpoint loader (safetensors -> the port's parameter
dict), counterpart of ``kubeflow_tpu.models.hf_llama``, dense layout only.

The HF tensors map onto the JAX package's stacked layout exactly as the
JAX loader maps them: torch Linear ``[out, in]`` becomes ``[in, out]``
and the attention projections split their head dims. Tensors are read by
the port's own safetensors reader (``models/safetensors_io.py``), one at
a time, cast and moved to ``device`` as they arrive. HF Llama uses the
rotate-half RoPE layout that ``ops/rotary.py`` implements, so no weight
permutation is needed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.models.safetensors_io import CheckpointIndex


def config_from_hf(d: dict[str, Any], **overrides) -> llama.LlamaConfig:
    """Translate an HF LlamaConfig dict into the port's LlamaConfig."""
    rope_scaling = d.get("rope_scaling") or {}
    scaling_type = rope_scaling.get("rope_type") or rope_scaling.get("type")
    kw: dict[str, Any] = dict(
        vocab_size=d["vocab_size"],
        dim=d["hidden_size"],
        n_layers=d["num_hidden_layers"],
        n_heads=d["num_attention_heads"],
        n_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
        mlp_dim=d["intermediate_size"],
        max_seq=d.get("max_position_embeddings", 8192),
        rope_theta=float(d.get("rope_theta", 500000.0)),
        rope_scaling="llama3" if scaling_type == "llama3" else None,
        norm_eps=float(d.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(d.get("tie_word_embeddings", False)),
    )
    if d.get("num_local_experts"):
        kw["n_experts"] = int(d["num_local_experts"])
        kw["moe_top_k"] = int(d.get("num_experts_per_tok", 2))
    kw.update(overrides)
    return llama.LlamaConfig(**kw)


def load_config(model_dir: str, **overrides) -> llama.LlamaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        return config_from_hf(json.load(f), **overrides)


def load_params(model_dir: str, cfg: Optional[llama.LlamaConfig] = None, *,
                dtype=torch.bfloat16, device: DeviceLike = None):
    """Read an HF-layout Llama checkpoint into the stacked parameter dict
    on ``device`` (``device.resolve_device``: CUDA unless ``"cpu"`` is
    asked for) in ``dtype``. Returns (cfg, params)."""
    device = resolve_device(device)
    cfg = cfg or load_config(model_dir, dtype=dtype)
    llama.check_dense(cfg)
    idx = CheckpointIndex(model_dir)
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dim

    def get(name):
        return idx.get(name).to(device=device, dtype=dtype)

    def layer_stack(fmt: str, transform=lambda w: w) -> torch.Tensor:
        return torch.stack([transform(get(fmt.format(i)))
                            for i in range(cfg.n_layers)])

    layers = {
        "attn_norm": layer_stack("model.layers.{}.input_layernorm.weight"),
        "mlp_norm": layer_stack(
            "model.layers.{}.post_attention_layernorm.weight"),
        "wq": layer_stack("model.layers.{}.self_attn.q_proj.weight",
                          lambda w: w.T.reshape(d, h, hd)),
        "wk": layer_stack("model.layers.{}.self_attn.k_proj.weight",
                          lambda w: w.T.reshape(d, kv, hd)),
        "wv": layer_stack("model.layers.{}.self_attn.v_proj.weight",
                          lambda w: w.T.reshape(d, kv, hd)),
        "wo": layer_stack("model.layers.{}.self_attn.o_proj.weight",
                          lambda w: w.T.reshape(h, hd, d)),
        "w_gate": layer_stack("model.layers.{}.mlp.gate_proj.weight",
                              lambda w: w.T),
        "w_up": layer_stack("model.layers.{}.mlp.up_proj.weight",
                            lambda w: w.T),
        "w_down": layer_stack("model.layers.{}.mlp.down_proj.weight",
                              lambda w: w.T),
    }
    params = {
        "embed": get("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": get("model.norm.weight"),
    }
    if not cfg.tie_embeddings:
        name = ("lm_head.weight" if "lm_head.weight" in idx.names()
                else "model.embed_tokens.weight")
        params["lm_head"] = get(name).T.contiguous()
    idx.close()
    return cfg, params


def load_pretrained(model_dir: str, *, dtype=torch.bfloat16,
                    device: DeviceLike = None, **config_overrides):
    """One call: (LlamaConfig, params) from an HF checkpoint directory, on
    ``device`` as ``load_params`` places them. The param ``dtype`` doubles
    as the config's compute dtype unless a ``dtype`` config override says
    otherwise."""
    device = resolve_device(device)
    config_overrides.setdefault("dtype", dtype)
    cfg = load_config(model_dir, **config_overrides)
    return load_params(model_dir, cfg, dtype=dtype, device=device)

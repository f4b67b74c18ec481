"""HF-layout Llama checkpoint loader (safetensors -> the port's parameter
dict), counterpart of ``kubeflow_tpu.models.hf_llama``: the dense Llama
layout and Mixtral's ``block_sparse_moe`` layout.

The HF tensors map onto the JAX package's stacked layout exactly as the
JAX loader maps them: torch Linear ``[out, in]`` becomes ``[in, out]``
and the attention projections split their head dims. Tensors are read by
the port's own safetensors reader (``models/safetensors_io.py``), one at
a time, cast and moved to ``device`` as they arrive. HF Llama uses the
rotate-half RoPE layout that ``ops/rotary.py`` implements, so no weight
permutation is needed.

The sharded load (``mesh=``; the JAX loader's ``mesh`` path) gives one
rank of a serving mesh its shard: each HF tensor is read only in the
rows or columns that hold the rank's heads, MLP columns or vocab entries
(by its ``tensor`` index), so no rank reads or holds the whole tree: of
Mixtral's experts (``block_sparse_moe.experts.{e}.w1/w2/w3``) the rank
reads its ``mlp`` slice of its own experts (by its ``expert`` index)
and nothing of another rank's; the router is read whole. ``CheckpointParams`` is the same load as a
parameter source each rank of a serving engine calls itself.

``save_pretrained`` is the export path, the JAX package's
``save_pretrained`` with the port's own safetensors writer
(``safetensors_io.save_file``): ``config.json`` from ``config_to_hf``
and ``model.safetensors`` in the HF layout, in the tree's dtype, written
one tensor at a time from wherever the tree lives.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.models.safetensors_io import CheckpointIndex, save_file


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


def config_to_hf(cfg: llama.LlamaConfig) -> dict[str, Any]:
    """The port's LlamaConfig -> an HF config.json dict (the JAX
    package's ``config_to_hf``, field for field)."""
    d: dict[str, Any] = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.mlp_dim,
        "max_position_embeddings": cfg.max_seq,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": "bfloat16",
    }
    if cfg.rope_scaling == "llama3":
        d["rope_scaling"] = {
            "rope_type": "llama3", "factor": 8.0,
            "low_freq_factor": 1.0, "high_freq_factor": 4.0,
            "original_max_position_embeddings": cfg.max_seq,
        }
    if cfg.n_experts:
        d["architectures"] = ["MixtralForCausalLM"]
        d["model_type"] = "mixtral"
        d["num_local_experts"] = cfg.n_experts
        d["num_experts_per_tok"] = cfg.moe_top_k
    return d


def load_config(model_dir: str, **overrides) -> llama.LlamaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        return config_from_hf(json.load(f), **overrides)


def load_params(model_dir: str, cfg: Optional[llama.LlamaConfig] = None, *,
                dtype=torch.bfloat16, device: DeviceLike = None, mesh=None):
    """Read an HF-layout Llama checkpoint into the stacked parameter dict
    on ``device`` (``device.resolve_device``: CUDA unless ``"cpu"`` is
    asked for) in ``dtype``. Returns (cfg, params). With ``mesh``, the
    rank ``mesh.rank``'s shard of it, read slice by slice."""
    device = resolve_device(device)
    cfg = cfg or load_config(model_dir, dtype=dtype)
    idx = CheckpointIndex(model_dir)
    tp, rank = ((mesh.tp, mesh.tensor_index) if mesh is not None
                else (1, 0))
    ep, ex = (mesh.ep, mesh.expert_index) if mesh is not None else (1, 0)
    if cfg.n_experts % ep:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by "
                         f"expert={ep}")
    experts = range(ex * cfg.n_experts // ep,
                    (ex + 1) * cfg.n_experts // ep)
    h, kv, hd, d = (cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim,
                    cfg.dim)
    every = slice(None)

    def part(n: int) -> slice:
        """The rank's share of an HF dim of size n (rows of heads, MLP
        columns or vocab entries)."""
        return slice(rank * n // tp, (rank + 1) * n // tp)

    def get(name, index=None):
        return idx.get(name, index).to(device=device, dtype=dtype)

    def layer_stack(fmt: str, index=None,
                    transform=lambda w: w) -> torch.Tensor:
        return torch.stack([transform(get(fmt.format(i), index))
                            for i in range(cfg.n_layers)])

    def expert_stack(fmt: str, key: str, index) -> torch.Tensor:
        """Mixtral experts' [out, in] Linear weights -> [L, E', in, out]
        for the rank's E' experts, each read in the rank's ``index`` (of
        its mlp dim) and written one tensor at a time into the
        preallocated stack."""
        shape = list(llama.param_shapes(cfg)["layers"][key])
        shape[1] = len(experts)
        shape[3 if key in ("w_gate", "w_up") else 2] //= tp
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(cfg.n_layers):
            for j, e in enumerate(experts):
                out[i, j] = get(fmt.format(i, e), index).T
        return out

    rows_q = (part(cfg.n_heads * hd), every)
    rows_kv = (part(cfg.n_kv_heads * hd), every)
    rows_mlp, cols_mlp = (part(cfg.mlp_dim), every), (every, part(
        cfg.mlp_dim))
    rows_vocab = (part(cfg.vocab_size), every)
    layers = {
        "attn_norm": layer_stack("model.layers.{}.input_layernorm.weight"),
        "mlp_norm": layer_stack(
            "model.layers.{}.post_attention_layernorm.weight"),
        "wq": layer_stack("model.layers.{}.self_attn.q_proj.weight",
                          rows_q, lambda w: w.T.reshape(d, h, hd)),
        "wk": layer_stack("model.layers.{}.self_attn.k_proj.weight",
                          rows_kv, lambda w: w.T.reshape(d, kv, hd)),
        "wv": layer_stack("model.layers.{}.self_attn.v_proj.weight",
                          rows_kv, lambda w: w.T.reshape(d, kv, hd)),
        "wo": layer_stack("model.layers.{}.self_attn.o_proj.weight",
                          (every, part(cfg.n_heads * hd)),
                          lambda w: w.T.reshape(h, hd, d)),
    }
    if cfg.n_experts:
        layers["moe_router"] = layer_stack(
            "model.layers.{}.block_sparse_moe.gate.weight",
            transform=lambda w: w.T)
        for key, name, index in (("w_gate", "w1", rows_mlp),
                                 ("w_up", "w3", rows_mlp),
                                 ("w_down", "w2", cols_mlp)):
            layers[key] = expert_stack(
                "model.layers.{}.block_sparse_moe.experts.{}.%s.weight"
                % name, key, index)
    else:
        layers["w_gate"] = layer_stack(
            "model.layers.{}.mlp.gate_proj.weight", rows_mlp, lambda w: w.T)
        layers["w_up"] = layer_stack(
            "model.layers.{}.mlp.up_proj.weight", rows_mlp, lambda w: w.T)
        layers["w_down"] = layer_stack(
            "model.layers.{}.mlp.down_proj.weight", cols_mlp, lambda w: w.T)
    params = {
        "embed": get("model.embed_tokens.weight", rows_vocab),
        "layers": layers,
        "final_norm": get("model.norm.weight"),
    }
    if not cfg.tie_embeddings:
        name = ("lm_head.weight" if "lm_head.weight" in idx.names()
                else "model.embed_tokens.weight")
        params["lm_head"] = get(name, rows_vocab).T.contiguous()
    idx.close()
    return cfg, params


def save_pretrained(model_dir: str, cfg: llama.LlamaConfig, params) -> None:
    """Write the stacked parameter dict back out in HF layout
    (config.json + model.safetensors): Linear weights as ``[out, in]``,
    the attention projections with their head dims joined."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg), f, indent=1)
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dim
    lp = params["layers"]
    flat = {"model.embed_tokens.weight": params["embed"],
            "model.norm.weight": params["final_norm"]}
    if not cfg.tie_embeddings:
        flat["lm_head.weight"] = params["lm_head"].T
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        flat[p + "input_layernorm.weight"] = lp["attn_norm"][i]
        flat[p + "post_attention_layernorm.weight"] = lp["mlp_norm"][i]
        flat[p + "self_attn.q_proj.weight"] = lp["wq"][i].reshape(d, h * hd).T
        flat[p + "self_attn.k_proj.weight"] = lp["wk"][i].reshape(d, kv * hd).T
        flat[p + "self_attn.v_proj.weight"] = lp["wv"][i].reshape(d, kv * hd).T
        flat[p + "self_attn.o_proj.weight"] = lp["wo"][i].reshape(h * hd, d).T
        if cfg.n_experts:
            flat[p + "block_sparse_moe.gate.weight"] = lp["moe_router"][i].T
            for e in range(cfg.n_experts):
                ep = p + f"block_sparse_moe.experts.{e}."
                flat[ep + "w1.weight"] = lp["w_gate"][i, e].T
                flat[ep + "w3.weight"] = lp["w_up"][i, e].T
                flat[ep + "w2.weight"] = lp["w_down"][i, e].T
        else:
            flat[p + "mlp.gate_proj.weight"] = lp["w_gate"][i].T
            flat[p + "mlp.up_proj.weight"] = lp["w_up"][i].T
            flat[p + "mlp.down_proj.weight"] = lp["w_down"][i].T
    save_file(flat, os.path.join(model_dir, "model.safetensors"))


@dataclasses.dataclass(frozen=True)
class CheckpointParams:
    """A parameter source for ``LLMEngine`` (``serving.llm.
    local_params``): each rank loads its own shard of the checkpoint."""

    model_dir: str
    dtype: Any = torch.bfloat16

    def __call__(self, cfg, mesh, device):
        return load_params(self.model_dir, cfg, dtype=self.dtype,
                           device=device, mesh=mesh)[1]


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

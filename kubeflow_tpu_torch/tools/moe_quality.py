"""How far the served MoE decode path's logits are from the full-sequence
forward's: Mixtral-8x7B's published widths, cut to ``--layers`` of its 32
layers (random bf16 weights from a seeded generator), on the card, as
``chip_smoke.py``'s phase 5m (c) checks it.

    python -m kubeflow_tpu_torch.tools.moe_quality [--layers 16]
        [--dtype bfloat16|float32] [--expert E] [--tensor T]

An engine at phase 5m's geometry (max_batch 8, max_seq 1024, block 64)
free-runs greedy on one seeded 100-token prompt for 32 tokens; that
stream then runs teacher-forced through the serving path (the prompt
through chunked prefill, the generated tokens through decode steps with
the paged kernel, dropless routing: ``served_logits``) and through
``llama.forward`` over the whole sequence on the capacity path, whose
capacity equals the token count, so no choice drops and it computes the
same function through other code (dense attention, the einsum
dispatch). The forward runs twice: free, and with every
(position, layer) routed to the experts the decode path chose. In bf16
the two paths round differently, and a near tie at the k-th expert sends
a token elsewhere on one side; with random weights such a flip changes
that token's FFN output wholesale and spreads through attention to the
later positions, so the free comparison measures near ties more than
arithmetic. The forced one holds the arithmetic (a wrong gate, a wrong
expert product, a wrong mask) with the routing held equal. Prints, over
the generated positions, the rms of the logit difference divided by the
rms of the forward's logits (forced: the check; free: beside it), the
largest forced difference, the greedy agreement and how many (position,
layer) routing decisions (top-k expert sets) differ between the free
paths, then one JSON line with them and the card's name and power limit.
A copy of the tree with a fault planted in one path reads what the
smoke's limit would see.

With ``--tensor T`` and/or ``--expert E`` it reads instead how far the
same model served under ``KFT_MESH=expert=E,tensor=T`` (each rank its
E/expert experts and its ``mlp`` slice of each, the MoE output summed
over the whole mesh; ranks on cards of their own over NCCL where the
machine has E x T, else all on card 0 over gloo) is from the one-card
engine, as ``chip_smoke.py``'s phases 5n (``tensor=2``) and 5e
(``expert=2,tensor=2``) check it and ``tools/tp_quality.py`` does for
llama3_8b: a one-card engine free-runs greedy on two seeded prompts of
16 tokens for 32, both engines replay those streams teacher-forced
through their decode paths (``LLMEngine.teacher_forced_logits``: the
same method on both, whose first step routes no expert on either), and
it prints the greedy agreement and the max and rms logit error over the
generated positions (``tp_quality.logit_errors``). With ``--expert``
it then reads the same with a planted fault (``TensorOnlyMoE``: the MoE
output summed over ``tensor`` only, so each rank loses the other expert
groups' experts), what the smokes' limit must sit below.

``MIXTRAL_8X7B`` (the published ``config.json``), ``mixtral_8x7b``,
``readings`` and ``tp_readings`` (the checks' methods) are what
``chip_smoke.py`` uses.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
from contextlib import contextmanager

import torch

from kubeflow_tpu_torch.models import hf_llama, llama
from kubeflow_tpu_torch.parallel import moe
from kubeflow_tpu_torch.parallel.mesh import TensorMesh

# mistralai/Mixtral-8x7B-v0.1, config.json as published
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"],
    "model_type": "mixtral",
    "bos_token_id": 1,
    "eos_token_id": 2,
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "num_local_experts": 8,
    "num_experts_per_tok": 2,
    "vocab_size": 32000,
    "rope_theta": 1e6,
    "rms_norm_eps": 1e-5,
    "max_position_embeddings": 32768,
    "tie_word_embeddings": False,
    "hidden_act": "silu",
    "torch_dtype": "bfloat16",
}
SERVE_LAYERS = 16              # the card holds 16 of the 32 in bf16
SEED = 0
PROMPT_LEN, GEN = 100, 32
ENGINE_KW = dict(max_batch=8, max_seq=1024, kv_block_size=64,
                 decode_chunk=8)


def mixtral_8x7b(n_layers: int = SERVE_LAYERS) -> llama.LlamaConfig:
    """The published config through ``config_from_hf``, cut to
    ``n_layers``, served dropless in bf16."""
    return hf_llama.config_from_hf(MIXTRAL_8X7B, n_layers=n_layers,
                                   moe_capacity_factor=0.0,
                                   dtype=torch.bfloat16)


@contextmanager
def recorded_routing():
    """Record every ``moe.top_k`` call's indices (a list, in call order)
    while the block runs."""
    calls: list = []
    inner = moe.top_k

    def recording(probs, k):
        vals, idx = inner(probs, k)
        calls.append(idx)
        return vals, idx

    moe.top_k = recording
    try:
        yield calls
    finally:
        moe.top_k = inner


@contextmanager
def forced_routing(idx: torch.Tensor):
    """Route every ``moe.top_k`` call while the block runs to the experts
    of ``idx`` [tokens, layers, k], one layer per call in order: the
    chosen probabilities are the caller's own at those experts."""
    inner = moe.top_k
    layers = iter(idx.unbind(1))

    def forced(probs, k):
        i = next(layers).reshape(*probs.shape[:-1], k)
        return probs.gather(-1, i), i

    moe.top_k = forced
    try:
        yield
    finally:
        moe.top_k = inner


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    err = (a - b).double()
    return (err.pow(2).mean().sqrt()
            / b.double().pow(2).mean().sqrt()).item()


def served_logits(eng, prompt: list, generated: list):
    """float32 [len(generated), V] logits of ``eng``'s serving path for a
    stream, row j predicting ``generated[j]``: the prompt through chunked
    prefill into a fresh pool of the engine's block size, then every
    generated token but the last through a decode step (the engine's
    kernel). A decode step from position 0 would not do: it takes a
    length-0 slot for an idle one, whose row does not route."""
    from kubeflow_tpu_torch.serving.paged_kv import (
        PagedKV, _lm_head, blocks_for, paged_decode_step,
        paged_prefill_chunk,
    )

    cfg, bs, dev = eng.cfg, eng.paged.block_size, eng.device
    nb = blocks_for(len(prompt) + len(generated), bs)
    pk = PagedKV(cfg=cfg, max_batch=1, max_seq=nb * bs, block_size=bs,
                 num_blocks=nb + 1, prefix_cache=False, device=dev)
    pk.reserve(0, len(prompt), len(generated))
    tables = torch.tensor(pk.tables, device=dev)

    def ids(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    with torch.no_grad():
        x_last, cache = paged_prefill_chunk(
            eng.params, ids([prompt]), cfg, pk.cache, tables, 0, 0,
            len(prompt))
        rows = [_lm_head(eng.params, x_last, cfg)]
        cache["len"][0] = len(prompt)
        for tok in generated[:-1]:
            logits, cache = paged_decode_step(eng.params, ids([tok]), cfg,
                                              cache, tables,
                                              kernel=eng.kernel)
            rows.append(logits)
    return torch.cat(rows).float()


def readings(eng, prompt: list, generated: list) -> dict:
    """The check on ``eng`` for one stream (``prompt`` + ``generated``):
    the serving path's logits (``served_logits``) against
    ``llama.forward`` on the capacity path with capacity = the token
    count (no drops), free and with the serving path's routing, over the
    rows that predict the generated tokens."""
    from kubeflow_tpu_torch.serving.llm import greedy_argmax

    cfg, lo = eng.cfg, len(prompt) - 1
    stream = prompt + generated[:-1]          # the tokens both paths read
    with recorded_routing() as calls:
        served = served_logits(eng, prompt, generated)
    # prefill: one call per layer of [P, k]; decode: one per (position,
    # layer) of [1, k] -> [tokens, layers, k]
    pre = torch.stack(calls[:cfg.n_layers]).permute(1, 0, 2)
    dec = torch.stack(calls[cfg.n_layers:]).reshape(
        -1, cfg.n_layers, cfg.moe_top_k)
    idx = torch.cat([pre, dec])
    full_cfg = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.n_experts / cfg.moe_top_k)
    tokens = torch.tensor([stream], device=eng.device)
    with torch.no_grad():
        with recorded_routing() as calls:
            free = llama.forward(eng.params, tokens, full_cfg)[0, lo:]
        with forced_routing(idx):
            forced = llama.forward(eng.params, tokens, full_cfg)[0, lo:]
    flips = int((idx.sort(-1).values
                 != torch.stack(calls).permute(1, 0, 2).sort(-1).values)
                .any(-1).sum())
    return {
        "positions": served.shape[0],
        "rms_over_rms": _rel_rms(served, forced.float()),
        "free_rms_over_rms": _rel_rms(served, free.float()),
        "max_logit_diff": (served - forced.float()).abs().max().item(),
        "greedy_agreement": (greedy_argmax(served) == greedy_argmax(free))
        .float().mean().item(),
        "routing_decisions": idx.shape[0] * cfg.n_layers,
        "routing_flips": flips,
    }


def tp_readings(eng, streams: list, base) -> dict:
    """The tensor-parallel check on ``eng`` (an engine under a mesh):
    its teacher-forced logits of ``streams`` against ``base``, the
    one-card engine's of the same streams (``tp_quality.logit_errors``)."""
    from kubeflow_tpu_torch.tools.tp_quality import logit_errors

    return logit_errors(base, eng.teacher_forced_logits(streams).cpu())


class TensorOnlyMoE(TensorMesh):
    """A planted fault for the ``--expert`` reading: the MoE output's sum
    (``rows``, the whole mesh) taken over ``tensor`` only, so each rank
    keeps its own expert group's experts alone."""

    def all_reduce(self, x, axis="mesh", kind=None, op="sum"):
        return super().all_reduce(x, "tensor" if axis == "rows" else axis,
                                  kind, op)


def mesh_readings(cfg, source, mesh, streams, base) -> dict:
    """``tp_readings`` of an engine of ``cfg`` from ``source`` launched
    on ``mesh``, closed after."""
    from kubeflow_tpu_torch.serving.llm import LLMEngine
    from kubeflow_tpu_torch.tools.tp_quality import TP_KW

    eng = LLMEngine(source, cfg, mesh=mesh, **TP_KW)
    try:
        return tp_readings(eng, streams, base)
    finally:
        eng.close()


def _mesh_main(cfg, source, ep: int, tp: int, card: str) -> int:
    from kubeflow_tpu_torch.parallel.mesh import mesh_from_topology_env
    from kubeflow_tpu_torch.serving.llm import LLMEngine
    from kubeflow_tpu_torch.tools.tp_quality import (
        reference_streams, tp_devices,
    )

    one = LLMEngine(source, cfg, device="cuda", **ENGINE_KW)
    streams = reference_streams(one, cfg.vocab_size)
    base = one.teacher_forced_logits(streams).cpu()
    del one
    torch.cuda.empty_cache()
    devices = tp_devices(ep * tp)
    mesh = mesh_from_topology_env(
        {"KFT_MESH": f"expert={ep},tensor={tp}"}, devices=devices)
    runs = {"sound": mesh}
    if ep > 1:
        runs["fault"] = TensorOnlyMoE(tp, devices, expert=ep)
    what = f"expert={ep},tensor={tp}"
    out = {"card": card, "layers": cfg.n_layers, "expert": ep,
           "tensor": tp, "backend": mesh.backend}
    for name, m in runs.items():
        res = mesh_readings(cfg, source, m, streams, base)
        torch.cuda.empty_cache()
        print(f"Mixtral-8x7B widths, {cfg.n_layers} layers, {what} "
              f"({mesh.backend}, {[str(d) for d in mesh.devices]}) vs one "
              f"card, {name}: positions {res['positions']}, greedy-token "
              f"agreement {res['greedy_token_agreement']!r}, max logit "
              f"drift {res['max_logit_drift']!r}, rms logit error "
              f"{res['rms_logit_error']!r}", flush=True)
        out[name] = res
    if ep == 1:
        out.update(out.pop("sound"))
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=SERVE_LAYERS)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="weights and compute (float32: the paths' "
                         "arithmetic without bf16 rounding)")
    ap.add_argument("--tensor", type=int, default=1,
                    help="T > 1: the check over a serving mesh (module "
                         "docstring)")
    ap.add_argument("--expert", type=int, default=1,
                    help="E > 1: the check over a serving mesh, with the "
                         "planted fault's reading (module docstring)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moe_quality needs a CUDA GPU")
    dtype = getattr(torch, args.dtype)
    cfg = dataclasses.replace(mixtral_8x7b(args.layers), dtype=dtype)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.tensor * args.expert > 1:
        return _mesh_main(cfg, llama.SeededParams(SEED, dtype),
                          args.expert, args.tensor, card)
    eng = LLMEngine(llama.SeededParams(SEED, dtype), cfg, device="cuda",
                    **ENGINE_KW)
    rng = torch.Generator().manual_seed(7)
    prompt = torch.randint(1, cfg.vocab_size, (PROMPT_LEN,),
                           generator=rng).tolist()
    [req] = eng.generate([prompt], SamplingParams(max_tokens=GEN))
    res = readings(eng, prompt, req.generated)
    print(f"Mixtral-8x7B widths, {args.layers} layers, {args.dtype}, "
          f"decode path vs full forward: rms/rms with the decode path's "
          f"routing {res['rms_over_rms']!r}, free "
          f"{res['free_rms_over_rms']!r}; max logit difference (forced) "
          f"{res['max_logit_diff']!r}, greedy agreement (free) "
          f"{res['greedy_agreement']!r}, routing decisions differing "
          f"{res['routing_flips']} of {res['routing_decisions']}",
          flush=True)
    print(json.dumps({"card": card, "layers": args.layers,
                      "dtype": args.dtype, **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the quality of quantized serving goes: the JAX package's
teacher-forced quality gate (``bench.py`` ``_quant_teacher_forced``) per
quantization surface, on llama3_8b at its published widths (random bf16
weights from a seeded generator; ``--layers`` cuts the depth), on the
card.

    python -m kubeflow_tpu_torch.tools.quant_quality [--layers N]
        [--prompts P]

The bf16 model free-runs greedy through ``paged_decode_step`` (the paged
kernel path) on seeded prompts of 16 tokens and 32 generated; each
replay runs that realized stream teacher-forced: int8 weights alone,
int8 KV alone, fp8 KV alone, int8 KV + int8 weights, fp8 KV + int8
weights, and the same bf16 weights in f32 compute (bf16's own distance
from f32). Prints, per replay, the greedy-token agreement, the max and
the rms logit error over the generated positions, then one JSON line
with them and the card's name and power limit. With the defaults it
runs ``chip_smoke.py``'s full-width gate configuration, so a copy of the
tree with a fault planted in the quantized path reads what the smoke's
limits would see.

``teacher_forced`` is the gate's method; ``chip_smoke.py`` runs it too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.serving.llm import greedy_argmax
from kubeflow_tpu_torch.serving.paged_kv import (
    blocks_for, init_paged_cache, paged_decode_step,
)
from kubeflow_tpu_torch.serving.quant import quantize_weights

BLOCK_SIZE = 16                 # the JAX gate's KV block
PROMPT_LEN, GEN = 16, 32        # chip_smoke.py's full-width gate


def _device(params) -> torch.device:
    leaf = next(iter(params.values()))
    return _device(leaf) if isinstance(leaf, dict) else leaf.device


def stream_logits(cfg, params, quant_kv: str, stream, n_steps: int,
                  greedy: bool, kernel: str):
    """One slot through ``paged_decode_step`` over a fresh pool on the
    parameters' device, one token per step: feeds ``stream`` and, when
    ``greedy``, extends it with its own greedy picks. Returns (tokens,
    f32 logits [n_steps, V])."""
    device = _device(params)
    nbp = blocks_for(n_steps + 1, BLOCK_SIZE)
    cache = init_paged_cache(cfg, 1, nbp * BLOCK_SIZE, BLOCK_SIZE, nbp + 1,
                             device=device, quant_kv=quant_kv)
    tables = torch.arange(1, nbp + 1, dtype=torch.int32,
                          device=device)[None]
    toks = list(stream)
    rows = []
    with torch.no_grad():
        for i in range(n_steps):
            logits, cache = paged_decode_step(
                params, torch.tensor([toks[i]], dtype=torch.int32,
                                     device=device),
                cfg, cache, tables, kernel=kernel)
            rows.append(logits[0])
            if greedy and i + 1 >= len(toks):
                toks.append(int(greedy_argmax(logits[0])))
    return toks, torch.stack(rows).float()


def teacher_forced(cfg, params, replays: dict, n_prompts: int,
                   prompt_len: int, gen: int, kernel: str) -> dict:
    """The gate's method: ``params`` (unquantized) free-runs greedy on
    prompts drawn from seed 7; each replay ``name -> (cfg, params,
    quant_kv)`` replays that realized stream teacher-forced. Returns
    {name: {positions, greedy_token_agreement, max_logit_drift,
    rms_logit_error}} over the generated positions (position t's logits
    predict token t + 1)."""
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (prompt_len,),
                             generator=rng).tolist()
               for _ in range(n_prompts)]
    n_steps = prompt_len + gen
    lo = prompt_len - 1
    base = [stream_logits(cfg, params, "none", p, n_steps, True, kernel)
            for p in prompts]
    out = {}
    for name, (rcfg, rparams, kv) in replays.items():
        agree = total = 0
        drift = sq = 0.0
        for stream, lb in base:
            _, lq = stream_logits(rcfg, rparams, kv, stream, n_steps, False,
                                  kernel)
            err = lb[lo:] - lq[lo:]
            agree += int((greedy_argmax(lb[lo:])
                          == greedy_argmax(lq[lo:])).sum())
            total += n_steps - lo
            drift = max(drift, err.abs().max().item())
            sq += err.double().pow(2).sum().item()
        out[name] = {"positions": total,
                     "greedy_token_agreement": agree / total,
                     "max_logit_drift": drift,
                     "rms_logit_error": (sq / (total * lb.shape[1])) ** 0.5}
    return out


def float32_copy(params):
    return {k: float32_copy(v) if isinstance(v, dict) else v.float()
            for k, v in params.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of llama3_8b to keep (published: 32)")
    ap.add_argument("--prompts", type=int, default=2)
    args = ap.parse_args(argv)
    cfg = llama.llama3_8b(n_layers=args.layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    qparams = quantize_weights(params, cfg)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    replays = {
        "int8 weights": (cfg, qparams, "none"),
        "int8 KV": (cfg, params, "int8"),
        "fp8 KV": (cfg, params, "fp8_e4m3"),
        "int8 KV + int8 weights": (cfg, qparams, "int8"),
        "fp8 KV + int8 weights": (cfg, qparams, "fp8_e4m3"),
        "bf16 weights, f32 compute": (cfg32, float32_copy(params), "none"),
    }
    res = teacher_forced(cfg, params, replays, args.prompts, PROMPT_LEN, GEN,
                         "auto")
    for name, r in res.items():
        print(f"{name} vs bf16: positions {r['positions']}, greedy-token "
              f"agreement {r['greedy_token_agreement']!r}, max logit drift "
              f"{r['max_logit_drift']!r}, rms logit error "
              f"{r['rms_logit_error']!r}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "layers": args.layers,
                      "prompts": args.prompts, "replays": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""How far tensor-parallel serving's logits are from the one-card
engine's: llama3_8b at its published widths (random weights from a
seeded generator) on the card, at tensor=4 as ``chip_smoke.py`` runs it.

    python -m kubeflow_tpu_torch.tools.tp_quality [--quant int8] [--layers 32]

A one-card bf16 engine free-runs greedy on seeded prompts of 16 tokens
and 32 generated; a one-card engine and a tensor-parallel engine over 4
ranks (one card each where the machine has that many, else all on card
0, talking over gloo), both with ``--quant``'s weights and KV,
then run those streams teacher-forced through their decode paths
(``LLMEngine.teacher_forced_logits``). Prints the greedy-token
agreement, the max and the rms logit error over the generated positions,
then one JSON line with them and the card's name and power limit. With
the defaults (llama3_8b cut to 16 of its 32 layers, drawn from the seed
at that depth) it is ``chip_smoke.py``'s phase 4tp check, so a copy of
the tree with a fault planted in the sharded path reads what the
smoke's limit would see.

``reference_streams`` and ``logit_errors`` are the check's method;
``chip_smoke.py`` runs them too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.parallel import TensorMesh
from kubeflow_tpu_torch.serving.llm import (
    LLMEngine, SamplingParams, greedy_argmax,
)
from kubeflow_tpu_torch.serving.scheduler import QuantConfig

PROMPT_LEN, GEN = 16, 32
N_PROMPTS = 2
SEED = 0                       # chip_smoke.py's llama3_8b weights
TP = 4                         # chip_smoke.py's tensor size
# both engines' geometry: phase 4's serving engine (KV block 64) for the
# tensor-parallel one, the same block size for the one-card reference
REF_KW = dict(max_batch=N_PROMPTS, max_seq=1024)
TP_KW = dict(max_batch=8, max_seq=1024)


def reference_streams(engine, vocab: int, n_prompts: int = N_PROMPTS,
                      prompt_len: int = PROMPT_LEN, gen: int = GEN):
    """Prompts from seed 7 plus ``engine``'s greedy continuation: the
    token streams both engines replay (prompt + generated)."""
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, vocab, (prompt_len,), generator=rng).tolist()
               for _ in range(n_prompts)]
    reqs = engine.generate(prompts, SamplingParams(max_tokens=gen))
    return [r.prompt + r.generated for r in reqs]


def logit_errors(base, other, lo: int = PROMPT_LEN - 1) -> dict:
    """Per-position comparison of two engines' teacher-forced logits
    ([S, n, V], ``LLMEngine.teacher_forced_logits``) over the generated
    positions (rows ``lo``.. predict the generated tokens): greedy
    agreement, max and rms absolute logit error."""
    agree = total = 0
    drift = sq = 0.0
    for lb, lo_other in zip(base, other):
        a, b = lb[lo:].float(), lo_other[lo:].float().to(lb.device)
        agree += int((greedy_argmax(a) == greedy_argmax(b)).sum())
        total += a.shape[0]
        err = a - b
        drift = max(drift, err.abs().max().item())
        sq += err.double().pow(2).sum().item()
    return {"positions": total, "greedy_token_agreement": agree / total,
            "max_logit_drift": drift,
            "rms_logit_error": (sq / (total * base[0].shape[1])) ** 0.5}


def tp_devices(tp: int) -> list[str]:
    """One card per rank where there are enough, else all on card 0."""
    n = torch.cuda.device_count()
    return ([f"cuda:{i}" for i in range(tp)] if n >= tp
            else ["cuda:0"] * tp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant", choices=("none", "int8"), default="none",
                    help="int8: int8 KV + int8 weights on both engines")
    ap.add_argument("--layers", type=int, default=16,
                    help="llama3_8b's depth (32: uncut; the default is "
                         "chip_smoke.py's phase 4tp)")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=args.layers)
    quant = (QuantConfig(kv_dtype="int8", weight_dtype="int8")
             if args.quant == "int8" else None)
    source = llama.SeededParams(SEED, torch.bfloat16)
    one = LLMEngine(source, cfg, device="cuda", **REF_KW)
    streams = reference_streams(one, cfg.vocab_size)     # bf16's, always
    if quant is not None:
        del one
        one = LLMEngine(source, cfg, device="cuda", quant=quant, **REF_KW)
    base = one.teacher_forced_logits(streams).cpu()
    del one
    torch.cuda.empty_cache()
    mesh = TensorMesh(TP, tp_devices(TP))
    eng = LLMEngine(source, cfg, mesh=mesh, quant=quant, **TP_KW)
    try:
        other = eng.teacher_forced_logits(streams).cpu()
    finally:
        eng.close()
    res = logit_errors(base, other)
    print(f"tensor={TP} ({mesh.backend}, {[str(d) for d in mesh.devices]}"
          f") vs one card, quant {args.quant}: "
          f"positions {res['positions']}, greedy-token agreement "
          f"{res['greedy_token_agreement']!r}, max logit drift "
          f"{res['max_logit_drift']!r}, rms logit error "
          f"{res['rms_logit_error']!r}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "tp": TP, "layers": cfg.n_layers,
                      "backend": mesh.backend, "quant": args.quant,
                      **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

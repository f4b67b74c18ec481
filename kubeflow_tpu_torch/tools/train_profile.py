"""Where a training step's time goes on the card: llama_1b at full width
(random f32 weights from a seeded CUDA generator) as ``chip_smoke.py``
trains it -- remat="dots", attn_impl="pallas", adafactor, global batch
32 x 2048, grad_accum 16 -- one ``Trainer.train_step`` at a time.

    python -m kubeflow_tpu_torch.tools.train_profile [--graph] [--moe]

``--moe`` takes ``chip_smoke.py``'s phase 7m model instead
(``model_config``): ``llama_1b`` with 8 experts (top-2, capacity 1.25),
cut to 8 of its 16 layers.

Runs one warm-up step, times two steps on the host clock (ending in a
synchronize), then profiles one more under ``torch.profiler`` and prints:

- host ms per unprofiled step, and the profiled step's own host ms;
  tokens/s and MFU (``flops_per_token(2048)`` over 989 TFLOP/s bf16)
  from the unprofiled steps;
- device busy ms: the union of the CUDA kernel intervals of the profiled
  step (beside the plain sum of kernel times, which exceeds the union
  only where kernels overlap);
- the device's idle share in two readings, neither clamped, so a
  miscount shows as a negative share:
  ``1 - busy / profiled step's host ms`` (one window; the profiler's own
  host cost lengthens that step) and ``1 - busy / unprofiled host ms per
  step`` (assumes the profiled step's device work is any step's);
- device activities per step, and the CUDA API calls that put work on
  the device (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
  ``cudaGraphLaunch``, ...) per step, by name;
- peak device memory over the timed steps (allocated, and reserved,
  which holds a captured graph's pool);
- the top kernels by device time, and each flash kernel's device ms per
  launch beside its bound at this shape (the larger of its FLOPs over
  989 TFLOP/s bf16 and its bytes over 3.35 TB/s).

``--graph`` then ``precompile``s the same trainer (its step captured as
CUDA graphs, ``training/step_graph.py``), prints the capture's seconds
and pool bytes, and takes the same readings of the replayed step: the
eager row and the replayed row of one run. Then one JSON line with those
numbers and the card's name and power limit. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import Counter

import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.ops.flash_attention import kernel_work
from kubeflow_tpu_torch.tools.decode_profile import LAUNCH_CALLS
from kubeflow_tpu_torch.training import (
    Trainer, TrainerConfig, lm_loss_fn, synthetic_lm_batches,
)

BATCH, SEQ, GRAD_ACCUM = 32, 2048, 16      # chip_smoke.py's training cell
MOE_LAYERS = 8                 # phase 7m's cut: 8 of llama_1b's 16 layers
TIMED_STEPS = 2
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# device kernel name (substring) of each flash kernel
FLASH_KERNELS = {"flash_attention_fwd": "flash_fwd_kernel",
                 "flash_attention_dq": "flash_dq_kernel",
                 "flash_attention_dkv": "flash_dkv_kernel"}


def flash_bound_ms(cfg, micro: int, seq: int) -> dict:
    """Per-launch bound of each flash kernel on one bf16 micro batch: the
    larger of its FLOPs over the bf16 peak and its bytes over HBM
    (``flash_attention.kernel_work``)."""
    work = kernel_work(micro, seq, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, causal=True)
    return {k: max(f / BF16_FLOPS, b / HBM_BYTES_PER_S) * 1e3
            for k, (f, b) in work.items()}


def busy_us(kernels) -> float:
    """Microseconds during which at least one of ``kernels`` ran."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def step_readings(cfg, step) -> dict:
    """The readings of the module docstring for ``step()`` (one training
    step returning its loss as a float): one warm-up step, two timed,
    one profiled."""
    from torch.profiler import ProfilerActivity, profile

    losses = [step()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += [step() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    peak = {"peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernels = [e for e in events if e.device_type == cuda]
    api = Counter(e.name for e in events
                  if e.device_type != cuda and e.name in LAUNCH_CALLS)
    busy_ms = busy_us(kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    bounds = flash_bound_ms(cfg, BATCH // GRAD_ACCUM, SEQ)
    flash = {}
    for name, device_name in FLASH_KERNELS.items():
        ev = [e for e in kernels if device_name in e.name]
        total = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        flash[name] = {"launches": len(ev), "device_ms": total,
                       "ms_per_launch": total / len(ev) if ev else None,
                       "bound_ms": bounds[name]}
    tok_s = BATCH * SEQ / (wall_ms / 1e3)
    return {"wall_ms_per_step": wall_ms, "profiled_wall_ms": prof_wall_ms,
            "tokens_per_s": tok_s,
            "mfu": tok_s * cfg.flops_per_token(SEQ) / BF16_FLOPS,
            "device_busy_ms": busy_ms,
            "kernel_ms_sum": sum(by_name.values()) / 1e3,
            "device_idle_share_profiled_step": 1.0 - busy_ms / prof_wall_ms,
            "device_idle_share_vs_unprofiled": 1.0 - busy_ms / wall_ms,
            "device_activities_per_step": len(kernels),
            "api_launches_per_step": sum(api.values()),
            "api_launches_by_name_per_step": dict(sorted(api.items())),
            **peak, "losses": losses, "flash": flash,
            "top_kernels_ms": {n[:90]: t / 1e3 for n, t in top}}


def report(name: str, r: dict) -> None:
    print(f"{name}: {r['wall_ms_per_step']!r} ms/step wall ({TIMED_STEPS} "
          f"unprofiled steps), {r['tokens_per_s']!r} tok/s, MFU "
          f"{r['mfu']!r}; profiled step {r['profiled_wall_ms']!r} ms wall, "
          f"{r['device_busy_ms']!r} ms device busy (kernel sum "
          f"{r['kernel_ms_sum']!r} ms), {r['device_activities_per_step']} "
          f"device activities; idle share "
          f"{r['device_idle_share_profiled_step']!r} (1 - busy / profiled "
          f"step wall), {r['device_idle_share_vs_unprofiled']!r} (1 - busy "
          f"/ unprofiled step wall); {r['api_launches_per_step']} API "
          f"launches {r['api_launches_by_name_per_step']}; peak memory "
          f"{r['peak_allocated_bytes']} B allocated, "
          f"{r['peak_reserved_bytes']} B reserved", flush=True)
    for kernel, f in r["flash"].items():
        per = f["ms_per_launch"]
        ratio = per / f["bound_ms"] if per else None
        print(f"    {kernel}: {f['launches']} launches, {f['device_ms']!r} "
              f"ms, {per!r} ms per launch against a bound of "
              f"{f['bound_ms']!r} ms ({ratio!r} x)", flush=True)
    for kernel, ms in r["top_kernels_ms"].items():
        print(f"    {ms!r:>24} ms  {kernel}", flush=True)


def model_config(moe: bool = False) -> llama.LlamaConfig:
    """Phase 7's llama_1b, or with ``moe`` phase 7m's: 8 experts at the
    defaults (top-2, capacity 1.25), 8 layers."""
    cfg = llama.llama_1b(remat="dots", attn_impl="pallas")
    if moe:
        cfg = llama.llama_moe_8x(cfg, n_layers=MOE_LAYERS)
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", action="store_true",
                    help="also precompile the step and profile its replay")
    ap.add_argument("--moe", action="store_true",
                    help="llama_1b with 8 experts, 8 layers (phase 7m)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_profile needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model_config(args.moe)
    trainer = Trainer(
        lambda g: llama.init_params(g, cfg, device="cuda"),
        lm_loss_fn(llama.forward, cfg),
        TrainerConfig(learning_rate=3e-4, warmup_steps=10, total_steps=1000,
                      grad_accum=GRAD_ACCUM, optimizer="adafactor"),
        device="cuda")
    trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    batches = synthetic_lm_batches(cfg.vocab_size, BATCH, SEQ)

    def step():
        return float(trainer.train_step(next(batches))["loss"])

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "batch": BATCH, "seq": SEQ,
           "grad_accum": GRAD_ACCUM, "moe": args.moe,
           "eager": step_readings(cfg, step)}
    report(f"{card}, eager", out["eager"])
    if args.graph:
        torch.cuda.synchronize()
        outcome = trainer.precompile(next(batches))
        g = trainer.step_graph
        out["precompile"] = {"outcome": outcome,
                             "capture_seconds": g.capture_seconds,
                             "pool_bytes": g.pool_bytes,
                             "launches_per_step": g.launches}
        print(f"precompile() -> {outcome!r}: capture {g.capture_seconds!r} "
              f"s, graph pool {g.pool_bytes} B, kernel launches a "
              f"replayed step {g.launches}", flush=True)
        out["replay"] = step_readings(cfg, step)
        out["replay"]["replays"] = g.replays
        report(f"{card}, replay", out["replay"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

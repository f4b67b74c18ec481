"""Where a training step's time goes on the card: llama_1b at full width
(random f32 weights from a seeded CUDA generator) as ``chip_smoke.py``
trains it -- remat="dots", attn_impl="pallas", adafactor, global batch
32 x 2048, grad_accum 16 -- one ``Trainer.train_step`` at a time.

    python -m kubeflow_tpu_torch.tools.train_profile

Runs one warm-up step, times two steps on the host clock (ending in a
synchronize), then profiles one more under ``torch.profiler`` and prints:

- host ms per unprofiled step, and the profiled step's own host ms;
- device busy ms: the union of the CUDA kernel intervals of the profiled
  step (beside the plain sum of kernel times, which exceeds the union
  only where kernels overlap);
- the device's idle share in two readings, neither clamped, so a
  miscount shows as a negative share:
  ``1 - busy / profiled step's host ms`` (one window; the profiler's own
  host cost lengthens that step) and ``1 - busy / unprofiled host ms per
  step`` (assumes the profiled step's device work is any step's);
- kernel launches per step, the top kernels by device time, and each
  flash kernel's device ms per launch beside its bound at this shape (the
  larger of its FLOPs over 989 TFLOP/s bf16 and its bytes over 3.35 TB/s);

then one JSON line with those numbers and the card's name and power
limit. Needs one CUDA GPU.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.ops.flash_attention import kernel_work
from kubeflow_tpu_torch.training import (
    Trainer, TrainerConfig, lm_loss_fn, synthetic_lm_batches,
)

BATCH, SEQ, GRAD_ACCUM = 32, 2048, 16      # chip_smoke.py's training cell
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("train_profile needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.llama_1b(remat="dots", attn_impl="pallas")
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

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us(kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    kernel_sum_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    bounds = flash_bound_ms(cfg, BATCH // GRAD_ACCUM, SEQ)
    flash = {}
    for name, device_name in FLASH_KERNELS.items():
        ev = [e for e in kernels if device_name in e.name]
        total = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        flash[name] = {"launches": len(ev), "device_ms": total,
                       "ms_per_launch": total / len(ev) if ev else None,
                       "bound_ms": bounds[name]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "batch": BATCH, "seq": SEQ,
           "grad_accum": GRAD_ACCUM, "wall_ms_per_step": wall_ms,
           "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
           "kernel_ms_sum": kernel_sum_ms,
           "device_idle_share_profiled_step": 1.0 - busy_ms / prof_wall_ms,
           "device_idle_share_vs_unprofiled": 1.0 - busy_ms / wall_ms,
           "launches_per_step": len(kernels), "losses": losses,
           "flash": flash,
           "top_kernels_ms": {n[:90]: t / 1e3 for n, t in top}}
    print(f"{card}: {wall_ms!r} ms/step wall ({TIMED_STEPS} unprofiled "
          f"steps); profiled step {prof_wall_ms!r} ms wall, {busy_ms!r} ms "
          f"device busy (kernel sum {kernel_sum_ms!r} ms), "
          f"{len(kernels)} launches; idle share "
          f"{out['device_idle_share_profiled_step']!r} (1 - busy / profiled "
          f"step wall), {out['device_idle_share_vs_unprofiled']!r} (1 - "
          f"busy / unprofiled step wall)", flush=True)
    for name, f in flash.items():
        per = f["ms_per_launch"]
        ratio = per / f["bound_ms"] if per else None
        print(f"    {name}: {f['launches']} launches, {f['device_ms']!r} ms, "
              f"{per!r} ms per launch against a bound of {f['bound_ms']!r} "
              f"ms ({ratio!r} x)", flush=True)
    for name, ms in out["top_kernels_ms"].items():
        print(f"    {ms!r:>24} ms  {name}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

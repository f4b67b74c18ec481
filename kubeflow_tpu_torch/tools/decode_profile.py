"""Where a decode step's time goes on the card: llama3_8b at its published
widths (random bf16 weights from a seeded CUDA generator), eight live
slots at ``--context`` tokens, one ``paged_decode_step`` at a time.

    python -m kubeflow_tpu_torch.tools.decode_profile [--steps N] [--context T]

Prints, for the paged kernel path and for the gather path: host-clock ms
per step (ending in a synchronize), device busy ms per step (the sum of
CUDA kernel times under ``torch.profiler``), the device's idle share,
kernel launches per step, and the device time of the biggest kernels;
for the paged path also the paged kernel's device time per launch beside
its byte bound at this shape (q, out, tables, kv_len and the K/V rows
below kv_len over 3.35 TB/s); then one JSON line with those numbers and
the card's name and power limit. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.serving.paged_kv import (
    PagedKV, paged_decode_step,
)

BATCH = 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PAGED_KERNEL = "paged_decode_kernel"


def live_tables(pk: PagedKV, context: int) -> torch.Tensor:
    """Reserve every slot of ``pk`` for a ``context``-token sequence and
    return the block tables on the pool's device."""
    for s in range(pk.max_batch):
        pk.release(s)
        if pk.reserve(s, context, 32) is None:
            raise RuntimeError("pool too small for the profiled batch")
    return torch.tensor(pk.tables, device=pk.cache["k"].device)


def _steps(params, cfg, cache, tables, kernel, context, n):
    tok = torch.ones((tables.shape[0],), dtype=torch.int32,
                     device=tables.device)
    for _ in range(n):
        cache["len"] = torch.full_like(cache["len"], context)
        paged_decode_step(params, tok, cfg, cache, tables, kernel=kernel)


def paged_kernel_bound_ms(cfg, batch: int, context: int, max_blocks: int,
                          itemsize: int = 2) -> float:
    """Byte bound of one paged-kernel launch in the profiled step: each
    slot attends over context + 1 rows (this step's row included)."""
    rows = batch * (context + 1)
    kv = 2 * rows * cfg.n_kv_heads * cfg.head_dim * itemsize
    q_out = 2 * batch * cfg.n_heads * cfg.head_dim * itemsize
    meta = batch * max_blocks * 4 + batch * 4
    return (kv + q_out + meta) / HBM_BYTES_PER_S * 1e3


def measure(params, cfg, cache, tables, kernel: str, context: int,
            steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    _steps(params, cfg, cache, tables, kernel, context, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _steps(params, cfg, cache, tables, kernel, context, steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _steps(params, cfg, cache, tables, kernel, context, steps)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    paged = [e for e in kernels if PAGED_KERNEL in e.name]
    return {
        "kernel": kernel, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "launches_per_step": len(kernels) / steps,
        "paged_kernel_launches_per_step": len(paged) / steps,
        "paged_kernel_ms_per_launch": (
            sum(e.time_range.elapsed_us() for e in paged) / 1e3 / len(paged)
            if paged else None),
        "top_kernels_ms_per_step": {
            name[:80]: t / 1e3 / steps for name, t in top},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20,
                    help="decode steps timed and profiled per path")
    ap.add_argument("--context", type=int, default=300,
                    help="tokens already resident in every slot")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA GPU")
    cfg = llama.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    pk = PagedKV(cfg=cfg, max_batch=BATCH, max_seq=1024, block_size=64,
                 num_blocks=BATCH * 16 + 1, device="cuda")
    pk.cache["k"].normal_(generator=gen)
    pk.cache["v"].normal_(generator=gen)
    tables = live_tables(pk, args.context)
    bound_ms = paged_kernel_bound_ms(cfg, BATCH, args.context,
                                     tables.shape[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "batch": BATCH, "context": args.context,
           "steps": args.steps, "paged_kernel_bound_ms": bound_ms,
           "paths": []}
    for kernel in ("paged", "gather", "paged"):
        r = measure(params, cfg, pk.cache, tables, kernel, args.context,
                    args.steps)
        out["paths"].append(r)
        print(f"{kernel}: {r['wall_ms_per_step']!r} ms/step wall, "
              f"{r['device_busy_ms_per_step']!r} ms device busy, idle share "
              f"{r['device_idle_share']!r}, "
              f"{r['launches_per_step']!r} launches/step", flush=True)
        per = r["paged_kernel_ms_per_launch"]
        if per is not None:
            print(f"    {PAGED_KERNEL}: {per!r} ms per launch, "
                  f"{r['paged_kernel_launches_per_step']!r} launches/step, "
                  f"byte bound {bound_ms!r} ms per launch "
                  f"({per / bound_ms!r} x the bound)", flush=True)
        for name, ms in r["top_kernels_ms_per_step"].items():
            print(f"    {ms!r:>24} ms  {name}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

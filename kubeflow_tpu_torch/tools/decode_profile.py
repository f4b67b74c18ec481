"""Where a decode step's time goes on the card: llama3_8b at its published
widths (random bf16 weights from a seeded CUDA generator), eight live
slots at ``--context`` tokens, one ``paged_decode_step`` at a time.

    python -m kubeflow_tpu_torch.tools.decode_profile [--steps N] [--context T]
        [--quant kv:int8,w:int8] [--moe]

``--moe`` (in either mode) takes ``chip_smoke.py``'s phase 5m model
instead: Mixtral-8x7B's published widths cut to 16 of 32 layers, served
dropless (``tools/moe_quality.mixtral_8x7b``); the step then reads every
expert's weights.

``--quant`` profiles the quantized decode step: ``kv:`` the pool dtype
(none | int8 | fp8_e4m3), ``w:`` the weight dtype (none | int8); either
part may be left out. The pools then hold random quantized content with
random per-block scales, and the paged path runs the fused-dequant
kernel.

Prints, for the paged kernel path and for the gather path: host-clock ms
per step (ending in a synchronize), device busy ms per step (the sum of
CUDA kernel times under ``torch.profiler``), the device's idle share,
kernel launches per step, and the device time of the biggest kernels;
for the paged path also the paged kernel's device time per call (its
split pass and its combine pass, two device launches) beside its byte
bound at this shape (q, out, tables, kv_len and the K/V rows below
kv_len over 3.35 TB/s); then one JSON line with those numbers and the
card's name and power limit. Needs one CUDA GPU.

    python -m kubeflow_tpu_torch.tools.decode_profile --graph [--dispatches N]
        [--context T] [--quant kv:int8,w:int8]

``--graph`` measures the engine's decode dispatch as served instead: two
``LLMEngine``s on the same weights (max_batch 8, max_seq 1024, block 64,
decode_chunk 8), one eager and one ``precompile``d (its decode program
captured as a CUDA graph), each with eight greedy requests of
``--context``-token prompts decoding, stepped by ``LLMEngine.step()``
(``dispatch_readings``). For each: host-clock ms per decode step over
``--dispatches`` dispatches ending in a synchronize, and from a profiled
dispatch the device busy ms per step, the idle share (against the
unprofiled wall), the CUDA API calls that launch device work per step
(``cudaLaunchKernel`` and ``cudaGraphLaunch``) and the paged kernel's
passes per dispatch; for the
eager engine also where the device's idle time goes (``gap_breakdown``:
each idle gap attributed to the host call that spans it, in ms and as a
share of the idle time; the profiler slows the host, so the profiled
window's own ms per step is printed beside it). Then
``staging_probe``: whether a host-to-device copy of a pageable numpy
array (the engine's ``_dev``) waits for the work queued on the stream,
against a staged pinned copy. One JSON line ends it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import Counter

import numpy as np
import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.serving.paged_kv import (
    PagedKV, paged_decode_step,
)
from kubeflow_tpu_torch.serving.quant import KV_QMAX, quantize_weights
from kubeflow_tpu_torch.serving.scheduler import QuantConfig

BATCH = 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# device kernel names of the paged kernel's two passes; one call of the
# wrapper launches each once
PAGED_KERNEL = "paged_decode_kernel"
PAGED_COMBINE = "paged_decode_combine"
# CUDA API calls that put work on the device: one kernel each, or a graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")


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
        cache["len"].fill_(context)
        paged_decode_step(params, tok, cfg, cache, tables, kernel=kernel)


def weight_bytes(params) -> int:
    """Bytes of a parameter tree: what a decode step that reads every
    weight moves at the least."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def parse_quant(spec: str) -> QuantConfig:
    """``kv:int8,w:int8`` (either part optional, "" for none) ->
    QuantConfig, validated."""
    kw = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        key, _, val = part.partition(":")
        if key not in ("kv", "w"):
            raise ValueError(f"--quant part {part!r}: want kv:<dtype> or "
                             "w:<dtype>")
        kw["kv_dtype" if key == "kv" else "weight_dtype"] = val
    quant = QuantConfig(**kw)
    quant.validate()
    return quant


def paged_kernel_bound_ms(cfg, batch: int, context: int, max_blocks: int,
                          itemsize: int = 2, block_size: int = 64,
                          quantized: bool = False) -> float:
    """Byte bound of one paged-kernel launch in the profiled step: each
    slot attends over context + 1 rows (this step's row included), K/V
    at ``itemsize`` bytes per element (1 for a quantized pool, which adds
    two f32 scale words per live block and KV head); q and out in bf16."""
    rows = batch * (context + 1)
    kv = 2 * rows * cfg.n_kv_heads * cfg.head_dim * itemsize
    q_out = 2 * batch * cfg.n_heads * cfg.head_dim * 2
    meta = batch * max_blocks * 4 + batch * 4
    if quantized:
        live = batch * -(-(context + 1) // block_size)
        meta += live * cfg.n_kv_heads * 2 * 4
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
        key = e.name[:80]       # template names run long; sum by prefix
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    paged = [e for e in kernels if PAGED_KERNEL in e.name]
    both = [e for e in kernels
            if PAGED_KERNEL in e.name or PAGED_COMBINE in e.name]
    return {
        "kernel": kernel, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "launches_per_step": len(kernels) / steps,
        "paged_kernel_launches_per_step": len(paged) / steps,
        "paged_combine_launches_per_step": (len(both) - len(paged)) / steps,
        # both passes' device time over the calls (split-pass launches)
        "paged_kernel_ms_per_launch": (
            sum(e.time_range.elapsed_us() for e in both) / 1e3 / len(paged)
            if paged else None),
        "top_kernels_ms_per_step": {
            name: t / 1e3 / steps for name, t in top},
    }


# ---------------------------------------------------------------------------
# --graph: the engine's decode dispatch, eager against the captured program
# ---------------------------------------------------------------------------

def host_category(name: str) -> str:
    """The class of a host-side profiler event, for ``gap_breakdown``."""
    if name in LAUNCH_CALLS:
        return "cudaGraphLaunch" if name == "cudaGraphLaunch" \
            else "cudaLaunchKernel"
    if name in SYNC_CALLS:
        return "synchronize"
    if name.startswith("cudaMemcpy"):
        return "cudaMemcpyAsync"
    if name.startswith(("cuda", "cu")):
        return "other CUDA API"
    if name.startswith("aten::"):
        return "aten dispatch"
    return "other host op"


def merge_intervals(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def gap_breakdown(device, host) -> dict:
    """Where the device's idle time goes. ``device``: (start, end) of
    every device activity; ``host``: (start, end, name) of the host
    events of the dispatching thread (properly nested, as one thread's
    are), on the same clock. Each idle gap between the first and last
    device activity is split at the host events' edges and each piece
    goes to the innermost host event spanning it (``host_category`` of
    its name), or to "Python between ops" where none does. Returns
    {category: idle time}, in ``device``'s unit, and "gaps": their
    count."""
    busy = merge_intervals(device)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    events = sorted(host, key=lambda e: (e[0], -e[1]))
    out: dict = {}
    stack: list = []
    i = 0
    for g0, g1 in gaps:
        t = g0
        while t < g1:
            while i < len(events) and events[i][0] <= t:
                while stack and stack[-1][1] <= events[i][0]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            nxt = g1
            if i < len(events):
                nxt = min(nxt, events[i][0])
            if stack:
                nxt = min(nxt, stack[-1][1])
            cat = (host_category(stack[-1][2]) if stack
                   else "Python between ops")
            out[cat] = out.get(cat, 0.0) + (nxt - t)
            t = nxt
    out["gaps"] = len(gaps)
    return out


def fill_batch(eng, context: int, max_tokens: int) -> list:
    """Eight (``max_batch``) greedy requests of ``context``-token prompts
    (numpy seed 7) into ``eng``, stepped until every one is decoding."""
    from kubeflow_tpu_torch.serving.llm import SamplingParams

    rng = np.random.default_rng(7)
    reqs = [eng.add_request(
        rng.integers(1, eng.cfg.vocab_size, context).tolist(),
        SamplingParams(max_tokens=max_tokens))
        for _ in range(eng.max_batch)]
    while eng._waiting or eng._chunked or len(eng._active) < eng.max_batch:
        eng.step()
    return reqs


def dispatch_readings(eng, dispatches: int, gaps: bool = False) -> dict:
    """The engine's decode dispatch as served, over a full batch that is
    decoding (``fill_batch``): one warm-up ``eng.step()``, then the host
    clock over ``dispatches`` steps (each dispatches ``decode_chunk``
    device steps and reads the previous chunk back) ending in a
    synchronize, then one step under ``torch.profiler`` from an idle
    device, ending in a synchronize (the profiler's event processing
    grows with the ~16,000-35,000 device activities of an eager
    dispatch). Per decode step: wall ms
    (unprofiled), device busy ms and 1 - busy / wall, the API calls that
    launched device work (by name) and the device activities; per
    dispatch the paged kernel's two passes; with ``gaps`` the eager
    gap breakdown (``gap_breakdown``) in ms per step."""
    from torch.profiler import ProfilerActivity, profile

    chunk = eng.decode_chunk
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(dispatches):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / (dispatches * chunk)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type == cuda]
    host = [e for e in events if e.device_type != cuda]
    steps = chunk
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps
    launches = Counter(e.name for e in host if e.name in LAUNCH_CALLS)
    out = {
        "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall),
        # the profiled window's own clock: the profiler slows the host
        "profiled_wall_ms_per_step": profiled_wall * 1e3 / steps,
        "api_launches_per_step": sum(launches.values()) / steps,
        "api_launches_by_name_per_step": {
            k: v / steps for k, v in sorted(launches.items())},
        "device_activities_per_step": len(device) / steps,
        "paged_kernel_per_dispatch": sum(
            PAGED_KERNEL in e.name for e in device),
        "paged_combine_per_dispatch": sum(
            PAGED_COMBINE in e.name for e in device),
        "sync_calls_per_step": sum(e.name in SYNC_CALLS
                                   for e in host) / steps,
    }
    if gaps:
        # the thread that launched the kernels is the dispatching thread
        thread = Counter(e.thread for e in host
                         if e.name in LAUNCH_CALLS).most_common(1)[0][0]
        spans = [(e.time_range.start, e.time_range.end, e.name)
                 for e in host if e.thread == thread]
        g = gap_breakdown([(e.time_range.start, e.time_range.end)
                           for e in device], spans)
        out["gaps_per_step"] = g.pop("gaps") / steps
        out["gap_ms_per_step"] = {k: v / 1e3 / steps
                                  for k, v in sorted(g.items())}
        idle = sum(g.values())
        out["gap_share"] = {k: v / idle for k, v in sorted(g.items())}
    return out


def staging_probe() -> dict:
    """Host ms of one dispatch's input copy while the stream is still busy
    with ~20 ms of queued work (its measured length is ``spin_ms``):
    ``torch.tensor(numpy, device=cuda)`` (a pageable copy, the engine's
    ``_dev``) against ``DecodeBuffers.stage`` (one pinned asynchronous
    copy). A copy that waits for the stream takes about ``spin_ms``."""
    from kubeflow_tpu_torch.serving.decode_graph import DecodeBuffers

    b, nb = BATCH, 16
    buf = DecodeBuffers(b, nb, 8, torch.device("cuda"))
    host = np.zeros((b, nb), np.int32)
    zeros = np.zeros((b,), np.int32)

    def spin():
        # _sleep spins a count of GPU cycles (~2e6 a ms at the H100's
        # 1.98 GHz); the spin's own length is measured below
        torch.cuda._sleep(int(20 * 2e6))

    out = {}
    for name, copy in (
            ("pageable_copy_host_ms",
             lambda: torch.tensor(host, device="cuda")),
            ("pinned_stage_host_ms",
             lambda: buf.stage(zeros, zeros, zeros, host, zeros, zeros,
                               zeros))):
        copy()
        torch.cuda.synchronize()
        spin()
        t0 = time.perf_counter()
        copy()
        out[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    spin()
    end.record()
    end.synchronize()
    out["spin_ms"] = start.elapsed_time(end)
    return out


def model_config(args) -> llama.LlamaConfig:
    """llama3_8b, or with ``--moe`` phase 5m's Mixtral cut."""
    if args.moe:
        from kubeflow_tpu_torch.tools.moe_quality import mixtral_8x7b

        return mixtral_8x7b()
    return llama.llama3_8b()


def graph_main(args, card: str) -> int:
    """``--graph`` (module docstring)."""
    from kubeflow_tpu_torch.serving.llm import LLMEngine

    cfg = model_config(args)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    if args.quant.weight_dtype == "int8":
        params = quantize_weights(params, cfg)
    kw = dict(max_batch=BATCH, max_seq=1024, kv_block_size=64,
              decode_chunk=8, device="cuda", quant=args.quant)
    out = {"card": card, "batch": BATCH, "context": args.context,
           "dispatches": args.dispatches, "quant": args.quant.tag(),
           "moe": args.moe, "weight_bytes": weight_bytes(params),
           "decode_chunk": kw["decode_chunk"], "engines": {}}
    max_tokens = kw["decode_chunk"] * (args.dispatches + 6)
    for name in ("eager", "graph"):
        eng = LLMEngine(params, cfg, **kw)
        if name == "graph":
            eng.precompile()
            g = eng.decode_graph
            out["capture_seconds"] = g.capture_seconds
            out["graph_pool_bytes"] = g.pool_bytes
            out["graph_launches_per_replay"] = g.launches
        fill_batch(eng, args.context, max_tokens)
        r = dispatch_readings(eng, args.dispatches, gaps=name == "eager")
        out["engines"][name] = r
        print(f"{name}: {r['wall_ms_per_step']!r} ms/step wall, "
              f"{r['device_busy_ms_per_step']!r} ms device busy, idle share "
              f"{r['device_idle_share']!r}, {r['api_launches_per_step']!r} "
              f"API launches/step {r['api_launches_by_name_per_step']}, "
              f"{r['device_activities_per_step']!r} device activities/step, "
              f"paged passes per dispatch {r['paged_kernel_per_dispatch']!r}"
              f" + {r['paged_combine_per_dispatch']!r}, sync calls/step "
              f"{r['sync_calls_per_step']!r}; profiled "
              f"{r['profiled_wall_ms_per_step']!r} ms/step", flush=True)
        if "gap_ms_per_step" in r:
            print(f"    idle gaps per step {r['gaps_per_step']!r} in the "
                  f"profiled window; by the host call spanning them, ms per "
                  f"step {r['gap_ms_per_step']} and share of the idle time "
                  f"{r['gap_share']}", flush=True)
        del eng
        torch.cuda.empty_cache()
    out["staging_probe"] = staging_probe()
    print(f"staging probe: {out['staging_probe']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20,
                    help="decode steps timed and profiled per path")
    ap.add_argument("--context", type=int, default=300,
                    help="tokens already resident in every slot")
    ap.add_argument("--quant", type=parse_quant, default=QuantConfig(),
                    help="quantized step, e.g. kv:int8,w:int8 or "
                         "kv:fp8_e4m3,w:int8 (default: unquantized)")
    ap.add_argument("--graph", action="store_true",
                    help="the engine's decode dispatch, eager against its "
                         "captured CUDA graph")
    ap.add_argument("--dispatches", type=int, default=6,
                    help="--graph: dispatches timed per engine")
    ap.add_argument("--moe", action="store_true",
                    help="Mixtral-8x7B's widths, 16 layers, dropless")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.graph:
        return graph_main(args, card)
    cfg = model_config(args)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    if args.quant.weight_dtype == "int8":
        params = quantize_weights(params, cfg)
    pk = PagedKV(cfg=cfg, max_batch=BATCH, max_seq=1024, block_size=64,
                 num_blocks=BATCH * 16 + 1, device="cuda",
                 quant_kv=args.quant.kv_dtype)
    quantized = "k_scale" in pk.cache
    for name in ("k", "v"):
        vals = torch.randn(pk.cache[name].shape, generator=gen,
                           device="cuda")
        if quantized:
            # random stored values over the dtype's range, scales ~1/qmax
            qmax = KV_QMAX[args.quant.kv_dtype]
            vals = (vals * qmax / 4).clamp_(-qmax, qmax)
            if args.quant.kv_dtype == "int8":
                vals = vals.round_()
            pk.cache[name + "_scale"].uniform_(0.5 / qmax, 2.0 / qmax,
                                               generator=gen)
        pk.cache[name].copy_(vals)
    tables = live_tables(pk, args.context)
    bound_ms = paged_kernel_bound_ms(
        cfg, BATCH, args.context, tables.shape[1],
        itemsize=pk.cache["k"].element_size(), block_size=pk.block_size,
        quantized=quantized)
    out = {"card": card, "batch": BATCH, "context": args.context,
           "steps": args.steps, "quant": args.quant.tag(), "moe": args.moe,
           "weight_bytes": weight_bytes(params),
           "paged_kernel_bound_ms": bound_ms, "paths": []}
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
            print(f"    {PAGED_KERNEL} + {PAGED_COMBINE}: {per!r} ms per "
                  f"call, {r['paged_kernel_launches_per_step']!r} calls/step "
                  f"({r['paged_combine_launches_per_step']!r} combine "
                  f"launches/step), byte bound {bound_ms!r} ms per call "
                  f"({per / bound_ms!r} x the bound)", flush=True)
        for name, ms in r["top_kernels_ms_per_step"].items():
            print(f"    {ms!r:>24} ms  {name}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

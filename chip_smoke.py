#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``kubeflow_tpu_torch``): the quickest
proof that the port still starts, serves and decodes through its own
kernels on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits nonzero; no phase catches its own failure):

1. probe   — card name and power limit, torch/CUDA/nvcc versions, and the
             build of every kernel from csrc/ (one nvcc per source, all
             started together), with its seconds and ptxas report.
2. parity  — each kernel against its plain PyTorch version on the card,
             at the serving shape (B=8, H=32, KV_H=8, D=128, bs=64) with
             ragged kv_len (0, 1, a block crossing, ~1000), bf16 and f32.
3. timing  — CUDA-event median per launch (L2 flushed between launches)
             of the kernel and its plain version, beside the kernel's
             bound (bytes of q, out, the tables and the K/V rows below
             kv_len over 3.35 TB/s).
4. serving — llama3_8b at its published widths, all 32 layers, random
             bf16 weights from a seeded CUDA generator, behind the port's
             LLMModel + ModelServer on 127.0.0.1:0: four concurrent V2
             predict requests over HTTP (greedy, 32 tokens; prompts of
             ~100 and ~300 tokens, one longer than the largest prefill
             bucket, one sharing a block-aligned prefix). Checks the
             token counts, that decode ran through the kernel (launch
             count == n_layers x decode device steps), prefix hits, and
             one stream against the full forward's teacher-forced argmax
             within the bf16 tie tolerance.

Prints the kernel JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits nonzero (printing no result)
without a CUDA device or outside the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
# parity limits against the plain version on the same inputs. f32: the
# two sum ~1000-term dot products in another order. bf16: both finish in
# f32 and round once to bf16, so an element may differ by one bf16 ulp of
# the plain version's value and no more
F32_TOL = 2e-5
BF16_ULPS = 1.0
KV_LEN = [0, 1, 65, 1000, 513, 129, 37, 300]   # idle, fresh, crossing, long
SHAPE = dict(B=8, H=32, KVH=8, D=128, bs=64, max_blocks=16)
# greedy tokens of the bf16 engine must be within this many logits of the
# teacher-forced maximum: bf16 rounds activations to 8 mantissa bits, and
# the decode path (paged kernel, incremental KV) and the full forward
# (dense einsum attention) round at different places over 32 layers
TIE_TOL = 0.25
STEP_CONTEXT = 300              # tokens per slot in the timed decode step


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def probe(torch, cuda_build) -> dict:
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {nvidia_smi_line()}")
    ver = subprocess.run([cuda_build.nvcc_path(), "--version"],
                         capture_output=True, text=True, check=True).stdout
    log(f"nvcc: {ver.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    built = cuda_build.build(["paged_decode_attention"], verbose=True)
    for name, info in built.items():
        log(f"build {name}: {info['seconds']:.3f} s (built={info['built']})")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build total {time.perf_counter() - t0:.3f} s")
    return built


def paged_case(torch, dtype, seed=0):
    """q, pools, tables, kv_len at the serving decode shape."""
    s = SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = s["B"] * s["max_blocks"] + 1
    q = torch.randn((s["B"], s["H"], s["D"]), generator=g, device="cuda")
    kp = torch.randn((nb, s["bs"], s["KVH"], s["D"]), generator=g,
                     device="cuda")
    vp = torch.randn((nb, s["bs"], s["KVH"], s["D"]), generator=g,
                     device="cuda")
    perm = torch.randperm(nb - 1, generator=g, device="cuda") + 1
    tables = torch.zeros((s["B"], s["max_blocks"]), dtype=torch.int32,
                         device="cuda")
    i = 0
    for b, n in enumerate(KV_LEN):
        live = -(-n // s["bs"])
        tables[b, :live] = perm[i:i + live].to(torch.int32)
        i += live
    kv_len = torch.tensor(KV_LEN, dtype=torch.int32, device="cuda")
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), tables, kv_len)


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (8 significant bits): 2^(e-8) for
    |x| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def parity(torch, pa) -> dict:
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        case = paged_case(torch, dtype)
        out = pa.paged_decode_attention(*case)
        torch.cuda.synchronize()
        ref = pa.paged_decode_attention_reference(*case)
        name = str(dtype).split(".")[-1]
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        idle = out[0].float().abs().max().item()
        errs[name] = err
        if dtype == torch.bfloat16:
            ulps = (diff / bf16_ulp(torch, ref)).max().item()
            ok = ulps <= BF16_ULPS
            limit = (f"{ulps!r} bf16 ulps of the plain value, limit "
                     f"{BF16_ULPS}")
        else:
            ok = err <= F32_TOL
            limit = f"limit {F32_TOL}"
        log(f"parity paged_decode_attention {name}: max_abs_err {err!r} "
            f"({limit}), idle-slot max {idle!r}")
        if not ok or idle != 0.0 or not torch.isfinite(out).all():
            raise SystemExit(f"paged_decode_attention {name} disagrees with "
                             "its plain version")
    return errs


def time_ms(torch, fn, reps=50) -> float:
    """Median per-call time in ms by CUDA events, L2 flushed before each
    call (the decode step finds the KV cold: each layer streams ~0.5 GB
    of weights between two attention calls)."""
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timing(torch, pa) -> dict:
    import torch.nn.functional as F

    s = SHAPE
    case = paged_case(torch, torch.bfloat16, seed=1)
    q, kp, vp, tables, kv_len = case
    kernel_ms = time_ms(torch, lambda: pa.paged_decode_attention(*case))
    plain_ms = time_ms(torch,
                       lambda: pa.paged_decode_attention_reference(*case))
    item = q.element_size()
    # K and V rows below kv_len: a head's row is its own 2*D-byte piece
    # of the [NB, bs, KV_H, D] pool, so no dead-tail row must be read
    kv_bytes = 2 * sum(KV_LEN) * s["KVH"] * s["D"] * item
    io_bytes = (2 * q.numel() * item + tables.numel() * 4
                + kv_len.numel() * 4 + kv_bytes)
    flops = 4 * s["H"] * s["D"] * sum(KV_LEN)      # QK^T and PV, f32 FMAs
    bound_ms = max(io_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    bound_by = ("bytes" if io_bytes / HBM_BYTES_PER_S
                >= flops / F32_FLOPS else "operations")
    # labelled yardstick only (the port never calls it): SDPA over the
    # pre-gathered dense view; no single PyTorch call reads a paged pool
    idx = tables.long()
    g = s["H"] // s["KVH"]
    kd = kp[idx].reshape(s["B"], -1, s["KVH"], s["D"]).transpose(1, 2) \
        .repeat_interleave(g, dim=1).contiguous()
    vd = vp[idx].reshape(s["B"], -1, s["KVH"], s["D"]).transpose(1, 2) \
        .repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    qd = q[:, :, None, :]
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    log(f"timing paged_decode_attention bf16 (B=8 H=32 KV_H=8 D=128 bs=64, "
        f"kv_len {KV_LEN}): kernel {kernel_ms!r} ms, plain {plain_ms!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {io_bytes} B, {flops} FLOP), "
        f"roofline share {bound_ms / kernel_ms!r}")
    log(f"reference only, not a port path: SDPA over the pre-gathered "
        f"dense view {sdpa_ms!r} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def post_json(url: str, payload: dict, timeout: float = 600.0) -> dict:
    from urllib import request as urlrequest

    req = urlrequest.Request(url, data=json.dumps(payload).encode(),
                             headers={"Content-Type": "application/json"},
                             method="POST")
    with urlrequest.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def decode_step_ms(torch, eng, steps: int = 20) -> float:
    """Host clock per ``paged_decode_step`` on the served engine's params
    and pool with every slot live at STEP_CONTEXT tokens, ending in a
    synchronize, after three warm-up steps."""
    from kubeflow_tpu_torch.serving.paged_kv import paged_decode_step

    pk = eng.paged
    for slot in range(pk.max_batch):
        pk.release(slot)
        if pk.reserve(slot, STEP_CONTEXT, 32) is None:
            raise SystemExit("pool too small for the timed decode batch")
    tables = torch.tensor(pk.tables, device=eng.device)
    tok = torch.ones((pk.max_batch,), dtype=torch.int32, device=eng.device)

    def run(n):
        for _ in range(n):
            eng.cache["len"] = torch.full_like(eng.cache["len"], STEP_CONTEXT)
            paged_decode_step(eng.params, tok, eng.cfg, eng.cache, tables,
                              kernel=eng.kernel)

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def serving(torch, pa) -> dict:
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import (
        LLMModel, ModelRepository, ModelServer,
    )

    cfg = llama.llama3_8b()                 # published widths, bf16
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) \
        + params["embed"].numel() + params["final_norm"].numel() \
        + params["lm_head"].numel()
    log(f"llama3_8b: {n_params} params bf16 ({n_params * 2 / 1e9:.2f} GB), "
        f"init {time.perf_counter() - t0:.1f} s")
    model = LLMModel("llama3-8b", params, cfg, max_batch=8, max_seq=1024,
                     device="cuda")
    repo = ModelRepository()
    repo.register(model)
    eng = model.engine
    log(f"engine: kernel={eng.kernel} block_size={eng.paged.block_size} "
        f"num_blocks={eng.paged.num_blocks} pool "
        f"{2 * eng.cache['k'].numel() * 2 / 1e9:.3f} GB "
        f"buckets={eng.buckets}")
    srv = ModelServer(repo).start()
    rng = torch.Generator().manual_seed(1)
    rand = lambda n: torch.randint(1, cfg.vocab_size, (n,),
                                   generator=rng).tolist()
    shared = rand(256)                       # 4 full 64-token blocks
    prompts = {
        "short_100": rand(100),
        "mid_300": shared + rand(44),
        "chunked_700": rand(700),            # > largest bucket (512)
        "prefix_300": shared + rand(52),     # shares mid_300's 4 blocks
    }
    results: dict = {}
    errors: list = []

    def run(tag, prompt):
        try:
            body = {"inputs": [{"name": "ids", "shape": [1, len(prompt)],
                                "datatype": "INT32", "data": prompt}],
                    "parameters": {"max_tokens": 32, "temperature": 0.0}}
            out = post_json(f"{srv.url}/v2/models/llama3-8b/infer", body)
            tensors = {t["name"]: t for t in out["outputs"]}
            results[tag] = tensors["tokens"]["data"][
                :tensors["lengths"]["data"][0]]
        except Exception as e:           # surfaced below, never swallowed
            errors.append((tag, repr(e)))

    try:
        pa.paged_decode_attention.launches = 0      # the main path's count
        t_start = time.perf_counter()
        threads = [threading.Thread(target=run, args=kv)
                   for kv in prompts.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
        launches = pa.paged_decode_attention.launches
        stats = model.stats()
    finally:
        srv.stop()
    if errors:
        model.unload()
        raise SystemExit(f"serving requests failed: {errors}")
    sched = stats["sched"]
    device_steps = sched["decode_device_steps_total"]
    n_tokens = sum(len(v) for v in results.values())
    log(f"serving: {len(results)} requests, {n_tokens} tokens in "
        f"{wall!r} s -> {n_tokens / wall!r} generated tok/s; "
        f"decode dispatches {sched['decode_dispatches_total']}, device "
        f"steps {device_steps}, prefill chunks "
        f"{sched['prefill_chunks_total']}, prefix hit blocks "
        f"{sched['prefix_hit_blocks_total']}, ttft p50 (bucket-resolved) "
        f"{stats['request_histograms']['ttft']['p50']!r} s")
    log(f"kernel launches on the main path: {launches} "
        f"(n_layers x device steps = {cfg.n_layers * device_steps})")
    for tag, toks in results.items():
        if len(toks) != 32:
            raise SystemExit(f"{tag}: {len(toks)} tokens, want 32")
    if launches < cfg.n_layers * device_steps or launches == 0:
        raise SystemExit("decode did not run through the paged kernel")
    if sched["prefix_hit_blocks_total"] < 4:
        raise SystemExit("the shared-prefix request did not share blocks")
    if sched["prefill_chunks_total"] < 2:
        raise SystemExit("the long prompt did not stream through chunks")

    # one stream against the full forward's teacher-forced argmax
    prompt, gen_toks = prompts["mid_300"], results["mid_300"]
    with torch.no_grad():
        seq = torch.tensor([prompt + gen_toks], device="cuda")
        ref = llama.forward(model.engine.params, seq, cfg)[0]
    rows = ref[len(prompt) - 1:len(prompt) - 1 + len(gen_toks)]
    margin = (rows.max(-1).values
              - rows[torch.arange(len(gen_toks)), torch.tensor(gen_toks)])
    worst = margin.max().item()
    exact = int((margin == 0).sum().item())
    log(f"teacher-forced check mid_300: {exact}/{len(gen_toks)} tokens are "
        f"the exact argmax, worst margin {worst!r} (tolerance {TIE_TOL})")
    if worst > TIE_TOL:
        raise SystemExit("served stream disagrees with the full forward")

    step_ms = decode_step_ms(torch, model.engine)
    log(f"decode step (batch 8, {cfg.n_layers} layers, paged kernel, "
        f"{STEP_CONTEXT}-token contexts): {step_ms!r} ms")
    model.unload()
    return {"launches": launches, "tok_s": n_tokens / wall,
            "decode_ms_per_step": step_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from kubeflow_tpu_torch.ops import cuda_build
        from kubeflow_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe(torch, cuda_build)
    errs = parity(torch, pa)
    t = timing(torch, pa)
    served = serving(torch, pa)
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "kubeflow_tpu/ops/pallas_paged_attention.py:65",
        "launches": served["launches"], "max_abs_err": errs["bfloat16"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

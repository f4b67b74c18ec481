"""How the paged decode kernel's split length moves its time and its bf16
agreement with the plain version, at ``chip_smoke.py``'s serving decode
shape (B=8, H=32, KV_H=8, D=128, bs=64, 16 blocks a table row): the
measurement behind ``ops/paged_attention.split_plan``.

    python -m kubeflow_tpu_torch.tools.paged_split [--blocks 1,2,4,16]
        [--seeds 4]

For each number of pool blocks a split walks (the C entry called
directly, since the wrapper always takes ``split_plan``'s; 16 blocks is
one thread block walking the whole slot, the design before the split):

- the CUDA-event median of one call (both passes), L2 flushed and the
  start held back by a spin on the card until the call is enqueued, as
  ``chip_smoke.time_ms`` times it, at chip_smoke's lengths;
- over ``--seeds`` seeded bf16 cases, each at chip_smoke's lengths and at
  the lengths where one-block splits turn: the largest error in bf16 ulps
  of the plain value, how many outputs lie past one ulp, the plain value
  at the worst one and the output rms, and the same error with the ulp
  floored at 2^-8 x the output rms.

Prints one line per split length, then one JSON line with the readings
and the card's name and power limit. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

from kubeflow_tpu_torch.ops import paged_attention as pa

B, H, KVH, D, BS, MAX_BLOCKS = 8, 32, 8, 128, 64, 16
KV_LEN = [0, 1, 65, 1000, 513, 129, 37, 300]          # chip_smoke.KV_LEN
TURNS = [0, 1, 63, 64, 65, 1024, 127, 129]           # one-block splits
SPIN_CYCLES = 200_000                                # chip_smoke's


def case(kv_len, seed):
    """bf16 q, pools, int32 tables and lengths on the card; each slot's
    live blocks are distinct pool blocks in a seeded order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = B * MAX_BLOCKS + 1
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").bfloat16()
    q, kp, vp = rnd(B, H, D), rnd(nb, BS, KVH, D), rnd(nb, BS, KVH, D)
    perm = torch.randperm(nb - 1, generator=g, device="cuda") + 1
    tables = torch.zeros((B, MAX_BLOCKS), dtype=torch.int32, device="cuda")
    i = 0
    for b, n in enumerate(kv_len):
        live = -(-n // BS)
        tables[b, :live] = perm[i:i + live].to(torch.int32)
        i += live
    return q, kp, vp, tables, torch.tensor(kv_len, dtype=torch.int32,
                                           device="cuda")


def call(lib, args, blocks):
    """One call of the C entry with ``blocks`` pool blocks a split."""
    q, kp, vp, tables, kv_len = args
    n_split = -(-MAX_BLOCKS // blocks)
    ws = torch.empty(B * H * n_split * (D + 2), device="cuda")
    out = torch.empty_like(q)
    err = lib.kft_paged_decode_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, KVH, D, BS,
        MAX_BLOCKS, blocks, n_split, 1.0 / math.sqrt(D), 1,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {err}")
    return out


def time_ms(fn, reps=50) -> float:
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def reading(out, ref) -> dict:
    ref = ref.float()
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), e - 8)
    diff = (out.float() - ref).abs()
    ulps = diff / ulp
    rms = ref.pow(2).mean().sqrt()
    worst = ulps.argmax()
    return {"ulps": ulps.max().item(),
            "past_one_ulp": int((ulps > 1).sum()),
            "plain_at_worst": ref.flatten()[worst].item(),
            "rms": rms.item(),
            "floored_ulps": (diff / torch.maximum(ulp, rms / 256)).max()
            .item()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", default="1,2,4,16",
                    help="pool blocks a split walks, comma-separated")
    ap.add_argument("--seeds", type=int, default=4,
                    help="seeded cases per set of lengths")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("paged_split needs a CUDA GPU")
    lib = pa._library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    blocks = [int(x) for x in args.blocks.split(",")]
    timed = case(KV_LEN, seed=1)
    cases = [(name, lens, seed, case(lens, seed))
             for name, lens in (("kv_len", KV_LEN), ("turns", TURNS))
             for seed in range(args.seeds)]
    refs = [pa.paged_decode_attention_reference(*c) for *_, c in cases]
    result = []
    for p in blocks:
        ms = time_ms(lambda: call(lib, timed, p))
        reads = []
        for (name, lens, seed, c), ref in zip(cases, refs):
            out = call(lib, c, p)
            torch.cuda.synchronize()
            reads.append({"lengths": name, "seed": seed,
                          **reading(out, ref)})
        worst = max(reads, key=lambda r: r["ulps"])
        print(f"{p} blocks a split: {ms!r} ms; bf16 worst {worst['ulps']!r} "
              f"ulps ({worst['lengths']} seed {worst['seed']}, plain value "
              f"{worst['plain_at_worst']!r}, output rms {worst['rms']!r}), "
              f"outputs past one ulp per case "
              f"{[r['past_one_ulp'] for r in reads]}, floored at 2^-8 rms "
              f"{max(r['floored_ulps'] for r in reads)!r}", flush=True)
        result.append({"blocks_per_split": p, "ms": ms, "readings": reads})
    print(json.dumps({"card": card, "plan": pa.split_plan(MAX_BLOCKS, BS)
                      ._asdict(), "splits": result}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

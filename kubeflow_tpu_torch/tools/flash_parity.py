"""How far the flash-attention kernels' bf16 outputs are from their
plain versions on the card, in the two readings of the parity contract,
at ``chip_smoke.py``'s phase 5 shapes.

    python -m kubeflow_tpu_torch.tools.flash_parity

The tensor-core kernels round P (forward, dK/dV) and dS (dQ, dK/dV) to
bf16 once, as they leave the accumulators for the products that take
them (O, dV, dQ, dK); the forward takes P against the running max of its
walk over 64-wide KV blocks. So each bf16 output (O; dQ; dK and dV) is
held two ways:

(a) against the plain version with P and dS rounded to bf16 at the same
    points (``operand_dtype=torch.bfloat16``): the largest ratio of an
    element's error to its limit, one bf16 ulp of the plain value
    (floored at 2^-8 x the plain tensor's rms) plus the near-tie
    allowance (``tie_allowances``; the forward's from its walk); limit 1;
(b) against the float32 plain version (the JAX function): the rms of the
    error over the rms of the plain tensor (``RMS_LIMITS``, per kernel).

The forward's lse is float32 in both bodies and stays within ``LSE_TOL``
of the plain lse.

Why the allowance. Both sides finish in float32 and round once, but the
kernel's float32 P and dS are not bit for bit the plain version's: S and
dP are summed in another order, exp is another implementation. Where a
float32 P or dS lies next to a tie between two bf16 values, the two sides
can round it to neighbours, and that one term of the product then
differs by one bf16 ulp of P or dS. So each output element's limit
adds, over the terms of its sum whose P or dS lies within ``TIE_TOL``
(relative) of a bf16 tie, one bf16 ulp of that operand times the other
factor's magnitude (in the forward, times the rescale that the walk
applies to that term and over l). The control reading shows the need: a
version that takes every sum in float64 and rounds at the same points
(``float64_ordered``; the forward's ``_fwd_walk(wide=True)``) is held to
limit (a) beside the kernel, and read against one ulp alone.

Prints one line per kernel and shape and one JSON line with the readings
and the card's name and power limit. A copy of the tree with a fault
planted in a kernel reads what the limits would see.
``forward_readings`` and ``backward_readings`` are the check's method;
``chip_smoke.py`` runs them.
"""

from __future__ import annotations

import json
import math
import subprocess

import torch

from kubeflow_tpu_torch.ops import flash_attention as fa

SHAPES = [   # name, B, S, H, KV_H, D, causal (chip_smoke.py's phase 5)
    ("train", 2, 2048, 16, 8, 128, True),
    ("unaligned", 2, 1000, 16, 4, 128, False),
    ("d64", 2, 512, 8, 2, 64, True),
]
# limit (a): one bf16 ulp of the plain value, floored at 2^-8 x rms, plus
# the near-tie allowance over operands within TIE_TOL of a bf16 tie.
# TIE_TOL (2^-14 relative, 512-1024 float32 ulps) is a margin over the
# float32 difference of the kernel's P and dS from the plain version's,
# which is a few ulps except where dP - delta cancels (and dS, with its
# ulp, is small there)
BF16_FLOOR = 2.0 ** -8
TIE_TOL = 2.0 ** -14
# limit (b): rms(kernel - float32 plain) / rms(float32 plain) for the bf16
# kernels. Read with this tool on the card (NVIDIA H100 80GB HBM3, 700 W):
# sound 0.00263 / 0.00259 (dQ / dK,dV at the training shape), at most
# 0.00266 over the three shapes; planted faults, each in a copy of the
# package: dQ skipping KV block 0 for the last query block 0.01484 at the
# training shape (0.0511, 0.0732 at the others), dK/dV summing one of the
# G heads 0.713-0.871. The limit is the geometric mean of the worst sound
# reading and the nearest fault: the same ratio of headroom on both sides
BF16_RMS_LIMIT = 6.3e-3
# limit (b) of the bf16 forward (O), set the same way from its own
# readings with this tool on the card (NVIDIA H100 80GB HBM3, 700 W):
# sound 0.00211 / 0.00241 / 0.00201 (train, unaligned, d64); planted
# faults, each in a copy of the package: the last query block skipping KV
# block 0, 0.01297 / 0.0520 / 0.0658; O rescaled by alpha only at every
# other KV block, 0.342 / 0.528 / 0.269. The limit is the geometric mean
# of the worst sound reading (0.00241) and the nearest fault (0.01297)
FWD_RMS_LIMIT = 5.6e-3
RMS_LIMITS = {"flash_attention_fwd": FWD_RMS_LIMIT,
              "flash_attention_dq": BF16_RMS_LIMIT,
              "flash_attention_dkv": BF16_RMS_LIMIT}
# the forward's lse against the plain lse, float32 in both
LSE_TOL = 1e-4


def flash_case(b, s, h, kvh, d, causal, dtype, seed=0):
    """q, k, v, dO on the card from a seeded generator, and lse / delta
    from the plain forward."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g,
                                     device="cuda").to(dtype)
    q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
    do = rnd(b, s, h, d)
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits): 2^(e-8) for |x| in
    [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def near_tie_ulps(x):
    """One bf16 ulp of each element of float32 ``x`` that lies within
    ``TIE_TOL`` (relative) of a tie between two bf16 values, 0
    elsewhere."""
    ulp = bf16_ulp(x)
    frac = torch.frac(x.abs() / ulp)
    near = (frac - 0.5).abs() * ulp <= TIE_TOL * x.abs()
    return torch.where(near, ulp, torch.zeros_like(ulp))


def tie_allowances(case, causal) -> dict:
    """{kernel: [allowance per output]}: for dQ the sum over KV rows of
    near_tie_ulps(dS) x |k|; for dK and dV over query rows and the G heads
    of near_tie_ulps(dS) x |q| and near_tie_ulps(P) x |dO|."""
    q, k = case[0], case[1]
    p, ds, qf, dof = fa._dscores(*case, causal)
    nds, npp = near_tie_ulps(ds), near_tie_ulps(p)
    del p, ds
    dq = torch.einsum("bkgqs,bskd->bqkgd", nds, k.float().abs())
    return {"flash_attention_dq": [dq.reshape(q.shape)],
            "flash_attention_dkv": [
                torch.einsum("bkgqs,bqkgd->bskd", nds, qf.abs()),
                torch.einsum("bkgqs,bqkgd->bskd", npp, dof.abs())]}


def ulp_ratio(out, ref, allowance=None) -> float:
    """max |out - ref| / (max(one bf16 ulp of ref, 2^-8 rms(ref)) +
    allowance)."""
    ref = ref.float()
    limit = torch.maximum(bf16_ulp(ref),
                          BF16_FLOOR * ref.pow(2).mean().sqrt())
    if allowance is not None:
        limit = limit + allowance
    return ((out.float() - ref).abs() / limit).max().item()


def rms_rel(out, ref) -> float:
    """rms(out - ref) / rms(ref), summed in float64."""
    ref = ref.double()
    return ((out.double() - ref).pow(2).mean().sqrt()
            / ref.pow(2).mean().sqrt()).item()


def float64_ordered(q, k, v, do, lse, delta, causal):
    """[dQ, dK, dV] with every sum taken in float64 (another order than
    the plain version's float32 einsums) and the plain version's rounding
    points: S and dP rounded to float32, P and dS computed in float32 and
    rounded to bf16, the products' sums rounded to float32 and then to
    the inputs' dtype."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qd = q.double().reshape(b, sq, kvh, g, d)
    dod = do.double().reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qd, k.double()).float() * scale
    s = torch.where(fa._mask(sq, skv, causal, q.device), s,
                    torch.tensor(fa.NEG_INF, device=q.device))
    p = torch.exp(s - lse.reshape(b, kvh, g, sq)[..., None])
    dp = torch.einsum("bqkgd,bskd->bkgqs", dod, v.double()).float()
    ds = p * (dp - delta.reshape(b, kvh, g, sq)[..., None]) * scale
    pb, dsb = p.to(torch.bfloat16).double(), ds.to(torch.bfloat16).double()
    del s, p, dp, ds
    dq = torch.einsum("bkgqs,bskd->bqkgd", dsb, k.double()).reshape(q.shape)
    dk = torch.einsum("bkgqs,bqkgd->bskd", dsb, qd)
    dv = torch.einsum("bkgqs,bqkgd->bskd", pb, dod)
    return [x.float().to(q.dtype) for x in (dq, dk, dv)]


def forward_rounded(q, k, v, causal) -> tuple:
    """(O, allowance): the plain forward that rounds P to bf16 where the
    kernel does, and limit (a)'s near-tie allowance per element of O: over
    the terms whose float32 P lies within ``TIE_TOL`` of a bf16 tie, one
    bf16 ulp of P times |v|, rescaled by the walk as that term is and
    divided by l."""
    near = lambda p, vb: torch.einsum("bkgqs,bskd->bkgqd", near_tie_ulps(p),
                                      vb.abs())
    o, _, allow = fa._fwd_walk(q, k, v, causal, torch.bfloat16, on_p=near)
    return o, allow


def forward_readings(case, causal) -> dict:
    """{"flash_attention_fwd": reading} of the forward kernel's O on one
    bf16 case, with the keys of ``backward_readings`` and "lse_err", the
    largest error of its lse against the float32 plain lse."""
    q, k, v = case[:3]
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    rounded, allow = forward_rounded(q, k, v, causal)
    plain, plain_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    control = fa._fwd_walk(q, k, v, causal, torch.bfloat16, wide=True)[0]
    return {"flash_attention_fwd": {
        "ulp_ratio": ulp_ratio(o, rounded, allow),
        "one_ulp_ratio": ulp_ratio(o, rounded),
        "rms_rel": rms_rel(o, plain),
        "max_abs_err": (o.float() - rounded.float()).abs().max().item(),
        "finite": bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
        "control_ulp_ratio": ulp_ratio(control, rounded, allow),
        "control_one_ulp_ratio": ulp_ratio(control, rounded),
        "lse_err": (lse - plain_lse).abs().max().item(),
        "rms_limit": RMS_LIMITS["flash_attention_fwd"],
    }}


def backward_readings(case, causal) -> dict:
    """{kernel: {"ulp_ratio", "one_ulp_ratio", "rms_rel", "max_abs_err",
    "finite", "control_ulp_ratio", "control_one_ulp_ratio"}} of the dQ
    and the dK/dV kernel on one bf16 case, the worse of dK and dV: limit
    (a)'s reading (with the near-tie allowance), one ulp alone (not a
    limit), limit (b)'s, the largest error against the plain version that
    rounds where the kernel does, and the float64-ordered control's two
    readings of limit (a)."""
    outs = {"flash_attention_dq": [fa.flash_attention_dq(*case, causal)],
            "flash_attention_dkv": list(fa.flash_attention_dkv(*case,
                                                               causal))}
    torch.cuda.synchronize()
    rounded = {"flash_attention_dq": [fa.flash_attention_dq_reference(
        *case, causal, operand_dtype=torch.bfloat16)],
        "flash_attention_dkv": list(fa.flash_attention_dkv_reference(
            *case, causal, operand_dtype=torch.bfloat16))}
    plain = {"flash_attention_dq": [fa.flash_attention_dq_reference(
        *case, causal)],
        "flash_attention_dkv": list(fa.flash_attention_dkv_reference(
            *case, causal))}
    allow = tie_allowances(case, causal)
    control = float64_ordered(*case, causal)
    control = {"flash_attention_dq": control[:1],
               "flash_attention_dkv": control[1:]}
    out = {}
    for name, got in outs.items():
        trio = list(zip(got, rounded[name], allow[name]))
        ctrl = list(zip(control[name], rounded[name], allow[name]))
        out[name] = {
            "ulp_ratio": max(ulp_ratio(o, r, a) for o, r, a in trio),
            "one_ulp_ratio": max(ulp_ratio(o, r) for o, r, _ in trio),
            "rms_rel": max(rms_rel(o, r) for o, r in zip(got, plain[name])),
            "max_abs_err": max((o.float() - r.float()).abs().max().item()
                               for o, r, _ in trio),
            "finite": all(bool(torch.isfinite(o).all()) for o in got),
            "control_ulp_ratio": max(ulp_ratio(o, r, a)
                                     for o, r, a in ctrl),
            "control_one_ulp_ratio": max(ulp_ratio(o, r)
                                         for o, r, _ in ctrl),
            "rms_limit": RMS_LIMITS[name],
        }
    return out


def passes(reading: dict) -> bool:
    """Limits (a) and (b) on one kernel's reading, the forward's lse
    within ``LSE_TOL``, and limit (a) on the float64-ordered control (a
    control outside it means the limit, not the kernel, is at fault)."""
    return (reading["finite"] and reading["ulp_ratio"] <= 1.0
            and reading["rms_rel"] <= reading["rms_limit"]
            and reading.get("lse_err", 0.0) <= LSE_TOL
            and reading["control_ulp_ratio"] <= 1.0)


def describe(r: dict) -> str:
    lse = (f"; lse max_abs_err {r['lse_err']!r} (limit {LSE_TOL})"
           if "lse_err" in r else "")
    return (f"(a) {r['ulp_ratio']!r} of one ulp + near-tie allowance "
            f"(limit 1; one ulp alone {r['one_ulp_ratio']!r}), (b) rms "
            f"{r['rms_rel']!r} (limit {r['rms_limit']}), max_abs_err "
            f"{r['max_abs_err']!r}; float64-ordered control (a) "
            f"{r['control_ulp_ratio']!r}, one ulp alone "
            f"{r['control_one_ulp_ratio']!r}{lse}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_parity needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {}
    for name, b, s, h, kvh, d, causal in SHAPES:
        case = flash_case(b, s, h, kvh, d, causal, torch.bfloat16)
        readings = {**forward_readings(case, causal),
                    **backward_readings(case, causal)}
        for kernel, r in readings.items():
            print(f"{kernel} {name} (B={b} S={s} H={h} KV_H={kvh} D={d} "
                  f"causal={causal}) bf16: {describe(r)}"
                  f"{'' if passes(r) else '  OUTSIDE'}", flush=True)
        result[name] = readings
        del case
        torch.cuda.empty_cache()
    print(json.dumps({"readings": result, "card": card,
                      "limit_b": RMS_LIMITS}), flush=True)
    return 0 if all(passes(r) for rs in result.values()
                    for r in rs.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Continuous-batching step scheduler — the policy layer over LLMEngine.

The engine owns the jitted machinery (prefill / chunked prefill / multistep
decode over the paged pool); this module owns the per-step POLICY and the
counters the serving controller autoscales on (ROADMAP item 2):

- **Step token quota (Sarathi-style).** Every engine step has a prefill
  budget (``prefill_tokens_per_step``, default: the largest prefill
  bucket). The budget is spent on at most ONE chunk of an in-flight
  chunked prefill, then on admission prefills, then the decode batch
  dispatches — so a long prompt streams through in budget-sized slices
  interleaved with decode instead of convoying every live stream
  (``interleave_prefill=False`` restores the legacy run-to-completion
  admission as the scheduler-off parity baseline).
- **Slot-level join/evict inside the decode chunk.** Multistep decode
  dispatches ``decode_chunk`` device steps at a time; a request finishing
  early holds its slot until the chunk's read-back. Under queue pressure
  (``adaptive_decode_chunk``) the scheduler trims the dispatch to the
  nearest power-of-two covering the earliest DETERMINISTIC finish
  (max_tokens / max_seq bound) among active requests, so the freed slot is
  re-admissible at that step, not ``decode_chunk`` device steps later.
  Power-of-two lengths keep the compile count log2(decode_chunk).
- **FIFO under memory pressure.** When a reservation fails the request
  waits at the head of the queue (counted as a stall); shared-prefix
  refcounts roll back so the retry can never duplicate blocks.

Pure stdlib on purpose: the engine, the runtime's env parsing and the
tests share it without pulling the model code in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class QuantConfig:
    """Quantized-serving knobs (serving/quant.py resolves them against
    the platform/model; the API layer re-exports this as the
    predictor-spec ``QuantPolicy`` and the ISVC controller stamps it as
    KFT_QUANT_KV / KFT_QUANT_WEIGHTS / KFT_QUANT_EXACT_PARITY).

    kv_dtype: paged-KV pool storage — "none" | "int8" | "fp8_e4m3".
        Only "none" is served by this package so far: quantized pools
        (and their fused-dequant decode kernel) are a later slice, and
        serving/quant.resolve_quant raises for them.
    weight_dtype: model weights — "none" | "int8". int8 weights are a
        later slice too (resolve_quant raises).
    exact_parity: escape hatch — forces BOTH paths off regardless of
        the dtypes above. The resulting programs are bitwise-identical
        to an engine that never heard of quantization (no downgrade is
        counted: the caller asked for parity).
    """

    kv_dtype: str = "none"
    weight_dtype: str = "none"
    exact_parity: bool = False

    KV_DTYPES = ("none", "int8", "fp8_e4m3")
    WEIGHT_DTYPES = ("none", "int8")

    def validate(self) -> None:
        if self.kv_dtype not in self.KV_DTYPES:
            raise ValueError(f"kv_dtype={self.kv_dtype!r} "
                             f"(want one of {self.KV_DTYPES})")
        if self.weight_dtype not in self.WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype={self.weight_dtype!r} "
                             f"(want one of {self.WEIGHT_DTYPES})")

    @property
    def enabled(self) -> bool:
        return (not self.exact_parity
                and (self.kv_dtype != "none"
                     or self.weight_dtype != "none"))

    def tag(self) -> str:
        """Depot-fingerprint token: precompiled executables under
        different quant configs must never collide, even when parity-off
        lowers to byte-identical HLO — the tag joins the fingerprint's
        ``extra`` tuple so the keys differ by construction."""
        if not self.enabled:
            return "quant=off"
        return f"quant=kv:{self.kv_dtype},w:{self.weight_dtype}"


@dataclasses.dataclass
class SchedulerConfig:
    """Knobs for the continuous-batching step scheduler.

    prefill_tokens_per_step: per-step prefill token budget (the Sarathi
        quota). 0 = auto (the engine's largest prefill bucket, so one
        chunk or one full admission bucket per step).
    interleave_prefill: advance chunked prefills one budget-sized chunk
        per step, interleaved with decode. False = legacy convoy
        (run every chunk inside one step) — kept as the scheduler-off
        parity baseline and measured by bench as the ablation.
    adaptive_decode_chunk: under queue pressure, trim the multistep
        decode dispatch to the earliest deterministic finish (pow2) so
        freed slots rejoin early. False = fixed decode_chunk dispatches.
    radix_cache: share prompt KV blocks through the radix prefix tree
        (PagedKV). False disables matching AND publishing.
    spec_decode: speculative decoding — a host-side drafter
        (serving/spec_decode.py) proposes up to spec_k tokens per
        stream, the target model verifies them in ONE batched step, and
        the accepted prefix commits (greedy outputs token-identical to
        non-speculative decode; a dispatch with a non-greedy request in
        the batch falls back to normal decode, counted).
    spec_k: max draft tokens per verify step. The verify width
        (1 + spec_k: the input column plus drafts) pads to the next
        power of two, so the compile count stays log2 — the same static
        pow2 chunk_len scheme the adaptive decode chunk uses; the
        default 3 makes the full width exactly 4.
    spec_drafter: drafter name ("ngram" = prompt-lookup, zero extra
        weights).
    """

    prefill_tokens_per_step: int = 0
    interleave_prefill: bool = True
    adaptive_decode_chunk: bool = True
    radix_cache: bool = True
    spec_decode: bool = False
    spec_k: int = 3
    spec_drafter: str = "ngram"
    # quantized serving (see QuantConfig above). None = unquantized.
    # LLMEngine's explicit quant= argument wins when both are set.
    quant: Optional[QuantConfig] = None


def ceil_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


class StepScheduler:
    """Per-engine scheduler state: budget arithmetic + the counter set
    exported to /metrics (``kft_model_sched_*``)."""

    def __init__(self, cfg: Optional[SchedulerConfig], *,
                 default_budget: int, decode_chunk: int):
        self.cfg = cfg or SchedulerConfig()
        self.default_budget = int(default_budget)
        self.decode_chunk = int(decode_chunk)
        # counters (monotonic unless marked gauge-by-snapshot)
        self.steps = 0
        self.decode_dispatches = 0
        self.decode_device_steps = 0
        self.prefill_chunks = 0            # interleaved chunk advances
        self.prefill_chunk_tokens = 0
        self.admitted = 0                  # bucket-prefill admissions
        self.chunked_admitted = 0          # chunked prefills completed
        self.chunked_started = 0
        self.preempts = 0                  # chunked prefills cancelled mid-flight
        self.admission_stalls = 0          # reservation failed under pressure
        self.short_chunks = 0              # adaptive trims under pressure
        # speculative decoding (spec_decode=True dispatches)
        self.spec_dispatches = 0           # verify steps dispatched
        self.spec_slot_rounds = 0          # (dispatch, live stream) pairs
        self.spec_draft_tokens = 0         # drafter proposals scored
        self.spec_accepted_draft_tokens = 0  # proposals matching target
        self.spec_committed_tokens = 0     # tokens committed by verifies
        self.spec_fallbacks = 0            # non-greedy batch -> plain decode
        self.spec_undrafted = 0            # no drafts anywhere -> plain decode

    # ---- per-step decisions ----

    def prefill_budget(self) -> int:
        """Tokens of prefill work this step may do (>= 1 slice always
        makes progress; the quota bounds steady-state interference)."""
        q = self.cfg.prefill_tokens_per_step
        return int(q) if q and q > 0 else self.default_budget

    def decode_chunk_len(self, min_deterministic_remaining: Optional[int],
                         pressure: bool) -> int:
        """Device steps for the next decode dispatch. Full chunk unless
        queue pressure exists and some active request deterministically
        finishes sooner — then the nearest covering power of two, so its
        slot frees at that boundary."""
        full = self.decode_chunk
        if (not self.cfg.adaptive_decode_chunk or not pressure
                or min_deterministic_remaining is None
                or min_deterministic_remaining >= full):
            return full
        trimmed = min(full, ceil_pow2(min_deterministic_remaining))
        if trimmed < full:
            self.short_chunks += 1
        return trimmed

    # ---- counter hooks ----

    def note_step(self) -> None:
        self.steps += 1

    def note_decode_dispatch(self, chunk_len: int) -> None:
        self.decode_dispatches += 1
        self.decode_device_steps += int(chunk_len)

    def note_prefill_chunk(self, tokens: int) -> None:
        self.prefill_chunks += 1
        self.prefill_chunk_tokens += int(tokens)

    def note_admitted(self, n: int) -> None:
        self.admitted += int(n)

    def note_chunked_started(self) -> None:
        self.chunked_started += 1

    def note_chunked_admitted(self) -> None:
        self.chunked_admitted += 1

    def note_preempt(self) -> None:
        self.preempts += 1

    def note_stall(self) -> None:
        self.admission_stalls += 1

    def note_spec_dispatch(self, drafted: int) -> None:
        self.spec_dispatches += 1
        self.spec_draft_tokens += int(drafted)

    def note_spec_result(self, accepted: int, committed: int) -> None:
        self.spec_slot_rounds += 1
        self.spec_accepted_draft_tokens += int(accepted)
        self.spec_committed_tokens += int(committed)

    def note_spec_fallback(self) -> None:
        self.spec_fallbacks += 1

    def note_spec_undrafted(self) -> None:
        self.spec_undrafted += 1

    # ---- export ----

    def snapshot(self, *, active: int, waiting: int, chunked: int,
                 max_batch: int, prefix_hits: int,
                 prefix_queries: int, backlog_tokens: int = 0) -> dict:
        """The /metrics view: occupancy, queue depth, token backlog,
        prefix-hit and preempt counters — the signals the serving
        controller autoscales and prefix-affine-routes on (the
        ``kft_model_sched_*`` family the fleet Autoscaler consumes).
        ``backlog_tokens``: prompt + budget tokens of queued work the
        replica has admitted responsibility for but not yet scheduled."""
        occ = active / max_batch if max_batch else 0.0
        rate = prefix_hits / prefix_queries if prefix_queries else 0.0
        return {
            "steps_total": self.steps,
            "decode_dispatches_total": self.decode_dispatches,
            "decode_device_steps_total": self.decode_device_steps,
            "prefill_chunks_total": self.prefill_chunks,
            "prefill_chunk_tokens_total": self.prefill_chunk_tokens,
            "admitted_total": self.admitted,
            "chunked_started_total": self.chunked_started,
            "chunked_admitted_total": self.chunked_admitted,
            "preempts_total": self.preempts,
            "admission_stalls_total": self.admission_stalls,
            "short_chunks_total": self.short_chunks,
            "occupancy_slots": active,
            "occupancy_ratio": round(occ, 4),
            "queue_depth": waiting,
            "token_backlog": int(backlog_tokens),
            "chunked_in_flight": chunked,
            "prefix_hit_blocks_total": prefix_hits,
            "prefix_query_blocks_total": prefix_queries,
            "prefix_hit_rate": round(rate, 4),
            # speculative decoding: accepted_tokens_per_step is PER
            # STREAM per verify step — the tokens/s/stream speedup lever
            # (1.0 = plain decode; the acceptance floor, never below)
            "spec_dispatches_total": self.spec_dispatches,
            "spec_slot_rounds_total": self.spec_slot_rounds,
            "spec_draft_tokens_total": self.spec_draft_tokens,
            "spec_accepted_draft_tokens_total":
                self.spec_accepted_draft_tokens,
            "spec_committed_tokens_total": self.spec_committed_tokens,
            "spec_fallbacks_total": self.spec_fallbacks,
            "spec_undrafted_steps_total": self.spec_undrafted,
            "accepted_tokens_per_step": round(
                self.spec_committed_tokens / self.spec_slot_rounds, 4)
                if self.spec_slot_rounds else 0.0,
        }

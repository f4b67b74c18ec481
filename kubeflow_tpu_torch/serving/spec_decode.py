"""Speculative-decoding drafters — the proposal side of draft-and-verify
(counterpart of ``kubeflow_tpu.serving.spec_decode``; host-side numpy, no
torch).

A drafter looks at a request's committed context (prompt + generated)
and proposes up to ``k`` next tokens; the engine then scores ALL
proposals in ONE batched target-model dispatch
(``paged_kv.paged_verify_step``) and commits the
longest prefix that matches the target's own greedy chain, plus the
target's next token. Greedy outputs are therefore TOKEN-IDENTICAL to
non-speculative decode — the drafter only ever changes how many device
steps that takes, never what they produce — and every verify commits at
least one token (the worst case IS a normal decode step). (Identity is
exact under a shared tie-break on equal logit values; verify and decode
are different programs — dense attention over the gathered view and
``[B*S, .]`` products against the paged kernel and ``[B, .]`` products —
so bf16 near-ties can flip a greedy token between them. The f32 tests
assert identity exactly; chip_smoke.py measures the bf16 distance.)

The default drafter is prompt-lookup / n-gram (LLMA, "Prompt Lookup
Decoding"): propose the continuation that followed the most recent
previous occurrence of the trailing n-gram in the request's own context.
Zero extra weights, no second model, and the 128-stream
shared-system-prompt serving workload is its best case — answers quote
the prompt, greedy decode of long outputs repeats itself, and every
match turns k+1 decode steps into one verify step.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class NgramDrafter:
    """Prompt-lookup drafting over the request's own context.

    ``draft(context)`` matches the trailing ``n``-gram (longest first,
    ``max_ngram`` down to ``min_ngram``) against every earlier position
    of the context and proposes the up-to-``k`` tokens that followed the
    MOST RECENT prior occurrence (any match's continuation is nonempty —
    the suffix start itself is excluded from candidates). No match
    drafts nothing — the verify step then degrades to a plain decode
    step, never below it.

    Matching is numpy-vectorized (``n`` shifted equality passes over the
    whole context, C speed): drafting runs once per stream per verify
    round on the serving hot loop, and contexts reach ``max_seq``
    tokens, so a Python-level scan would grow a per-round host cost
    right where the verify step is saving device steps.
    """

    name = "ngram"

    def __init__(self, k: int = 4, max_ngram: int = 3, min_ngram: int = 1):
        if k < 1:
            raise ValueError(f"spec_k={k} (want >= 1)")
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"bad ngram range [{min_ngram}, {max_ngram}]")
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def draft(self, context: Sequence[int]) -> list[int]:
        arr = np.asarray(context, np.int64)
        L = arr.size
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pattern = arr[L - n:]
            # candidate starts 0..L-n-1: the trailing n-gram itself
            # (start L-n) is excluded, so every match has at least one
            # continuation token
            hits = arr[:L - n] == pattern[0]
            for j in range(1, n):
                hits &= arr[j:L - n + j] == pattern[j]
            idx = np.nonzero(hits)[0]
            if idx.size:
                start = int(idx[-1]) + n      # most recent occurrence
                return arr[start:start + self.k].tolist()
        return []


def make_drafter(name: str, k: int) -> NgramDrafter:
    """Drafter registry for the ``spec_drafter`` knob (KFT_SPEC_DRAFTER).
    Only "ngram" exists today; a weight-tied truncated-model drafter
    would register here without touching the engine's verify path."""
    if name in ("ngram", "prompt_lookup"):
        return NgramDrafter(k=k)
    raise ValueError(f"spec_drafter={name!r} (want 'ngram')")

"""The engine's steady-state decode program as a CUDA graph (the port's
counterpart of the JAX engine's ``precompile``d decode executable).

``DecodeBuffers`` are the decode program's static inputs and outputs on
the engine's device: one packed int32 tensor holding this dispatch's
host inputs (input tokens, the fresh-token mask, the active-slot mask,
the sampling parameters and the block tables), the device-side carry
(the previous chunk's next tokens) and the output rows (tokens and
logprobs, ``[decode_chunk, B]``). The engine's decode body reads and
writes only these, so the body it runs eagerly is the very code a
``DecodeGraph`` captures. A dispatch stages its host inputs in ONE copy
(``cuda_graph.PinnedStaging``: on a CUDA device from pinned host memory,
asynchronously), so staging never waits for the device work queued
before it.

``DecodeGraph`` captures ``decode_chunk`` greedy steps of that body
once, on an idle engine, and replays them (``cuda_graph.capture``: the
side-stream warm-up, the launch counts the capture takes back and each
replay adds). A graph holds the addresses of every tensor it touches, so
the KV cache's tensors must never be replaced (``serving.paged_kv``
writes them in place): each replay checks that the cache still holds the
tensors that were captured, and raises otherwise. Nothing here falls
back to the eager body; a capture or replay that fails raises.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.cuda_graph import PinnedStaging, capture


class DecodeBuffers:
    """The decode program's static inputs and outputs (module docstring)
    for ``max_batch`` slots, ``max_blocks`` table entries per slot and at
    most ``chunk`` steps a dispatch, on ``device``."""

    def __init__(self, max_batch: int, max_blocks: int, chunk: int,
                 device: torch.device):
        b = max_batch
        self.device = device
        # packed int32 layout: tokens, fresh, active, top_k, temperature
        # (float32 bits), top_p (float32 bits), then the tables
        self._staging = PinnedStaging(6 * b + b * max_blocks, torch.int32,
                                      device)
        s = self._staging.staged
        self.tokens = s[0:b]
        self.fresh = s[b:2 * b]
        self.active = s[2 * b:3 * b]
        self.top_k = s[3 * b:4 * b]
        self.temperature = s[4 * b:5 * b].view(torch.float32)
        self.top_p = s[5 * b:6 * b].view(torch.float32)
        self.tables = s[6 * b:].view(b, max_blocks)
        self.carry = torch.zeros((b,), dtype=torch.int32, device=device)
        self.toks = torch.zeros((chunk, b), dtype=torch.int32, device=device)
        self.lps = torch.zeros((chunk, b), dtype=torch.float32,
                               device=device)

    def stage(self, tokens, fresh, active, tables, temperature, top_k,
              top_p) -> None:
        """Copy one dispatch's host inputs (numpy, [B] each and tables
        [B, max_blocks]) into the static inputs: one packed copy, queued
        on the current stream behind the work already there."""
        b = len(tokens)

        def fill(buf: torch.Tensor) -> None:
            host = buf.numpy()
            host[0:b] = tokens
            host[b:2 * b] = fresh
            host[2 * b:3 * b] = active
            host[3 * b:4 * b] = top_k
            as_f32 = host.view(np.float32)
            as_f32[4 * b:5 * b] = temperature
            as_f32[5 * b:6 * b] = top_p
            host[6 * b:] = np.asarray(tables).reshape(-1)

        self._staging.stage(fill)


class DecodeGraph:
    """``run()`` captured once as a CUDA graph with its own memory pool,
    then replayed. ``cache``: the KV cache dict whose tensors the graph
    holds; ``counters``: the kernel wrappers whose ``.launches`` a
    replay adds to (``cuda_graph.CapturedGraph``).

    Capture (``cuda_graph.capture``): two warm-up calls of ``run()`` on
    a side stream (the caller has put the engine in a state whose writes
    land where nothing reads), then one call under capture.
    ``capture_seconds`` and ``pool_bytes`` (device memory the capture
    reserved) describe it; ``replays`` counts replays and ``launches`` is
    the kernel launches one replay makes, per counter."""

    def __init__(self, run: Callable[[], None], cache: dict,
                 counters: Sequence, device: torch.device):
        self.cache = cache
        captured = capture([run], lambda: cache, counters, device,
                           "the KV cache's tensors")
        [self._graph] = captured.graphs
        self.capture_seconds = captured.capture_seconds
        self.pool_bytes = captured.pool_bytes
        self.launches = self._graph.launches

    @property
    def replays(self) -> int:
        return self._graph.replays

    def replay(self) -> None:
        """Launch the captured program on the current stream, after
        checking that the cache still holds the captured tensors."""
        self._graph.replay()

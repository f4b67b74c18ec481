"""The engine's steady-state decode program as a CUDA graph (the port's
counterpart of the JAX engine's ``precompile``d decode executable).

``DecodeBuffers`` are the decode program's static inputs and outputs on
the engine's device: one packed int32 tensor holding this dispatch's
host inputs (input tokens, the fresh-token mask, the active-slot mask,
the sampling parameters and the block tables), the device-side carry
(the previous chunk's next tokens) and the output rows (tokens and
logprobs, ``[decode_chunk, B]``). The engine's decode body reads and
writes only these, so the body it runs eagerly is the very code a
``DecodeGraph`` captures. A dispatch stages its host inputs in ONE copy:
on a CUDA device from pinned host memory, asynchronously, through two
staging buffers used in turn, each reused only once an event says its
previous copy has finished. So staging never waits for the device work
queued before it (a pageable copy would: PyTorch ends it with a stream
synchronize).

``DecodeGraph`` captures ``decode_chunk`` greedy steps of that body
once, on an idle engine, and replays them. A graph holds the addresses
of every tensor it touches, so the KV cache's tensors must never be
replaced (``serving.paged_kv`` writes them in place): each replay checks
that the cache still holds the tensors that were captured, and raises
otherwise. Nothing here falls back to the eager body; a capture or
replay that fails raises.

Kernel launch counts: a wrapper counts a launch each time it is called,
and the capture calls each wrapper without launching anything. So the
capture takes back what it counted and each replay adds it, which is
the number of kernel launches the replay makes.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

# eager runs of the body before the capture, on a side stream: the first
# builds the paged kernel and sets cuBLAS up, the second runs warm
WARMUP_RUNS = 2


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
        self._size = 6 * b + b * max_blocks
        self.staged = torch.zeros((self._size,), dtype=torch.int32,
                                  device=device)
        s = self.staged
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
        pinned = device.type == "cuda"
        self._host = [torch.zeros((self._size,), dtype=torch.int32,
                                  pin_memory=pinned)
                      for _ in range(2 if pinned else 1)]
        self._copied: list = [None] * len(self._host)
        self._turn = 0

    def stage(self, tokens, fresh, active, tables, temperature, top_k,
              top_p) -> None:
        """Copy one dispatch's host inputs (numpy, [B] each and tables
        [B, max_blocks]) into the static inputs: one packed copy, queued
        on the current stream behind the work already there."""
        i = self._turn
        self._turn = (i + 1) % len(self._host)
        if self._copied[i] is not None:
            self._copied[i].synchronize()    # its last copy has left it
        host = self._host[i].numpy()
        b = len(tokens)
        host[0:b] = tokens
        host[b:2 * b] = fresh
        host[2 * b:3 * b] = active
        host[3 * b:4 * b] = top_k
        as_f32 = host.view(np.float32)
        as_f32[4 * b:5 * b] = temperature
        as_f32[5 * b:6 * b] = top_p
        host[6 * b:] = np.asarray(tables).reshape(-1)
        if self.device.type != "cuda":
            self.staged.copy_(self._host[i])
            return
        self.staged.copy_(self._host[i], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._copied[i] = event


class DecodeGraph:
    """``run()`` captured once as a CUDA graph with its own memory pool,
    then replayed. ``cache``: the KV cache dict whose tensors the graph
    holds; ``counters``: the kernel wrappers whose ``.launches`` a
    replay adds to (module docstring).

    Capture: ``WARMUP_RUNS`` calls of ``run()`` on a side stream (the
    caller has put the engine in a state whose writes land where nothing
    reads), then one call under capture. ``capture_seconds`` and
    ``pool_bytes`` (device memory the capture reserved) describe it;
    ``replays`` counts replays and ``launches`` is the kernel launches
    one replay makes, per counter."""

    def __init__(self, run: Callable[[], None], cache: dict,
                 counters: Sequence, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got "
                             f"{device}")
        self.cache = cache
        self._ptrs = {k: t.data_ptr() for k, t in cache.items()}
        self.counters = tuple(counters)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                run()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = [c.launches for c in self.counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            run()
        torch.cuda.synchronize(device)
        self.launches = {c.__name__: c.launches - n
                         for c, n in zip(self.counters, before)}
        for c, n in zip(self.counters, before):
            c.launches = n              # recorded, not launched
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.capture_seconds = time.perf_counter() - t0
        self.replays = 0

    def replay(self) -> None:
        """Launch the captured program on the current stream, after
        checking that the cache still holds the captured tensors."""
        moved = [k for k, t in self.cache.items()
                 if self._ptrs.get(k) != t.data_ptr()]
        if moved or len(self.cache) != len(self._ptrs):
            raise RuntimeError(
                f"the KV cache's tensors {moved or sorted(self.cache)} are "
                "not those the decode graph captured: the cache must be "
                "written in place")
        self.graph.replay()
        self.replays += 1
        for c in self.counters:
            c.launches += self.launches[c.__name__]

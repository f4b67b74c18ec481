"""CUDA-graph capture and replay, shared by the port's captured programs
(the engine's decode program, ``serving/decode_graph.py``, and the
training step, ``training/step_graph.py``), and the staging of a
program's host inputs.

``PinnedStaging`` is one static device tensor that a program reads, filled
from host memory by ONE copy a stage: on a CUDA device from pinned host
memory, asynchronously, through two staging buffers used in turn, each
reused only once an event says its previous copy has finished. So
staging never waits for the device work queued before it (a pageable
copy would: PyTorch ends it with a stream synchronize).

``capture`` warms a program's parts up and captures each as a CUDA graph,
all in one memory pool; ``CapturedGraph`` replays one part. A graph holds
the addresses of every tensor it touches, so its state must never be
replaced: each replay checks that the tensors the owner names still have
the addresses they had at capture, and raises otherwise. Nothing here
falls back to eager execution; a capture or replay that fails raises.

Kernel launch counts: a wrapper counts a launch each time it is called,
and the capture calls each wrapper without launching anything. So the
capture takes back what it counted and each replay adds it, which is the
number of kernel launches the replay makes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

# eager runs of a program's parts before the capture, on a side stream:
# the first builds the kernels and sets cuBLAS (and autograd) up, the
# second runs warm
WARMUP_RUNS = 2

DEPOT_STORE = ("the executable depot's cross-process store is a later slice "
               "of the PyTorch port (ROADMAP queue 1 item 6.4): a CUDA graph "
               "cannot be serialized to another process")


class PinnedStaging:
    """A static ``[numel]`` tensor of ``dtype`` on ``device`` (``staged``)
    and the host memory it is staged from (module docstring)."""

    def __init__(self, numel: int, dtype: torch.dtype, device: torch.device):
        self.device = device
        self.staged = torch.zeros((numel,), dtype=dtype, device=device)
        pinned = device.type == "cuda"
        self._host = [torch.zeros((numel,), dtype=dtype, pin_memory=pinned)
                      for _ in range(2 if pinned else 1)]
        self._copied: list = [None] * len(self._host)
        self._turn = 0

    def stage(self, fill: Callable[[torch.Tensor], None]) -> None:
        """``fill(host)`` writes this stage's inputs into a host buffer,
        which is then copied into ``staged`` in one copy, queued on the
        current stream behind the work already there."""
        i = self._turn
        self._turn = (i + 1) % len(self._host)
        if self._copied[i] is not None:
            self._copied[i].synchronize()    # its last copy has left it
        fill(self._host[i])
        if self.device.type != "cuda":
            self.staged.copy_(self._host[i])
            return
        self.staged.copy_(self._host[i], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._copied[i] = event


def _addresses(tensors: dict) -> dict:
    return {k: None if t is None else t.data_ptr()
            for k, t in tensors.items()}


class CapturedGraph:
    """``run()`` captured once as a CUDA graph (in ``pool`` when given),
    then replayed. ``tensors()``: the named tensors the graph holds, whose
    addresses each replay checks; ``what`` names them in the error.
    ``counters``: the kernel wrappers whose ``.launches`` a replay adds to
    (module docstring); ``launches`` is the kernel launches one replay
    makes, per counter, and ``replays`` counts replays."""

    def __init__(self, run: Callable[[], None],
                 tensors: Callable[[], dict], counters: Sequence,
                 device: torch.device, what: str, pool=None):
        self.tensors = tensors
        self.what = what
        self._ptrs = _addresses(tensors())
        self.counters = tuple(counters)
        before = [c.launches for c in self.counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            run()
        torch.cuda.synchronize(device)
        self.launches = {c.__name__: c.launches - n
                         for c, n in zip(self.counters, before)}
        for c, n in zip(self.counters, before):
            c.launches = n              # recorded, not launched
        self.replays = 0

    def replay(self) -> None:
        """Launch the captured graph on the current stream, after checking
        that the named tensors are those it captured."""
        now = _addresses(self.tensors())
        moved = sorted(k for k in self._ptrs.keys() | now.keys()
                       if self._ptrs.get(k) != now.get(k))
        if moved:
            raise RuntimeError(
                f"{self.what} {moved} are not those the graph captured: "
                "they must be written in place")
        self.graph.replay()
        self.replays += 1
        for c in self.counters:
            c.launches += self.launches[c.__name__]


@dataclasses.dataclass
class Captured:
    """What ``capture`` returns: one graph per part, in order; the
    seconds from the first warm-up run to the end of the last capture;
    the device memory the captures reserved (their shared pool)."""
    graphs: list
    capture_seconds: float
    pool_bytes: int


def capture(parts: Sequence[Callable[[], None]],
            tensors: Callable[[], dict], counters: Sequence,
            device: torch.device, what: str,
            restore: Optional[Callable[[], None]] = None) -> Captured:
    """Capture each of ``parts`` as its own CUDA graph, in order, all in
    one memory pool, so they must be replayed in that order and never
    two at once. First ``WARMUP_RUNS`` eager runs of all the parts in
    order, on a side stream, then ``restore()`` (when given: it undoes
    what the warm-up wrote, on the current stream), then the captures,
    which launch nothing. ``tensors``, ``counters`` and ``what`` as
    ``CapturedGraph``'s."""
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_RUNS):
            for run in parts:
                run()
    torch.cuda.current_stream(device).wait_stream(side)
    if restore is not None:
        restore()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graphs: list = []
    for run in parts:
        graphs.append(CapturedGraph(
            run, tensors, counters, device, what,
            pool=graphs[0].graph.pool() if graphs else None))
    return Captured(graphs, time.perf_counter() - t0,
                    torch.cuda.memory_reserved(device) - reserved)

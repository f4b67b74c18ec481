"""The training step as CUDA graphs (the port's counterpart of the JAX
trainer's ``precompile``d step executable).

The trainer's step is two bodies over static tensors
(``training/trainer.py``): the micro body (a) runs one micro batch's
forward, ``loss_fn`` and backward, accumulating the gradients into the
parameters' preallocated float32 ``.grad`` and the loss, weight and
metric sums into 0-d tensors, and advances a device-side micro batch
index; the finish body (b) averages, takes the global norm, runs the
optimizer and applies its updates in place, writes the step's outputs
and zeroes the accumulators. ``StepGraph`` captures each body as its own
graph, in one memory pool (``cuda_graph.capture``), and replays (a)
``grad_accum`` times and then (b) once a step: ``grad_accum + 1`` graph
launches where the eager step makes tens of thousands of kernel
launches. Over a world whose collectives run over gloo, a body that
holds a collective is not captured: a gloo collective runs on the host,
which no graph can hold, so it runs eagerly in its turn. (b) always
holds one (``finish_mode`` "eager"; "graph" otherwise: NCCL's
collectives sit inside graph (b)); (a) holds them under ``fsdp``, whose
micro body gathers each layer's weights and reduce-scatters its
gradients, under ``tensor``, whose micro body all-reduces every
block's products, under ``context``, whose attention passes K/V
round the ring or all-to-alls every block's q, k, v and output, and
for an MoE model under ``expert`` or over several batch ranks, whose
MoE layers gather their routing counts and all-reduce their statistics
and outputs (``micro_mode`` "eager" under
gloo; "graph" under ``data`` alone with a dense model, whose micro body
has none, and under NCCL, where the routing collectives sit inside
graph (a) too). With neither body captured
there is no warm-up and no capture: the step runs as ``train_step``
runs it without ``precompile``. Two graphs
rather than one whole-step graph: each holds one
micro batch's work (a capture of the whole step would unroll
``grad_accum`` micro batches into one graph), and the pool holds one
micro batch's activations, which the replays of (a) reuse.

The warm-up before the capture runs both bodies eagerly, which trains:
it accumulates gradients and applies optimizer steps. ``StepGraph``
snapshots every state tensor before it and writes the snapshot back
after it, so capturing leaves the parameters, the optimizer state, the
accumulators and the counts bitwise as they were (the capture itself
launches nothing). The snapshot lies in host memory: on the card it
would double the state (the parameters and their gradient accumulators)
beside the warm-up's activations and the graph's pool.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from kubeflow_tpu_torch.cuda_graph import capture


class StepGraph:
    """``micro`` and ``finish`` (the trainer's two step bodies) captured
    as CUDA graphs on ``device``. ``state()`` names every tensor the
    bodies read or write across steps (parameters, gradients, optimizer
    state, sums, the micro batch index, the staged batch, the outputs):
    the warm-up is undone on them, and each replay checks their
    addresses. ``counters``: the kernel wrappers whose ``.launches`` a
    replay adds to.

    ``capture_micro`` / ``capture_finish`` False leave (a) / (b) eager
    (module docstring); ``micro_mode`` and ``finish_mode`` say which
    ("graph" or "eager").

    ``capture_seconds``, ``pool_bytes`` (device memory the captures
    reserved) and ``launches`` (kernel launches the graphs of one
    replayed step make, per counter; an eager body's launches count
    themselves as it runs) describe the capture; ``replays`` counts
    replayed steps."""

    def __init__(self, micro: Callable[[], None],
                 finish: Callable[[], None], state: Callable[[], dict],
                 grad_accum: int, counters: Sequence,
                 device: torch.device, capture_micro: bool = True,
                 capture_finish: bool = True):
        self.micro, self.finish = micro, finish
        self.micro_mode = "graph" if capture_micro else "eager"
        self.finish_mode = "graph" if capture_finish else "eager"
        self.grad_accum = grad_accum
        self.micro_graph = self.finish_graph = None
        self.capture_seconds, self.pool_bytes = 0.0, 0
        self.launches = {c.__name__: 0 for c in counters}
        self.replays = 0
        if not (capture_micro or capture_finish):
            return
        snapshot = {k: t.detach().to("cpu", copy=True)
                    for k, t in state().items()}

        @torch.no_grad()
        def restore() -> None:
            now = state()
            for k, t in snapshot.items():
                now[k].copy_(t)

        eager = [i for i, c in enumerate((capture_micro, capture_finish))
                 if not c]
        captured = capture([micro, finish], state, counters, device,
                           "the train state's tensors", restore=restore,
                           eager=eager)
        self.micro_graph, self.finish_graph = captured.graphs
        self.capture_seconds = captured.capture_seconds
        self.pool_bytes = captured.pool_bytes
        for graph, times in ((self.micro_graph, grad_accum),
                             (self.finish_graph, 1)):
            if graph is not None:
                for name, n in graph.launches.items():
                    self.launches[name] += times * n

    def replay(self) -> None:
        """One training step on the current stream: (a) ``grad_accum``
        times, then (b), each replayed or run."""
        for _ in range(self.grad_accum):
            if self.micro_graph is not None:
                self.micro_graph.replay()
            else:
                self.micro()
        if self.finish_graph is not None:
            self.finish_graph.replay()
        else:
            self.finish()
        self.replays += 1

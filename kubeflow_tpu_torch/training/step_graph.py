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
launches. Two graphs rather than one whole-step graph: each holds one
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

    ``capture_seconds``, ``pool_bytes`` (device memory the two captures
    reserved) and ``launches`` (kernel launches of one replayed step, per
    counter) describe the capture; ``replays`` counts replayed steps."""

    def __init__(self, micro: Callable[[], None],
                 finish: Callable[[], None], state: Callable[[], dict],
                 grad_accum: int, counters: Sequence,
                 device: torch.device):
        snapshot = {k: t.detach().to("cpu", copy=True)
                    for k, t in state().items()}

        @torch.no_grad()
        def restore() -> None:
            now = state()
            for k, t in snapshot.items():
                now[k].copy_(t)

        captured = capture([micro, finish], state, counters, device,
                           "the train state's tensors", restore=restore)
        self.micro_graph, self.finish_graph = captured.graphs
        self.capture_seconds = captured.capture_seconds
        self.pool_bytes = captured.pool_bytes
        self.grad_accum = grad_accum
        self.launches = {
            name: grad_accum * n + self.finish_graph.launches[name]
            for name, n in self.micro_graph.launches.items()}
        self.replays = 0

    def replay(self) -> None:
        """One training step on the current stream: (a) ``grad_accum``
        times, then (b)."""
        for _ in range(self.grad_accum):
            self.micro_graph.replay()
        self.finish_graph.replay()
        self.replays += 1

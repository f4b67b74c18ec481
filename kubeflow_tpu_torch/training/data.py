"""Data feeding (counterpart of ``kubeflow_tpu.training.data``): the
synthetic LM token stream and MNIST batches, the host -> device
placement of a batch
(``to_device``), and the training step's static batch (``BatchBuffers``).

``synthetic_lm_batches`` draws each step's tokens from the same numpy
generator, seeded by ``[seed, step, process_index]``, as the JAX package,
so both packages see identical tokens. The process index and count come
from ``torch.distributed`` when it is initialised, else 0 and 1; a
world with a ``tensor`` axis passes its place in the batch axes instead
(``shard``), so that tensor peers draw the same rows.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from kubeflow_tpu_torch.cuda_graph import PinnedStaging
from kubeflow_tpu_torch.device import DeviceLike, resolve_device

# byte alignment of each key's tensor inside the packed batch buffer
_ALIGN = 16


def _process_index_and_count() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def synthetic_lm_batches(vocab_size: int, global_batch: int, seq_len: int,
                         seed: int = 0, start_step: int = 0,
                         shard: tuple[int, int] | None = None
                         ) -> Iterator[dict]:
    """Infinite synthetic token batches: {"tokens": [B, S+1] int32} numpy
    arrays on the host.

    Step-indexed: batch ``i`` is a pure function of ``(seed, i, process)``,
    so a resumed job can seek with ``start_step``. Multi-process aware:
    yields only this process's ``global_batch / world_size`` rows, or
    with ``shard=(index, count)`` the rows of place ``index`` of
    ``count`` (``global_batch / count`` rows).
    """
    index, count = shard if shard is not None \
        else _process_index_and_count()
    local = global_batch // count
    step = start_step
    while True:
        rng = np.random.default_rng([seed, step, index])
        yield {"tokens": rng.integers(0, vocab_size, (local, seq_len + 1),
                                      dtype=np.int32)}
        step += 1


def mnist_synthetic(batch: int, seed: int = 0) -> Iterator[dict]:
    """Synthetic MNIST-shaped batches, the JAX package's draws:
    {"image": [B, 28, 28, 1] float32, "label": [B] int32} numpy arrays."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "image": rng.normal(size=(batch, 28, 28, 1)).astype(np.float32),
            "label": rng.integers(0, 10, (batch,), dtype=np.int32),
        }


def to_device(batch: dict, device: DeviceLike = None) -> dict:
    """A host batch (numpy arrays or tensors) -> new tensors on ``device``
    (``device.resolve_device``: CUDA unless ``"cpu"`` is asked for); the
    port's ``put_batch``. Tensors already there are returned as they
    are. A copy from pageable host memory (a numpy array, an unpinned
    tensor) ends in a stream synchronize, so it waits for the device
    work queued before it; the training step stages its batch through
    ``BatchBuffers`` instead, which does not."""
    device = resolve_device(device)
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _spec(value) -> tuple:
    t = torch.as_tensor(value)
    return tuple(t.shape), t.dtype


class BatchBuffers:
    """The training step's static batch on ``device``: one tensor per key
    (``tensors``) of the key set, shapes and dtypes of ``batch`` (a dict
    of numpy arrays or tensors), all views of one packed byte buffer that
    ``stage`` fills by ONE copy from pinned host memory, asynchronously
    (``cuda_graph.PinnedStaging``). A step captured as a CUDA graph reads
    these tensors at every replay."""

    def __init__(self, batch: dict, device: torch.device):
        self.spec = {k: _spec(v) for k, v in batch.items()}
        self._offsets: dict = {}
        size = 0
        for k, (shape, dtype) in self.spec.items():
            self._offsets[k] = size
            nbytes = int(np.prod(shape)) * dtype.itemsize
            size += -(-nbytes // _ALIGN) * _ALIGN
        self._staging = PinnedStaging(size, torch.uint8, device)
        self.tensors = self._views(self._staging.staged)

    def _views(self, buf: torch.Tensor) -> dict:
        out = {}
        for k, (shape, dtype) in self.spec.items():
            off = self._offsets[k]
            n = int(np.prod(shape)) * dtype.itemsize
            out[k] = buf[off:off + n].view(dtype).view(shape)
        return out

    def buffers(self) -> list:
        """Every tensor it keeps (``PinnedStaging.buffers``)."""
        return self._staging.buffers()

    def matches(self, batch: dict) -> bool:
        """Whether ``batch`` has this buffer's keys, shapes and dtypes."""
        return batch.keys() == self.spec.keys() and all(
            _spec(v) == self.spec[k] for k, v in batch.items())

    def stage(self, batch: dict) -> None:
        """Copy ``batch`` (which ``matches``) into ``tensors``: one copy,
        queued on the current stream behind the work already there."""
        def fill(host: torch.Tensor) -> None:
            for k, view in self._views(host).items():
                view.copy_(torch.as_tensor(batch[k]))

        self._staging.stage(fill)

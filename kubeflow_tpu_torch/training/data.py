"""Data feeding (counterpart of ``kubeflow_tpu.training.data``): the
synthetic LM token stream and the host -> device placement of a batch.

``synthetic_lm_batches`` draws each step's tokens from the same numpy
generator, seeded by ``[seed, step, process_index]``, as the JAX package,
so both packages see identical tokens. The process index and count come
from ``torch.distributed`` when it is initialised, else 0 and 1.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device


def _process_index_and_count() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def synthetic_lm_batches(vocab_size: int, global_batch: int, seq_len: int,
                         seed: int = 0,
                         start_step: int = 0) -> Iterator[dict]:
    """Infinite synthetic token batches: {"tokens": [B, S+1] int32} numpy
    arrays on the host.

    Step-indexed: batch ``i`` is a pure function of ``(seed, i, process)``,
    so a resumed job can seek with ``start_step``. Multi-process aware:
    yields only this process's ``global_batch / world_size`` rows.
    """
    index, count = _process_index_and_count()
    local = global_batch // count
    step = start_step
    while True:
        rng = np.random.default_rng([seed, step, index])
        yield {"tokens": rng.integers(0, vocab_size, (local, seq_len + 1),
                                      dtype=np.int32)}
        step += 1


def to_device(batch: dict, device: DeviceLike = None) -> dict:
    """A host batch (numpy arrays or tensors) -> tensors on ``device``
    (``device.resolve_device``: CUDA unless ``"cpu"`` is asked for); the
    port's ``put_batch``. Tensors already there are returned as they
    are."""
    device = resolve_device(device)
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}

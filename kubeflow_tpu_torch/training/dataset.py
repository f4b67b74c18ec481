"""File-backed tokenized corpus: memory-mapped shards, deterministic
shuffle, exact step-indexed resume (a copy of
``kubeflow_tpu.training.dataset``, which needs numpy only; the port keeps
its own so that it imports nothing of the JAX package).

A dataset is a directory of ``*.tokens.npy`` shards (typically a bucket
mounted into the pod), each a 1-D integer array of token ids, with a
``dataset.json`` beside them. Batches are numpy dicts on the host, which
the trainer stages on its device as it stages ``synthetic_lm_batches``.

Resume contract: batch ``i`` is a PURE function of ``(corpus, seq_len,
global_batch, seed, i, process)``. Examples are fixed ``seq_len+1`` windows
(never crossing shard boundaries); each epoch visits every window once in
an epoch-seeded permutation; step ``i`` takes the next ``global_batch``
entries of that infinite stream. ``loop.fit`` checkpoints the trainer step
and calls ``batches(start_step)`` on restore, so a killed-and-resumed job
continues the exact step->batch mapping of an uninterrupted one. The
process index and count come from ``torch.distributed`` when it is
initialised (``training.data``), else 0 and 1.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np

from kubeflow_tpu_torch.training.data import _process_index_and_count

_SHARD_SUFFIX = ".tokens.npy"


def write_token_shards(path: str, tokens, shard_tokens: int = 1 << 22,
                       vocab_size: Optional[int] = None) -> list[str]:
    """Materialize a token stream as a shard directory.

    ``tokens``: any iterable of integer arrays/lists (documents or chunks);
    they are concatenated and split into ``shard_tokens``-sized shards.
    Streaming: at most one shard's worth of tokens is resident at a time,
    so a corpus far larger than host memory can be prepared (matching the
    reader's mmap stance). Returns the shard paths; writes
    ``dataset.json`` metadata alongside.
    """
    os.makedirs(path, exist_ok=True)
    paths: list[str] = []
    pending: list[np.ndarray] = []
    pending_n = total = 0

    def flush(n: int) -> None:
        nonlocal pending, pending_n
        if not pending:
            pending = [np.zeros(0, np.int32)]
        flat = np.concatenate(pending) if len(pending) != 1 else pending[0]
        p = os.path.join(path, f"shard-{len(paths):05d}{_SHARD_SUFFIX}")
        np.save(p, flat[:n])
        paths.append(p)
        rest = flat[n:]
        pending = [rest] if len(rest) else []
        pending_n = len(rest)

    for t in tokens:
        chunk = np.asarray(t, dtype=np.int32).ravel()
        pending.append(chunk)
        pending_n += len(chunk)
        total += len(chunk)
        while pending_n >= shard_tokens:
            flush(shard_tokens)
    if pending_n or not paths:
        flush(pending_n)
    with open(os.path.join(path, "dataset.json"), "w") as f:
        json.dump({"total_tokens": total,
                   "shards": len(paths),
                   "vocab_size": vocab_size}, f)
    return paths


class TokenDataset:
    """Memory-mapped reader over a token-shard directory.

    Shards are opened with ``mmap_mode='r'`` — no shard is ever resident in
    host RAM beyond the pages a batch touches, so a corpus far larger than
    memory streams at page-cache speed (the mounted-bucket read path).
    """

    def __init__(self, path: str, seq_len: int, seed: int = 0):
        names = sorted(n for n in os.listdir(path)
                       if n.endswith(_SHARD_SUFFIX))
        if not names:
            raise FileNotFoundError(
                f"no {_SHARD_SUFFIX} shards under {path!r}")
        self.path = path
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        self._shards = [np.load(os.path.join(path, n), mmap_mode="r")
                        for n in names]
        # fixed windows of seq_len+1 tokens (inputs + shifted targets),
        # never crossing a shard boundary: window w of shard s starts at
        # w*seq_len, so consecutive windows share one boundary token —
        # every token is trained on exactly once per epoch
        self._per_shard = [max(0, (len(s) - 1) // self.seq_len)
                           for s in self._shards]
        self._cum = np.cumsum([0] + self._per_shard)
        self.n_windows = int(self._cum[-1])
        if self.n_windows == 0:
            raise ValueError(
                f"corpus too small: no shard holds seq_len+1="
                f"{self.seq_len + 1} tokens")
        self._perm_cache: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------ reads --

    def window(self, idx: int) -> np.ndarray:
        """Window ``idx`` -> int32 [seq_len+1]."""
        s = int(np.searchsorted(self._cum, idx, side="right") - 1)
        off = (idx - self._cum[s]) * self.seq_len
        return np.asarray(
            self._shards[s][off:off + self.seq_len + 1], dtype=np.int32)

    def _perm(self, epoch: int) -> np.ndarray:
        """Epoch-seeded shuffle; tiny LRU since training only ever touches
        the current epoch (plus its neighbor at an epoch boundary)."""
        p = self._perm_cache.get(epoch)
        if p is None:
            p = np.random.default_rng(
                [self.seed, epoch]).permutation(self.n_windows)
            self._perm_cache[epoch] = p
            for k in sorted(self._perm_cache):
                if len(self._perm_cache) <= 4:
                    break
                del self._perm_cache[k]
        return p

    def window_ids_for_step(self, step: int, global_batch: int) -> np.ndarray:
        """The global window ids batch ``step`` consumes — the pure
        step->batch mapping the resume contract is built on."""
        first = step * global_batch
        idx = np.arange(first, first + global_batch)
        epochs = idx // self.n_windows
        pos = idx % self.n_windows
        return np.array([self._perm(int(e))[int(p)]
                         for e, p in zip(epochs, pos)])

    def state(self, step: int, global_batch: int) -> dict:
        """Observability: where step ``step`` sits in the epoch stream."""
        consumed = step * global_batch
        return {"epoch": consumed // self.n_windows,
                "position": consumed % self.n_windows,
                "seed": self.seed, "n_windows": self.n_windows}

    # ---------------------------------------------------------- batches --

    def batches(self, global_batch: int,
                start_step: int = 0,
                prefetch: int = 2) -> Iterator[dict]:
        """Infinite step-indexed batch stream: {"tokens": [local, S+1]}.

        Multi-host aware like ``synthetic_lm_batches``: each process yields
        its contiguous slice of the global batch. Pass this (wrapped in a
        lambda taking start_step) as ``loop.fit``'s ``batches`` callable —
        the preferred seekable form of the data-resume contract.

        ``prefetch`` batches are assembled AHEAD by a background producer
        thread (double-buffered: window gathers + np.stack overlap the
        train step instead of serializing with it). ``prefetch=0`` is the
        old synchronous path. Ordering and SIGKILL-exact resume are
        untouched either way: batch ``i`` stays a pure function of
        ``(corpus, seq_len, global_batch, seed, i, process)`` — the thread
        only changes WHEN assembly happens, never WHAT step ``i`` yields.
        """
        index, n_proc = _process_index_and_count()
        if global_batch % n_proc:
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"{n_proc} processes")
        local = global_batch // n_proc
        lo = index * local

        def assemble(step: int) -> dict:
            ids = self.window_ids_for_step(
                step, global_batch)[lo:lo + local]
            return {"tokens": np.stack(
                [self.window(int(i)) for i in ids])}

        if prefetch <= 0:
            step = start_step
            while True:
                yield assemble(step)
                step += 1

        import queue
        import threading

        q: "queue.Queue[tuple]" = queue.Queue(maxsize=int(prefetch))
        stop = threading.Event()

        def produce() -> None:
            step = start_step
            while not stop.is_set():
                try:
                    item = ("ok", assemble(step))
                except BaseException as e:  # propagate, don't die silently
                    item = ("err", e)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if item[0] == "err":
                    return
                step += 1

        t = threading.Thread(target=produce, daemon=True,
                             name="kft-dataset-prefetch")
        t.start()
        try:
            while True:
                kind, val = q.get()
                if kind == "err":
                    raise val
                yield val
        finally:
            stop.set()      # generator closed: release the producer

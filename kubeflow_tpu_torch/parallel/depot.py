"""The executable depot's env contract in the PyTorch port (a trimmed
counterpart of ``kubeflow_tpu.parallel.depot``).

The JAX package's depot ships a serialized XLA executable between
processes: the first gang worker compiles and publishes it, the others
fetch and deserialize. Its rule is that "the depot is a pure fast path,
never a failure mode": a program that cannot be serialized is compiled
locally, counted as ``serialize_failures``, and the outcome is
``"compiled"``.

The port's captured programs are CUDA graphs, and a CUDA graph cannot be
serialized to another process. So under ``KFT_DEPOT`` every port program
takes that path of the reference: the caller captures locally, exactly
as it does without a depot, and ``local_capture`` counts one compile and
one serialize failure and returns ``"compiled"``. The port never reads or
writes the store the env names, and ``KFT_DEPOT_WAIT_S`` is unused: no
follower ever waits on a publish that cannot come.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Mapping, Optional

logger = logging.getLogger(__name__)

SERIALIZE_REASON = "a CUDA graph cannot be serialized to another process"

_logged = threading.Event()


class DepotStats:
    """Thread-safe monotonic counters of one worker's depot traffic, with
    the reference's fields (the operator folds them into its
    ``kft_depot_*`` metrics). The port only ever counts ``compiles`` and
    ``serialize_failures``."""

    FIELDS = (
        "hits",                  # executable fetched + deserialized
        "cache_hits",            # served from the pod-local cache dir
        "misses",                # no entry yet (leads to a compile)
        "compiles",              # local compiles (here: captures) paid
        "publishes",             # entries this worker published first
        "publish_races",         # lost the publish race (entry appeared)
        "deserialize_failures",  # corrupt blob / platform can't load
        "fingerprint_mismatches",  # entry keyed right, built wrong (skew)
        "serialize_failures",    # this platform can't serialize
        "error_entries",         # fetched a tombstone
        "fetch_errors",          # transport errors (depot unreachable)
        "wait_timeouts",         # follower gave up waiting for the publish
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self.FIELDS}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + by

    def snapshot(self) -> dict:
        with self._lock:
            return {k: v for k, v in self._c.items() if v}


@dataclasses.dataclass(frozen=True)
class DepotHandle:
    """What ``KFT_DEPOT`` names: a directory or an http(s) URL, with the
    token and the pod-local cache directory beside it. Nothing is read
    from or written to it."""
    target: str
    token: str = ""
    cache: str = ""


def depot_from_env(env: Optional[Mapping[str, str]] = None,
                   stats: Optional[DepotStats] = None
                   ) -> Optional[DepotHandle]:
    """The worker-side env contract: ``KFT_DEPOT`` (directory or URL),
    ``KFT_DEPOT_TOKEN``, ``KFT_DEPOT_CACHE``. None when no depot is set.
    ``stats`` is accepted for the reference's signature; naming a depot
    touches nothing, so nothing can fail here."""
    env = os.environ if env is None else env
    target = env.get("KFT_DEPOT")
    if not target:
        return None
    return DepotHandle(target, env.get("KFT_DEPOT_TOKEN", ""),
                       env.get("KFT_DEPOT_CACHE", ""))


def local_capture(depot: Optional[DepotHandle],
                  stats: Optional[DepotStats]) -> str:
    """The depot outcome of a program the caller has just captured
    locally: ``"no_depot"`` without a depot; with one, ``compiles`` and
    ``serialize_failures`` each counted once in ``stats`` and
    ``"compiled"``, the reference's outcome for a program its platform
    cannot serialize. The reason is logged once per process."""
    if depot is None:
        return "no_depot"
    if stats is not None:
        stats.inc("compiles")
        stats.inc("serialize_failures")
    if not _logged.is_set():
        _logged.set()
        logger.warning("KFT_DEPOT=%s: captured locally, not published "
                       "(%s)", getattr(depot, "target", depot),
                       SERIALIZE_REASON)
    return "compiled"

"""Tensor-parallel serving across processes: rank 0's dispatch and the
other ranks' loop. The JAX package has no counterpart: its engine is one
program over the mesh. Here each rank is a process (``parallel.mesh``).

Rank 0 runs the whole engine on the host: scheduler, radix cache, block
allocator, model and HTTP server. Ranks 1..tp-1 build the same
``LLMEngine`` on their shard and then only wait. Before each device body
(``LLMEngine._body_<name>``) rank 0 sends the body's name and its host
inputs (numpy arrays and Python scalars, nothing else) and runs the body
itself; every rank runs it on its shard, so the model's collectives meet
in lockstep. Then every rank answers on the mesh's ack group: rank 0
raises when a rank died or did not answer within the mesh's timeout,
never waits on it for ever. A rank whose body raises prints the
traceback and exits, which fails rank 0's next collective at once.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Any, Callable

STOP = "stop"
STATUS = "status"          # per-rank counters and identity (status())
PING = "ping"              # an empty round trip (Workers.ping)


def launch(mesh, params, cfg, engine_kwargs: dict) -> "Workers":
    """Rank 0: spawn ranks 1..tp-1, each building
    ``LLMEngine(params, cfg, mesh=<its rank>, **engine_kwargs)`` and then
    serving rank 0's commands; join the mesh as rank 0."""
    procs = mesh.launch(_serve, (params, cfg, engine_kwargs))
    return Workers(mesh, procs)


class Workers:
    """Rank 0's handle on the other ranks."""

    def __init__(self, mesh, procs):
        self.mesh = mesh
        self.procs = procs
        # one command at a time: the engine's stepping thread and a caller
        # of a public engine method may both dispatch
        self._lock = threading.Lock()

    def _failed(self, name: str, err: BaseException) -> RuntimeError:
        dead = [(i + 1, p.exitcode) for i, p in enumerate(self.procs)
                if p.exitcode is not None]
        what = (f"rank(s) {dead} exited (rank, exit code)" if dead
                else f"a rank did not answer ({err})")
        return RuntimeError(f"tensor-parallel serving failed in {name!r}: "
                            f"{what}")

    def run(self, name: str, host: dict, body: Callable) -> Any:
        """Send ``name`` + ``host`` to every rank, run ``body(**host)``
        here, wait for every rank's answer; returns rank 0's result."""
        with self._lock:
            try:
                self.mesh.send_command((name, host))
                out = body(**host)
                self.mesh.gather_answers(None)
            except RuntimeError as e:
                raise self._failed(name, e) from e
        return out

    def status(self, engine, reset_launches: bool = False) -> list:
        """``status()`` of every rank, in rank order."""
        host = {"reset_launches": reset_launches}
        with self._lock:
            try:
                self.mesh.send_command((STATUS, host))
                return self.mesh.gather_answers(status(engine, **host))
            except RuntimeError as e:
                raise self._failed(STATUS, e) from e

    def ping(self) -> None:
        """An empty command to every rank and every rank's answer: the
        round trip that each device body's dispatch adds."""
        with self._lock:
            try:
                self.mesh.send_command((PING, {}))
                self.mesh.gather_answers(None)
            except RuntimeError as e:
                raise self._failed(PING, e) from e

    def close(self, timeout: float = 30.0) -> None:
        """Stop and join the other ranks, then leave the mesh."""
        with self._lock:
            try:
                if all(p.is_alive() for p in self.procs):
                    self.mesh.send_command((STOP, {}))
            except RuntimeError:
                pass                # a rank is gone: nothing to stop there
        for p in self.procs:
            p.join(timeout)
            if p.is_alive():
                p.kill()
                p.join()
        self.mesh.shutdown()


def status(engine, reset_launches: bool = False) -> dict:
    """This rank's identity, kernel launch counts (reset after reading
    when asked), sampling bodies and running digest of the tokens it
    sampled (equal on every rank when the ranks agree), and the
    top-level packages its process has imported."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    kernels = (pa.paged_decode_attention, pa.paged_decode_attention_quant)
    out = {"rank": engine.mesh.rank, "pid": os.getpid(),
           "device": str(engine.device),
           "kv_heads": int(engine.cache["k"].shape[3]),
           "launches": {k.__name__: k.launches for k in kernels},
           "samples": engine.tp_samples,
           "token_digest": int(engine._token_digest),
           "packages": sorted({m.split(".")[0] for m in sys.modules})}
    if reset_launches:
        for k in kernels:
            k.launches = 0
    return out


def _serve(mesh, params, cfg, engine_kwargs: dict) -> None:
    """Ranks 1..: build the rank's engine, then run rank 0's commands
    until told to stop."""
    from kubeflow_tpu_torch.serving.llm import LLMEngine

    try:
        engine = LLMEngine(params, cfg, mesh=mesh, **engine_kwargs)
        while True:
            name, host = mesh.recv_command()
            if name == STOP:
                return
            if name == STATUS:
                mesh.gather_answers(status(engine, **host))
                continue
            if name == PING:
                mesh.gather_answers(None)
                continue
            getattr(engine, "_body_" + name)(**host)
            mesh.gather_answers(None)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)          # rank 0's next collective fails at once

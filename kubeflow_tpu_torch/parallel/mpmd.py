"""MPMD pipeline parallelism in the PyTorch port (counterpart of
``kubeflow_tpu.parallel.mpmd``): each stage is its own program in its
own process (or thread), activations and their gradients move stage to
stage over an explicit point-to-point transport, and a schedule (GPipe's
fill-drain, 1F1B, interleaved 1F1B) drives each stage's tick order.

The SPMD pipeline (``parallel/pipeline.py``) keeps every stage in one
world of processes joined by collectives; this runtime needs no
collective at all, only the stage-to-stage frames. It is the oracle's
subject: ``run_oracle`` trains the same model through
``pipeline.pipeline_apply`` over ``total_stages`` gloo processes.

Parts, as the reference's:

- ``PipelineRunConfig``: one run (stages, micro batches, the harness
  MLP's width and depth, steps, lr, schedule, virtual stages).
- The harness model: ``mlp_stage_fn`` (the chunk's layers of ``tanh(h @
  w + b)``), ``init_stage_params``, ``init_head_params``, ``step_batch``,
  ``head_loss``, behind ``MLPSpec``.
- Schedules: ``schedule_ticks``, ``interleaved_stash_bound``,
  ``max_live_stash``, pure Python, identical to the reference's.
- Transport: ``TCPStageChannel`` (loopback or any TCP route; blocking
  sends on the compute thread, or async ones through a sender thread
  per peer, whose failure poisons the mailbox; ``barrier_ready``;
  ``drain_stale``) and ``InProcFabric`` / ``InProcChannel`` (threads as
  stages). Frames are host-staged: numpy arrays, pickled, keyed
  ``(kind, step, mb, vstage, epoch)``.
- ``StageRuntime``: a worker's chunks, their per-tick programs and
  parameters on its device; ``run_stage``: one worker's steps;
  ``run_inproc``: every stage a thread; ``aggregate_stats`` and
  ``analytic_bubble_bound``: the measured bubble and overlap beside the
  fill-drain bound.

The per-tick programs run eagerly: ``fwd`` under ``torch.no_grad()``;
``bwd`` recomputes the chunk from the stashed ``x`` and pulls ``dy``
back with ``torch.autograd.grad`` (the reference's ``jax.vjp``),
returning ``(g, dx)``, or ``(g, None)`` for a first chunk whose input
takes no gradient; ``head`` returns ``(loss, g_head, dy)``.
``depot_summary`` reports each program's outcome through
``parallel.depot.local_capture``'s counters under the reference's keys.

The numerics contract: gradients are stashed per ``(chunk, micro
batch)`` slot and reduced in one fixed descending order by the same
add, and the update is plain SGD ``p - lr * g``, so GPipe, 1F1B and
interleaved 1F1B over one ``total_stages`` partition give bitwise equal
losses. On a card each stage thread of ``run_inproc`` has its own CUDA
stream, every program ends in a synchronize of it (so busy time is
device time), and ``get_act`` copies to the host only after the
stream's work is done.

Random draws come from a ``torch.Generator`` seeded from ``(seed,
chunk)`` (parameters, on the device) and ``(seed + 100003, step)``
(batches, on the host), so every process derives the same values with
no data channel. They cannot be JAX's; ``MLPSpec`` takes given arrays
instead (``interop.mpmd_mlp_from_jax``).

One accounting differs from the reference's: the barrier's ready and
go frames are not counted in ``TransportStats`` (the reference counts
them as wire time, and the first send of a stage whose peer is still
starting then waits out its connect retries inside ``wire_s``, so a
blocking run's DCN overlap read up to 0.97 on two CPU processes instead
of ~0). Activation and gradient frames are counted as the reference
counts them.

The elastic half of the reference (``ElasticStats``, ``EpochBump``,
``StageSnapshotStore``, ``run_fingerprint``, the resume hooks of
``run_stage``) and the stage pod (``_worker_main``) are not ported
yet; the frames keep the epoch element, always the channel's own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import pickle
import queue
import shutil
import socket
import struct
import tempfile
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.parallel.depot import DepotStats, local_capture

# ----------------------------------------------------------- config --


@dataclasses.dataclass
class PipelineRunConfig:
    """One MPMD pipeline training run (the harness model is a stacked
    tanh-MLP per stage + a linear regression head on the last stage;
    ``stage_fn`` has the same contract as ``pipeline_apply``'s, so the
    schedule/transport layer is generic)."""

    n_stages: int = 2
    microbatches: int = 4
    global_batch: int = 64
    dim: int = 128
    layers_per_stage: int = 2         # layers per CHUNK (= per stage at V=1)
    steps: int = 4
    lr: float = 0.05
    seed: int = 0
    schedule: str = "1f1b"            # "gpipe" | "1f1b" | "interleaved-1f1b"
    dcn_delay_ms: float = 0.0         # emulated per-transfer DCN latency
    virtual_stages: int = 1           # V chunks per worker (interleaved)

    @property
    def mb_rows(self) -> int:
        return self.global_batch // self.microbatches

    @property
    def total_stages(self) -> int:
        """Global model-chunk count: worker r owns chunks r, r+S, ...,
        r+(V-1)S. The model partition (and the oracle's pipeline depth)
        is over total_stages, not workers."""
        return self.n_stages * self.virtual_stages

    def validate(self) -> None:
        if self.n_stages < 2:
            raise ValueError("MPMD pipeline needs >= 2 stages")
        if self.global_batch % self.microbatches:
            raise ValueError("global_batch must divide by microbatches")
        if self.schedule not in ("gpipe", "1f1b", "interleaved-1f1b"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.virtual_stages < 1:
            raise ValueError("virtual_stages must be >= 1")
        if self.schedule == "interleaved-1f1b":
            if self.virtual_stages < 2:
                raise ValueError(
                    "interleaved-1f1b needs virtual_stages >= 2 "
                    "(V=1 is plain 1f1b)")
            if self.microbatches % self.n_stages:
                raise ValueError(
                    "interleaved-1f1b needs microbatches % n_stages == 0 "
                    "(microbatch groups of size S keep the ring full)")
        elif self.virtual_stages != 1:
            raise ValueError(
                f"virtual_stages={self.virtual_stages} requires the "
                "interleaved-1f1b schedule")

    @classmethod
    def from_env(cls, env=None) -> "PipelineRunConfig":
        env = os.environ if env is None else env
        g = lambda k, d: env.get(f"KFT_MPMD_{k}", d)
        return cls(
            n_stages=int(env.get("KFT_NUM_STAGES", "2")),
            microbatches=int(g("MICROBATCHES", "4")),
            global_batch=int(g("BATCH", "64")),
            dim=int(g("DIM", "128")),
            layers_per_stage=int(g("LAYERS", "2")),
            steps=int(g("STEPS", "4")),
            lr=float(g("LR", "0.05")),
            seed=int(g("SEED", "0")),
            schedule=g("SCHEDULE", "1f1b"),
            dcn_delay_ms=float(g("DCN_DELAY_MS", "0")),
            virtual_stages=int(env.get("KFT_VIRTUAL_STAGES", "1")),
        )


# ------------------------------------------------------- harness model --

def mlp_stage_fn(stage_params: dict, x: torch.Tensor) -> torch.Tensor:
    """One pipeline chunk: its ``layers_per_stage`` tanh-MLP layers in
    order. Same (params, x) -> y contract as pipeline_apply's stage_fn;
    x and y share a shape (the inter-stage activation contract)."""
    h = x
    for w, b in zip(stage_params["w"].unbind(0), stage_params["b"].unbind(0)):
        h = torch.tanh(h @ w + b)
    return h


def _generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key``."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(seed)


def init_stage_params(cfg: PipelineRunConfig, stage: int,
                      device: DeviceLike = None) -> dict:
    """Deterministic per-chunk params on ``device``: every process (stage
    workers, the SPMD oracle) derives the same values from (seed,
    chunk)."""
    dev = resolve_device(device)
    g = _generator(dev, cfg.seed, stage)
    L, D = cfg.layers_per_stage, cfg.dim
    w = torch.randn((L, D, D), generator=g, device=dev) * (0.5 / math.sqrt(D))
    return {"w": w, "b": torch.zeros((L, D), device=dev)}


def init_head_params(cfg: PipelineRunConfig,
                     device: DeviceLike = None) -> dict:
    """The regression head, keyed off the model-chunk count: an
    interleaved run and a plain run over the same total_stages partition
    share one head (the bitwise contract)."""
    dev = resolve_device(device)
    g = _generator(dev, cfg.seed, cfg.total_stages + 17)
    return {"w": torch.randn((cfg.dim, 1), generator=g, device=dev)
            * (1.0 / math.sqrt(cfg.dim))}


def step_batch(cfg: PipelineRunConfig, step: int) -> tuple:
    """Host-side (x [B, D], targets [B, 1]) float32 numpy for one step —
    derived from (seed + 100003, step) so stage 0 (inputs) and the last
    stage (targets) agree without any data channel between them."""
    g = _generator(torch.device("cpu"), cfg.seed + 100003, step)
    x = torch.randn((cfg.global_batch, cfg.dim), generator=g)
    t = torch.randn((cfg.global_batch, 1), generator=g)
    return x.numpy(), t.numpy()


def head_loss(head_params: dict, y: torch.Tensor, targets: torch.Tensor,
              *, microbatches: int) -> torch.Tensor:
    """Per-MICROBATCH loss term: mean squared error over the microbatch,
    pre-scaled by 1/M so the per-step total (sum over microbatches)
    equals the full-batch mean-of-means — decomposable per microbatch,
    which is what lets 1F1B start backward before later forwards exist."""
    return torch.mean((y @ head_params["w"] - targets) ** 2) / microbatches


# ------------------------------------------------------------ schedule --

def schedule_ticks(schedule: str, n_stages: int, stage: int,
                   microbatches: int, virtual_stages: int = 1) -> list:
    """The per-stage tick order. GPipe: fill-drain (all forwards, then
    all backwards — activation stash grows to M). 1F1B: (S-1-s) warmup
    forwards, then strict one-forward-one-backward, then drain — the
    stash never exceeds S live microbatches.

    GPipe/1F1B tick = (phase, mb). ``interleaved-1f1b`` tick =
    (phase, vchunk, mb): worker ``stage`` cycles its V chunks in
    microbatch GROUPS of size S (the Megatron interleave — unit k
    forwards chunk (k % (S*V)) // S, microbatch (k // (S*V))*S + k % S;
    backward units mirror the chunk index), after a warmup of
    (S-stage-1)*2 + (V-1)*S forward units. Backward unit order is the
    exact reverse-chunk mirror of forward order, so every chunk's
    microbatch grads still land in slots reduced in ONE descending
    order."""
    M = microbatches
    if schedule == "gpipe":
        return ([("fwd", i) for i in range(M)]
                + [("bwd", i) for i in reversed(range(M))])
    if schedule == "interleaved-1f1b":
        S, V = n_stages, virtual_stages
        if V < 2:
            raise ValueError("interleaved-1f1b needs virtual_stages >= 2")
        if M % S:
            raise ValueError(
                "interleaved-1f1b needs microbatches % n_stages == 0")
        total = M * V

        def fwd_unit(k: int) -> tuple[int, int]:
            return (k % (S * V)) // S, (k // (S * V)) * S + k % S

        def bwd_unit(k: int) -> tuple[int, int]:
            v, mb = fwd_unit(k)
            return V - 1 - v, mb

        warm = min((S - stage - 1) * 2 + (V - 1) * S, total)
        ticks = [("fwd", *fwd_unit(k)) for k in range(warm)]
        for i in range(total - warm):
            ticks.append(("fwd", *fwd_unit(warm + i)))
            ticks.append(("bwd", *bwd_unit(i)))
        ticks.extend(("bwd", *bwd_unit(i))
                     for i in range(total - warm, total))
        return ticks
    warm = min(n_stages - 1 - stage, M)
    ticks = [("fwd", i) for i in range(warm)]
    done = 0
    for i in range(warm, M):
        ticks.append(("fwd", i))
        ticks.append(("bwd", done))
        done += 1
    ticks.extend(("bwd", i) for i in range(done, M))
    return ticks


def interleaved_stash_bound(n_stages: int, stage: int, microbatches: int,
                            virtual_stages: int) -> int:
    """Analytic peak chunk-activation stash for one worker under
    interleaved-1F1B: the warmup depth plus the in-flight steady-state
    forward (each unit is one CHUNK's activation, 1/V of a plain
    stage's)."""
    S, V, M = n_stages, virtual_stages, microbatches
    return min((S - stage - 1) * 2 + (V - 1) * S + 1, M * V)


def max_live_stash(ticks: list) -> int:
    """Peak number of forward activations resident between their fwd and
    bwd ticks — the schedule's activation-memory footprint (in CHUNK
    activations for the interleaved schedule's 3-field ticks)."""
    live, peak = 0, 0
    for t in ticks:
        live += 1 if t[0] == "fwd" else -1
        peak = max(peak, live)
    return peak


# ----------------------------------------------------------- transport --

class TransportStats:
    """Per-stage wire accounting (thread-safe): ``wire_s`` is time spent
    actually moving bytes (serialize + emulated DCN delay + socket write),
    wherever it ran; ``send_block_s`` is the part that blocked the
    COMPUTE thread — the exposed, un-overlapped cost. recv_block_s is
    time the compute thread waited for data not yet arrived (schedule
    fill/drain shows up here, not in send accounting)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.wire_s = 0.0
        self.send_block_s = 0.0
        self.recv_block_s = 0.0
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.sends = 0
        self.recvs = 0

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "wire_s": round(self.wire_s, 6),
                "send_block_s": round(self.send_block_s, 6),
                "recv_block_s": round(self.recv_block_s, 6),
                "bytes_sent": self.bytes_sent,
                "bytes_recv": self.bytes_recv,
                "sends": self.sends, "recvs": self.recvs,
            }


class _Mailbox:
    """Keyed rendezvous for incoming frames: readers block per key.

    ``poison`` fails every current and future ``take`` immediately with
    the given cause — how a background sender thread's transport error
    reaches the compute thread promptly instead of surfacing two
    minutes later as an opaque recv timeout."""

    def __init__(self):
        self._lock = threading.Condition()
        self._box: dict[tuple, Any] = {}
        self._poison: Optional[BaseException] = None

    def put(self, key: tuple, value) -> None:
        with self._lock:
            self._box[key] = value
            self._lock.notify_all()

    def poison(self, exc: BaseException) -> None:
        with self._lock:
            if self._poison is None:
                self._poison = exc
            self._lock.notify_all()

    def drain(self) -> list:
        """Pop every parked frame key."""
        with self._lock:
            keys = list(self._box)
            self._box.clear()
            return keys

    def take(self, key: tuple, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while key not in self._box:
                if self._poison is not None:
                    raise RuntimeError(
                        "stage transport failed") from self._poison
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"no message {key!r} in {timeout_s}s")
                self._lock.wait(left)
            return self._box.pop(key)


def _encode(key: tuple, payload) -> bytes:
    body = pickle.dumps((key, payload), protocol=4)
    return struct.pack(">Q", len(body)) + body


class _Counts:
    """The channel's fault counters (thread-safe): ``recv_timeouts``,
    ``mailbox_poisons`` and ``stale_frames_fenced``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {"recv_timeouts": 0, "mailbox_poisons": 0,
                   "stale_frames_fenced": 0}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


class TCPStageChannel:
    """Point-to-point activation/grad transport for ONE stage process.

    Listens on ``bind``; neighbors connect lazily (with retry — gang
    members come up in any order). ``blocking=True`` sends inline on the
    compute thread (the GPipe baseline: wire time is exposed);
    ``blocking=False`` hands frames to a per-peer sender thread (1F1B:
    wire time overlaps the next tick's compute). ``delay_s`` emulates a
    DCN per-transfer latency on loopback — it sleeps in whichever thread
    carries the wire, so blocking/async expose/hide it exactly like real
    link time. Spans: every wire movement records a ``dcn.transfer``
    span into ``collector`` when one is given. Frames from another
    ``epoch`` are dropped at ingress and counted in ``counts``."""

    def __init__(self, bind: str, *, prev: Optional[str], next: Optional[str],
                 stage: int, blocking: bool = True, delay_s: float = 0.0,
                 collector=None, timeout_s: float = 120.0,
                 wrap_next: Optional[str] = None,
                 wrap_prev: Optional[str] = None, epoch: int = 0):
        self.stage = stage
        self.prev_addr = prev
        self.next_addr = next
        # interleaved ring closure: the LAST worker forwards chunk
        # r+vS -> chunk (v+1)S on worker 0 over wrap_next; worker 0
        # returns grad-activations over wrap_prev. None on plain runs.
        self.wrap_next_addr = wrap_next
        self.wrap_prev_addr = wrap_prev
        self.blocking = blocking
        self.delay_s = delay_s
        self.timeout_s = timeout_s
        self.collector = collector
        self.epoch = epoch
        self.counts = _Counts()
        self.stats = TransportStats()
        self.mailbox = _Mailbox()
        self._conns: dict[str, socket.socket] = {}
        self._conn_lock = threading.Lock()
        self._send_locks: dict[str, threading.Lock] = {}
        self._senders: dict[str, queue.Queue] = {}
        self._sender_threads: list[threading.Thread] = []
        self._barrier_done = threading.Event()
        # accepted inbound conns: close() shuts these down too, so a
        # peer's cached outbound socket gets the FIN/RST that makes it
        # evict and redial instead of writing into a dead read loop
        self._accepted: list[socket.socket] = []
        self._closed = threading.Event()
        host, _, port = bind.rpartition(":")
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._srv.bind((host or "127.0.0.1", int(port)))
        except OSError:
            # kube contract: the bind address is the stage SERVICE address
            # (a DNS name routing to this pod) — a pod cannot bind() the
            # service VIP, it binds the PORT on all interfaces and the
            # Service routes to it
            self._srv.bind(("0.0.0.0", int(port)))
        self._srv.listen(8)
        bound_host = self._srv.getsockname()[0]
        self.address = (f"{host or '127.0.0.1'}"
                        f":{self._srv.getsockname()[1]}"
                        if bound_host == "0.0.0.0"
                        else f"{bound_host}:{self._srv.getsockname()[1]}")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"mpmd-accept-{stage}")
        self._accept_thread.start()

    # --------------------------------------------------------- wire in --

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._conn_lock:
                self._accepted.append(conn)
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True,
                             name=f"mpmd-read-{self.stage}").start()

    def _read_loop(self, conn: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                head = self._read_exact(conn, 8)
                if head is None:
                    return
                (n,) = struct.unpack(">Q", head)
                body = self._read_exact(conn, n)
                if body is None:
                    return
                key, payload = pickle.loads(body)
                self.stats.add(bytes_recv=8 + n, recvs=1)
                # epoch fence: a frame of another incarnation is dropped
                # and counted here, so it can never satisfy a take
                if (key[4] if len(key) > 4 else 0) != self.epoch:
                    self.counts.inc("stale_frames_fenced")
                    continue
                if key[0] == "ready" and self._barrier_done.is_set():
                    # a late duplicate ready: answer it with a go, in
                    # case the first go was lost with an old connection
                    try:
                        if self.next_addr:
                            self._wire_send(
                                self.next_addr,
                                ("go", -1, -1, -1, self.epoch), b"",
                                counted=False)
                    except Exception:
                        pass
                    continue
                self.mailbox.put(key, payload)
        except (OSError, pickle.UnpicklingError, EOFError):
            return

    @staticmethod
    def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    # -------------------------------------------------------- wire out --

    def _connect(self, peer: str) -> socket.socket:
        with self._conn_lock:
            s = self._conns.get(peer)
            if s is not None:
                return s
        host, _, port = peer.rpartition(":")
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                s = socket.create_connection((host, int(port)), timeout=5.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"stage {self.stage}: peer {peer} unreachable "
                        f"after {self.timeout_s}s")
                time.sleep(0.05)
        with self._conn_lock:
            self._conns.setdefault(peer, s)
            return self._conns[peer]

    def _peer_lock(self, peer: str) -> threading.Lock:
        with self._conn_lock:
            return self._send_locks.setdefault(peer, threading.Lock())

    def _wire_send(self, peer: str, key: tuple, payload,
                   counted: bool = True) -> None:
        """The actual wire movement — serialize, emulated DCN latency,
        socket write. Runs on the compute thread (blocking) or a sender
        thread (async); ``wire_s`` counts it either way, unless the frame
        is the barrier's (``counted=False``: its time is the wait for a
        peer to come up, not traffic). A per-peer lock serializes writers
        (barrier resends and the read loop's go replies can race the
        sender thread); a send failure evicts the cached conn and redials
        ONCE."""
        t0 = time.perf_counter()
        span = None
        if self.collector is not None:
            attrs = {"stage": self.stage, "peer": peer, "kind": key[0],
                     "step": key[1], "mb": key[2]}
            if len(key) > 3:
                attrs["vstage"] = key[3]
            span = self.collector.start("dcn.transfer", attrs=attrs)
        data = _encode(key, payload)
        if self.delay_s:
            time.sleep(self.delay_s)
        with self._peer_lock(peer):
            try:
                self._connect(peer).sendall(data)
            except OSError:
                with self._conn_lock:
                    s = self._conns.pop(peer, None)
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                self._connect(peer).sendall(data)
        if counted:
            self.stats.add(wire_s=time.perf_counter() - t0,
                           bytes_sent=len(data), sends=1)
        if span is not None:
            self.collector.end(span, bytes=len(data))

    def _sender_loop(self, peer: str, q: "queue.Queue") -> None:
        while True:
            item = q.get()
            if item is None:
                return
            try:
                self._wire_send(peer, *item)
            except Exception as e:
                if self._closed.is_set():
                    return
                # surface the transport failure to the compute thread NOW
                # (its next recv raises with this cause) instead of dying
                # silently and leaving it to a recv timeout
                self.counts.inc("mailbox_poisons")
                self.mailbox.poison(e)
                return

    def _send(self, peer: str, key: tuple, payload) -> None:
        if self.blocking:
            t0 = time.perf_counter()
            self._wire_send(peer, key, payload)
            self.stats.add(send_block_s=time.perf_counter() - t0)
            return
        q = self._senders.get(peer)
        if q is None:
            q = self._senders[peer] = queue.Queue()
            t = threading.Thread(target=self._sender_loop, args=(peer, q),
                                 daemon=True,
                                 name=f"mpmd-send-{self.stage}")
            t.start()
            self._sender_threads.append(t)
        t0 = time.perf_counter()
        q.put((key, payload))
        self.stats.add(send_block_s=time.perf_counter() - t0)  # ~enqueue

    # ------------------------------------------------------------- api --
    # Frames key by (kind, step, mb, virtual_stage, epoch): vstage so the
    # same microbatch crossing the same worker V times (interleaved)
    # never aliases. ``wrap=True`` routes over the ring-closure link
    # instead of the line neighbor.

    def send_act(self, step: int, mb: int, payload, vstage: int = 0, *,
                 wrap: bool = False) -> None:
        peer = self.wrap_next_addr if wrap else self.next_addr
        if peer is None:
            raise RuntimeError(
                f"stage {self.stage}: no {'wrap_next' if wrap else 'next'} "
                "peer for send_act")
        self._send(peer, ("act", step, mb, vstage, self.epoch), payload)

    def send_grad(self, step: int, mb: int, payload, vstage: int = 0, *,
                  wrap: bool = False) -> None:
        peer = self.wrap_prev_addr if wrap else self.prev_addr
        if peer is None:
            raise RuntimeError(
                f"stage {self.stage}: no {'wrap_prev' if wrap else 'prev'} "
                "peer for send_grad")
        self._send(peer, ("grad", step, mb, vstage, self.epoch), payload)

    def recv_act(self, step: int, mb: int, vstage: int = 0):
        return self._recv(("act", step, mb, vstage, self.epoch))

    def recv_grad(self, step: int, mb: int, vstage: int = 0):
        return self._recv(("grad", step, mb, vstage, self.epoch))

    def _recv(self, key: tuple):
        t0 = time.perf_counter()
        try:
            return self.mailbox.take(key, self.timeout_s)
        except TimeoutError:
            self.counts.inc("recv_timeouts")
            raise
        finally:
            self.stats.add(recv_block_s=time.perf_counter() - t0)

    def barrier_ready(self) -> None:
        """Chain barrier: 'ready' propagates last-stage -> stage 0, then
        'go' propagates stage 0 -> last. Every stage returns only once
        the WHOLE pipeline is built and listening, so step-0 sends never
        queue into a neighbor's set-up and the measured windows start
        aligned. A stage resends its ready every poll interval until the
        go comes back (a ready can be lost with a dying connection); the
        receiver answers late duplicate readys from the read loop.
        Duplicate frames are idempotent: the mailbox keys them alike."""
        deadline = time.monotonic() + self.timeout_s
        poll = min(0.5, self.timeout_s)

        def take_with(resend, key):
            while True:
                if resend is not None:
                    self._wire_send(resend, ("ready", -1, -1, -1,
                                             self.epoch), b"", counted=False)
                try:
                    return self.mailbox.take(key, poll)
                except TimeoutError:
                    if time.monotonic() >= deadline:
                        raise

        if self.next_addr:
            take_with(None, ("ready", -1, -1, -1, self.epoch))
        if self.prev_addr:
            take_with(self.prev_addr, ("go", -1, -1, -1, self.epoch))
        if self.next_addr:
            self._wire_send(self.next_addr, ("go", -1, -1, -1, self.epoch),
                            b"", counted=False)
        self._barrier_done.set()

    def drain_stale(self) -> int:
        """Count-and-drop the act/grad frames still parked in the
        mailbox (an aborted microbatch window's: they must never be
        consumed by a replayed schedule). Returns the number fenced."""
        n = sum(1 for k in self.mailbox.drain() if k and k[0] in
                ("act", "grad"))
        if n:
            self.counts.inc("stale_frames_fenced", n)
        return n

    def close(self) -> None:
        self._closed.set()
        for q in self._senders.values():
            q.put(None)
        # shutdown() BEFORE close(), on every socket: close() alone never
        # wakes a thread pinned inside accept()/recv()/sendall() on the
        # same socket, and the listener's port would stay bound
        with self._conn_lock:
            socks = list(self._conns.values()) + list(self._accepted)
            self._conns.clear()
            self._accepted.clear()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._sender_threads:
            t.join(timeout=5.0)
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass       # listeners reject shutdown on some kernels
        # a throwaway connect unblocks a pinned accept() even where
        # shutdown() on a listening socket is a no-op
        try:
            with socket.create_connection(
                    ("127.0.0.1",
                     int(self.address.rpartition(":")[2])),
                    timeout=0.5):
                pass
        except OSError:
            pass
        self._accept_thread.join(timeout=5.0)
        try:
            self._srv.close()
        except OSError:
            pass
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


class InProcFabric:
    """In-process stand-in for the TCP fabric (tests, one-card runs): one
    mailbox per stage, threads as stages. Same channel API, same
    stats/delay semantics, no sockets."""

    def __init__(self, n_stages: int):
        self.mailboxes = [_Mailbox() for _ in range(n_stages)]

    def channel(self, stage: int, *, blocking: bool = True,
                delay_s: float = 0.0, collector=None,
                timeout_s: float = 60.0, epoch: int = 0) -> "InProcChannel":
        return InProcChannel(self, stage, blocking=blocking,
                             delay_s=delay_s, collector=collector,
                             timeout_s=timeout_s, epoch=epoch)


class InProcChannel:
    def __init__(self, fabric: InProcFabric, stage: int, *, blocking: bool,
                 delay_s: float, collector, timeout_s: float,
                 epoch: int = 0):
        self.fabric = fabric
        self.stage = stage
        self.blocking = blocking
        self.delay_s = delay_s
        self.collector = collector
        self.timeout_s = timeout_s
        # the TCP channel's epoch-last key element: a frame of another
        # epoch never matches a take key
        self.epoch = epoch
        self.counts = _Counts()
        self.stats = TransportStats()
        self._q: Optional[queue.Queue] = None
        self._sender: Optional[threading.Thread] = None

    def _wire_send(self, dest: int, key: tuple, payload) -> None:
        t0 = time.perf_counter()
        span = None
        if self.collector is not None:
            attrs = {"stage": self.stage, "peer": dest, "kind": key[0],
                     "step": key[1], "mb": key[2]}
            if len(key) > 3:
                attrs["vstage"] = key[3]
            span = self.collector.start("dcn.transfer", attrs=attrs)
        data = _encode(key, payload)       # pay real serialize cost
        if self.delay_s:
            time.sleep(self.delay_s)
        k, p = pickle.loads(data[8:])
        self.fabric.mailboxes[dest].put(k, p)
        dt = time.perf_counter() - t0
        self.stats.add(wire_s=dt, bytes_sent=len(data), sends=1)
        if span is not None:
            self.collector.end(span, bytes=len(data))

    def _send(self, dest: int, key: tuple, payload) -> None:
        if self.blocking:
            t0 = time.perf_counter()
            self._wire_send(dest, key, payload)
            self.stats.add(send_block_s=time.perf_counter() - t0)
            return
        if self._q is None:
            self._q = queue.Queue()

            def loop():
                while True:
                    item = self._q.get()
                    if item is None:
                        return
                    self._wire_send(*item)

            self._sender = threading.Thread(
                target=loop, daemon=True, name=f"mpmd-send-{self.stage}")
            self._sender.start()
        t0 = time.perf_counter()
        self._q.put((dest, key, payload))
        self.stats.add(send_block_s=time.perf_counter() - t0)

    def send_act(self, step, mb, payload, vstage: int = 0, *,
                 wrap: bool = False):
        dest = 0 if wrap else self.stage + 1
        self._send(dest, ("act", step, mb, vstage, self.epoch), payload)

    def send_grad(self, step, mb, payload, vstage: int = 0, *,
                  wrap: bool = False):
        dest = len(self.fabric.mailboxes) - 1 if wrap else self.stage - 1
        self._send(dest, ("grad", step, mb, vstage, self.epoch), payload)

    def recv_act(self, step, mb, vstage: int = 0):
        return self._recv(("act", step, mb, vstage, self.epoch))

    def recv_grad(self, step, mb, vstage: int = 0):
        return self._recv(("grad", step, mb, vstage, self.epoch))

    def _recv(self, key):
        t0 = time.perf_counter()
        try:
            return self.fabric.mailboxes[self.stage].take(key, self.timeout_s)
        except TimeoutError:
            self.counts.inc("recv_timeouts")
            raise
        finally:
            self.stats.add(recv_block_s=time.perf_counter() - t0)

    def barrier_ready(self) -> None:
        pass                                   # threads start together

    def close(self) -> None:
        if self._q is not None:
            self._q.put(None)
            self._sender.join(timeout=5.0)


# -------------------------------------------------------- model spec --

def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class MLPSpec:
    """The model behind StageRuntime/run_stage: the harness (stacked
    tanh-MLP chunks + MSE head). Per GLOBAL chunk index in [0,
    cfg.total_stages) it answers the chunk's params and (params, x) -> y
    program, the per-microbatch head loss, and the host-side step batch.

    ``chunks`` (a list of ``{"w", "b"}`` per global chunk), ``head``
    (``{"w"}``) and ``batches`` (a list of ``(x [B, D], t [B, 1])`` per
    step) replace the seeded draws when given (tensors or numpy;
    ``interop.mpmd_mlp_from_jax`` makes them from the JAX harness's)."""

    # chunk 0's backward also pulls back to x (floats)
    first_chunk_needs_dx = True

    def __init__(self, stage_fn: Callable = mlp_stage_fn, *,
                 chunks: Optional[list] = None, head: Optional[dict] = None,
                 batches: Optional[list] = None):
        self.stage_fn = stage_fn
        self.chunks = chunks
        self.head = head
        self.batches = batches

    def chunk_fn(self, cfg: PipelineRunConfig, chunk: int) -> Callable:
        return self.stage_fn

    def chunk_params(self, cfg: PipelineRunConfig, chunk: int,
                     device: DeviceLike = None) -> dict:
        if self.chunks is None:
            return init_stage_params(cfg, chunk, device)
        dev = resolve_device(device)
        return {k: torch.as_tensor(v).to(dev, copy=True)
                for k, v in self.chunks[chunk].items()}

    def head_params(self, cfg: PipelineRunConfig,
                    device: DeviceLike = None) -> dict:
        if self.head is None:
            return init_head_params(cfg, device)
        dev = resolve_device(device)
        return {k: torch.as_tensor(v).to(dev, copy=True)
                for k, v in self.head.items()}

    def head_fn(self, cfg: PipelineRunConfig) -> Callable:
        M = cfg.microbatches

        def fn(hp, y, t):
            return head_loss(hp, y, t, microbatches=M)
        return fn

    def batch(self, cfg: PipelineRunConfig, step: int) -> tuple:
        """Host-side (inputs [M, R, D], targets [M, R, 1]) float32 numpy
        for one step — worker 0 consumes inputs, the head worker
        targets."""
        M, R = cfg.microbatches, cfg.mb_rows
        x, t = (step_batch(cfg, step) if self.batches is None
                else self.batches[step])
        return (np.ascontiguousarray(_host(x), np.float32).reshape(
                    M, R, cfg.dim),
                np.ascontiguousarray(_host(t), np.float32).reshape(M, R, 1))


# -------------------------------------------------------- stage runtime --

class StageRuntime:
    """One worker's per-tick programs + parameters on its device — for
    its V model chunks (V=1 outside interleaved runs).

    Gradients stash per (chunk, microbatch) slot and reduce in one fixed
    descending-index order per chunk, so the result is
    schedule-independent — GPipe, 1F1B and interleaved-1F1B produce
    bitwise-identical updates. Every program ends in a synchronize of
    the current stream, so the caller's clock times the device work."""

    def __init__(self, cfg: PipelineRunConfig, stage: int, *,
                 stage_fn: Callable = mlp_stage_fn, spec=None,
                 device: DeviceLike = None, depot=None,
                 depot_stats: Optional[DepotStats] = None):
        cfg.validate()
        self.cfg = cfg
        self.stage = stage
        self.device = resolve_device(device)
        self.is_first = stage == 0
        self.is_last = stage == cfg.n_stages - 1   # head worker
        self.spec = spec if spec is not None else MLPSpec(stage_fn)
        self.depot_stats = depot_stats if depot_stats is not None \
            else DepotStats()
        self.depot_outcomes: dict[str, str] = {}
        V = cfg.virtual_stages
        # global chunk ids this worker owns: stage, stage+S, ...
        self.chunks = [stage + v * cfg.n_stages for v in range(V)]
        self.params = [self.spec.chunk_params(cfg, c, self.device)
                       for c in self.chunks]
        self.head_params = (self.spec.head_params(cfg, self.device)
                            if self.is_last else None)
        self._fns = [self.spec.chunk_fn(cfg, c) for c in self.chunks]
        self._bwd_has_dx = [c > 0 or self.spec.first_chunk_needs_dx
                            for c in self.chunks]
        self._head_fn = self.spec.head_fn(cfg)
        names = [(n, c) for c in self.chunks for n in ("fwd", "bwd")]
        if self.is_last:
            names.append(("head", cfg.total_stages - 1))
        for name, c in names:
            label = name if V == 1 else f"{name}.c{c}"
            self.depot_outcomes[label] = local_capture(depot,
                                                       self.depot_stats)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------- execution --

    def put_act(self, arr: np.ndarray) -> torch.Tensor:
        """Host-staged wire payload -> this stage's device."""
        return torch.from_numpy(arr).to(self.device)

    def get_act(self, y: torch.Tensor) -> np.ndarray:
        """A device tensor -> host numpy, after the stream's work."""
        self._sync()
        return y.cpu().numpy()

    def fwd(self, x: torch.Tensor, v: int = 0) -> torch.Tensor:
        with torch.no_grad():
            y = self._fns[v](self.params[v], x)
        self._sync()
        return y

    def bwd(self, x: torch.Tensor, dy: torch.Tensor, v: int = 0) -> tuple:
        """Recompute chunk ``v`` from ``x`` and pull ``dy`` back: (param
        grads, dx), dx None where the chunk's input takes no gradient."""
        needs_dx = self._bwd_has_dx[v]
        p = {k: t.detach().requires_grad_(True)
             for k, t in self.params[v].items()}
        xin = x.detach().requires_grad_(needs_dx)
        with torch.enable_grad():
            y = self._fns[v](p, xin)
            grads = torch.autograd.grad(
                y, list(p.values()) + ([xin] if needs_dx else []), dy)
        g = dict(zip(p, grads))
        self._sync()
        return g, (grads[-1] if needs_dx else None)

    def head(self, y: torch.Tensor, t: torch.Tensor) -> tuple:
        """The head's loss on this microbatch, its param grads and the
        loss's gradient with respect to ``y``."""
        hp = {k: v.detach().requires_grad_(True)
              for k, v in self.head_params.items()}
        yin = y.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self._head_fn(hp, yin, t)
            grads = torch.autograd.grad(loss, list(hp.values()) + [yin])
        self._sync()
        return loss.detach(), dict(zip(hp, grads)), grads[-1]

    def _reduce(self, slots: list) -> dict:
        # descending-index sequential sum by the same add: the one order
        # every schedule shares
        acc = slots[-1]
        for g in slots[-2::-1]:
            acc = {k: acc[k] + g[k] for k in acc}
        return acc

    def _sgd(self, p: dict, g: dict) -> dict:
        return {k: p[k] - self.cfg.lr * g[k] for k in p}

    def apply_grads(self, grad_slots: list, head_slots: Optional[list]):
        """``grad_slots``: per-chunk slot lists ([V][M]) or one flat [M]
        list (the V=1 shape)."""
        per_chunk = (grad_slots
                     if grad_slots and isinstance(grad_slots[0], list)
                     else [grad_slots])
        with torch.no_grad():
            for v, slots in enumerate(per_chunk):
                self.params[v] = self._sgd(self.params[v],
                                           self._reduce(slots))
            if head_slots is not None:
                self.head_params = self._sgd(self.head_params,
                                             self._reduce(head_slots))
        self._sync()

    def depot_summary(self) -> dict:
        return {"outcomes": dict(self.depot_outcomes),
                "hit": all(v == "hit" for v in self.depot_outcomes.values()),
                "counters": self.depot_stats.snapshot()}


# ------------------------------------------------------------ run loop --

@dataclasses.dataclass
class StageResult:
    stage: int
    losses: list          # last stage only; [] elsewhere
    step_stats: list      # per step: {"t0","t1","busy_s","send_block_s"}
    transport: dict
    depot: dict
    schedule: str
    max_stash: int


def run_stage(cfg: PipelineRunConfig, stage: int, chan, *,
              runtime: Optional[StageRuntime] = None, collector=None,
              on_step: Optional[Callable[[int, Optional[float]], None]] = None,
              spec=None, device: DeviceLike = None) -> StageResult:
    """Execute ``cfg.steps`` pipeline training steps for ONE stage (with
    a ``StageRuntime`` of ``spec`` on ``device`` unless ``runtime`` is
    given).

    The tick order comes from ``schedule_ticks``; data dependencies
    (recv act / recv grad) provide all cross-stage synchronization. Per
    tick, compute time is accounted to ``busy_s`` and a ``pipeline.tick``
    span is recorded; the channel accounts wire/blocked time and records
    ``dcn.transfer`` spans. Stage 0's per-step [t0, t1] window brackets
    the whole pipeline (it injects first and its update depends on the
    last returning grad), so aggregate_stats measures every stage's idle
    against stage 0's windows.

    Busy accounting matches what the analytic fill-drain bound models:
    everything the stage actively DOES — compute, host staging (to and
    from the device), and the blocking part of sends — is work; bubble
    is the remaining (schedule-induced) idleness. An exposed transfer
    still raises the measured bubble, just where it physically bites:
    as the DOWNSTREAM stage's wait (and in send_block/overlap stats)."""
    rt = runtime if runtime is not None else StageRuntime(
        cfg, stage, spec=spec, device=device)
    spec = rt.spec
    S, V, M = cfg.n_stages, cfg.virtual_stages, cfg.microbatches
    T = cfg.total_stages
    raw = schedule_ticks(cfg.schedule, S, stage, M, cfg.virtual_stages)
    # normalize 2-field (phase, mb) ticks to (phase, vchunk=0, mb)
    ticks = [t if len(t) == 3 else (t[0], 0, t[1]) for t in raw]
    chan.barrier_ready()
    step_stats: list = []
    losses: list = []
    for k in range(cfg.steps):
        if rt.is_first:
            x_host, _ = spec.batch(cfg, k)
        if rt.is_last:
            _, t_host = spec.batch(cfg, k)
        # perf_counter, not wall clock: windows and busy must share a
        # clock domain (aggregate_stats only ever compares DURATIONS)
        t_step0 = time.perf_counter()
        busy = 0.0
        block0 = chan.stats.snapshot()["send_block_s"]
        stash: dict[tuple, tuple] = {}
        grad_slots: list = [[None] * M for _ in range(V)]
        head_slots: Optional[list] = [None] * M if rt.is_last else None
        step_losses: list = [None] * M
        for phase, v, i in ticks:
            c = stage + v * S              # global chunk this tick runs
            span = None
            if collector is not None:
                span = collector.start("pipeline.tick", attrs={
                    "stage": stage, "step": k, "mb": i, "phase": phase,
                    "vstage": v, "chunk": c})
            if phase == "fwd":
                if c == 0:
                    c0 = time.perf_counter()
                    x = rt.put_act(x_host[i])
                    busy += time.perf_counter() - c0
                else:
                    arr = chan.recv_act(k, i, v)
                    c0 = time.perf_counter()
                    x = rt.put_act(arr)
                    busy += time.perf_counter() - c0
                c0 = time.perf_counter()
                y = rt.fwd(x, v)
                busy += time.perf_counter() - c0
                stash[(v, i)] = (x, y)
                if c < T - 1:
                    c0 = time.perf_counter()
                    payload = rt.get_act(y)
                    if stage < S - 1:
                        chan.send_act(k, i, payload, v)
                    else:
                        # ring wrap: chunk (v+1)*S lives on worker 0
                        chan.send_act(k, i, payload, v + 1, wrap=True)
                    busy += time.perf_counter() - c0
            else:
                x, y = stash.pop((v, i))
                if c == T - 1:
                    c0 = time.perf_counter()
                    t = rt.put_act(t_host[i])
                    loss_i, gh, dy = rt.head(y, t)
                    g, dx = rt.bwd(x, dy, v)
                    busy += time.perf_counter() - c0
                    head_slots[i] = gh
                    step_losses[i] = loss_i
                else:
                    dy_arr = chan.recv_grad(k, i, v)
                    c0 = time.perf_counter()
                    dy = rt.put_act(dy_arr)
                    g, dx = rt.bwd(x, dy, v)
                    busy += time.perf_counter() - c0
                grad_slots[v][i] = g
                if c > 0:
                    c0 = time.perf_counter()
                    payload = rt.get_act(dx)
                    if stage > 0:
                        chan.send_grad(k, i, payload, v)
                    else:
                        # ring wrap back: chunk v*S - 1 is worker S-1's
                        # virtual chunk v-1
                        chan.send_grad(k, i, payload, v - 1, wrap=True)
                    busy += time.perf_counter() - c0
            if span is not None:
                collector.end(span)
        c0 = time.perf_counter()
        rt.apply_grads(grad_slots, head_slots)
        if rt.is_last:
            total = step_losses[0]
            for li in step_losses[1:]:
                total = total + li
            losses.append(float(total))
        busy += time.perf_counter() - c0
        # the blocking part of sends is already inside the timed regions
        # above; record the per-step exposure for the overlap stats
        block1 = chan.stats.snapshot()["send_block_s"]
        step_stats.append({"t0": t_step0, "t1": time.perf_counter(),
                           "busy_s": round(busy, 6),
                           "send_block_s": round(block1 - block0, 6)})
        if on_step is not None:
            on_step(k, losses[-1] if rt.is_last else None)
    return StageResult(
        stage=stage, losses=losses, step_stats=step_stats,
        transport=chan.stats.snapshot(), depot=rt.depot_summary(),
        schedule=cfg.schedule, max_stash=max_live_stash(ticks))


# --------------------------------------------------------- measurement --

def analytic_bubble_bound(n_stages: int, microbatches: int,
                          virtual_stages: int = 1) -> float:
    """The fill-drain bound: stage s idles s ticks at fill and S-1-s at
    drain, per phase — (S-1)/(S+M-1) of the schedule, independent of the
    fwd/bwd time ratio (both phases scale together). With virtual
    stages the same S-1 fill/drain units amortize over V*M chunk units:
    (S-1)/(V*M+S-1) — strictly below the V=1 floor for V >= 2."""
    return (n_stages - 1) / (virtual_stages * microbatches + n_stages - 1)


def aggregate_stats(results: list, cfg: PipelineRunConfig,
                    skip_steps: int = 1) -> dict:
    """Fold per-stage StageResults (or their dict form) into the measured
    pipeline numbers. Bubble is idle-vs-window against stage 0's step
    windows (stage 0 brackets every step — see run_stage); the first
    ``skip_steps`` steps are excluded (first-call warm-up). DCN overlap
    is 1 - send_block/wire: the wire time hidden under compute."""
    def _d(r):
        return r if isinstance(r, dict) else dataclasses.asdict(r)

    rs = sorted((_d(r) for r in results), key=lambda r: r["stage"])
    S = cfg.n_stages
    if len(rs) != S:
        raise ValueError(f"need all {S} stage reports, got {len(rs)}")
    windows = rs[0]["step_stats"]
    n_steps = min(len(r["step_stats"]) for r in rs)
    per_step = []
    for k in range(skip_steps, n_steps):
        w = windows[k]["t1"] - windows[k]["t0"]
        if w <= 0:
            continue
        idle = sum(max(0.0, w - r["step_stats"][k]["busy_s"]) for r in rs)
        per_step.append(idle / (S * w))
    bubble = sum(per_step) / len(per_step) if per_step else None
    wire = sum(r["transport"]["wire_s"] for r in rs)
    blocked = sum(r["transport"]["send_block_s"] for r in rs)
    overlap = (1.0 - min(blocked, wire) / wire) if wire > 0 else None
    busy = [sum(st["busy_s"] for st in r["step_stats"][skip_steps:n_steps])
            for r in rs]
    V = cfg.virtual_stages
    ticks = 2 * cfg.microbatches * V * max(1, n_steps - skip_steps)
    interleaved = cfg.schedule == "interleaved-1f1b"
    return {
        "schedule": cfg.schedule,
        "n_stages": S,
        "virtual_stages": V,
        "microbatches": cfg.microbatches,
        "steps_measured": max(0, n_steps - skip_steps),
        "bubble_fraction": round(bubble, 4) if bubble is not None else None,
        "bubble_fraction_per_step": [round(b, 4) for b in per_step],
        # the V=1 floor — what interleaving must beat at matched M
        "analytic_fill_drain_bound": round(
            analytic_bubble_bound(S, cfg.microbatches), 4),
        "analytic_interleaved_bound": (round(analytic_bubble_bound(
            S, cfg.microbatches, V), 4) if V > 1 else None),
        "dcn_overlap_fraction": (round(overlap, 4)
                                 if overlap is not None else None),
        "dcn_wire_s": round(wire, 4),
        "dcn_send_block_s": round(blocked, 4),
        "mean_tick_s": round(sum(busy) / (S * ticks), 6) if ticks else None,
        # stash units are CHUNK activations (1/V of a plain stage's):
        # the V-chunk memory cost, checked against the analytic bound
        "max_activation_stash": max(r["max_stash"] for r in rs),
        "stash_per_stage": [r["max_stash"] for r in rs],
        "stash_bound_per_stage": (
            [interleaved_stash_bound(S, s, cfg.microbatches, V)
             for s in range(S)] if interleaved else None),
        "per_stage_busy_s": [round(b, 4) for b in busy],
        "est_basis": "measured (per-stage busy vs stage-0 step windows; "
                     "overlap = 1 - send_block/wire)",
    }


def run_inproc(cfg: PipelineRunConfig, *, collector=None,
               runtimes: Optional[list] = None, spec=None,
               device: DeviceLike = None) -> tuple[list, list[float]]:
    """All stages as threads over the in-process fabric, on one device
    (``runtimes``' or ``device``: the card unless the CPU is asked for);
    on a card each thread runs on its own CUDA stream. Returns
    (per-stage StageResults, last-stage losses)."""
    dev = runtimes[0].device if runtimes else resolve_device(device)
    fabric = InProcFabric(cfg.n_stages)
    results: list = [None] * cfg.n_stages
    errors: list = []
    streams = ([torch.cuda.Stream(dev) for _ in range(cfg.n_stages)]
               if dev.type == "cuda" else None)
    if streams:
        for s in streams:             # after whatever built the runtimes
            s.wait_stream(torch.cuda.current_stream(dev))

    def work(s: int):
        chan = fabric.channel(
            s, blocking=cfg.schedule == "gpipe",
            delay_s=cfg.dcn_delay_ms / 1e3, collector=collector)
        try:
            with (torch.cuda.stream(streams[s]) if streams
                  else contextlib.nullcontext()):
                results[s] = run_stage(
                    cfg, s, chan,
                    runtime=runtimes[s] if runtimes else None,
                    collector=collector, spec=spec, device=dev)
        except Exception as e:                     # surfaced by the join
            errors.append((s, e))
        finally:
            chan.close()

    threads = [threading.Thread(target=work, args=(s,), daemon=True)
               for s in range(cfg.n_stages)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)
    if streams:
        for s in streams:
            torch.cuda.current_stream(dev).wait_stream(s)
    if errors:
        raise RuntimeError(f"stage failures: {errors!r}") from errors[0][1]
    if any(r is None for r in results):
        raise TimeoutError("a stage thread did not finish")
    return results, results[-1].losses


# -------------------------------------------------------------- oracle --

def oracle_rank(mesh, cfg: PipelineRunConfig, spec: MLPSpec) -> list:
    """One rank of ``run_oracle``: stage ``axis_index("pipeline")`` of the
    SPMD pipeline over the world's ``pipeline`` axis, the head's loss on
    every rank (``pipeline_apply`` broadcasts the last stage's outputs),
    SGD on the rank's chunk and the head. Returns the step losses."""
    from kubeflow_tpu_torch.parallel.pipeline import pipeline_apply

    s, dev = mesh.axis_index("pipeline"), mesh.device
    M, R, D = cfg.microbatches, cfg.mb_rows, cfg.dim
    fwd = pipeline_apply(spec.chunk_fn(cfg, s), mesh, microbatches=M)
    head = spec.head_fn(cfg)
    params = spec.chunk_params(cfg, s, dev)
    hp = spec.head_params(cfg, dev)
    losses = []
    for k in range(cfg.steps):
        x_host, t_host = spec.batch(cfg, k)
        x = torch.from_numpy(x_host.reshape(M * R, D)).to(dev)
        t = torch.from_numpy(t_host).to(dev)
        for v in (*params.values(), *hp.values()):
            v.requires_grad_(True)
        y = fwd(params, x).reshape(M, R, D)
        loss = head(hp, y[0], t[0])
        for i in range(1, M):
            loss = loss + head(hp, y[i], t[i])
        # backward() over the whole graph, not autograd.grad of the
        # leaves: every rank must run every shift's reverse (the ring's
        # anchor keeps them on the graph), whatever its leaves need
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            params = {n: v - cfg.lr * v.grad for n, v in params.items()}
            hp = {n: v - cfg.lr * v.grad for n, v in hp.items()}
    return losses


def run_oracle(cfg: PipelineRunConfig,
               stage_fn: Callable = mlp_stage_fn, *, spec=None,
               device: DeviceLike = None) -> list[float]:
    """The single-program SPMD oracle: the SAME model, microbatching,
    loss and SGD updates through the port's ``pipeline_apply`` on a
    world of ``total_stages`` gloo processes over one device (spawned by
    ``tools.world_train.run``), one chunk a rank. The MPMD runs — plain
    AND interleaved, which partition the model over the same
    total_stages chunks — must reproduce this loss trajectory."""
    from kubeflow_tpu_torch.tools import world_train

    cfg.validate()
    dev = resolve_device(device)
    T = cfg.total_stages
    spec = spec if spec is not None else MLPSpec(stage_fn)
    rundir = tempfile.mkdtemp(prefix="mpmd-oracle-")
    try:
        ranks = world_train.run(oracle_rank, (cfg, spec), 1, 1,
                                [str(dev)] * T, rundir, pipeline=T)
    finally:
        shutil.rmtree(rundir, ignore_errors=True)
    if any(r != ranks[0] for r in ranks):
        raise RuntimeError(f"oracle ranks disagree: {ranks}")
    return ranks[0]

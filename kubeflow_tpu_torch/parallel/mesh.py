"""Tensor-parallel device mesh of the PyTorch port (counterpart of
``kubeflow_tpu.parallel.mesh``).

The JAX package runs one program over a ``jax.sharding.Mesh`` and XLA
inserts the collectives. PyTorch's idiom is one process per rank under
``torch.distributed``; ``TensorMesh`` is that: ``tp`` ranks, the device
each rank computes on, and the process groups they talk over.

- Rank 0 is the calling process. ``launch`` spawns ranks 1..tp-1 (the
  ``spawn`` start method) and rendezvouses with them through a file, so
  no fixed port is ever taken.
- Three groups: the default group carries rank 0's commands (workers wait
  on it for as long as the server idles); ``ack`` (gloo, with the mesh's
  timeout) carries every rank's answer back to rank 0, so a rank that
  died or hangs makes rank 0 raise instead of wait; ``dev`` carries the
  model's collectives: NCCL when every rank has a card of its own, gloo
  on the CPU or when the caller places several ranks on one card
  (NCCL refuses two ranks on one device). gloo's collectives run on CPU
  tensors here: a CUDA tensor is copied to the host and back. A rank in
  a gloo mesh runs torch's CPU ops on one thread: with the default (one
  a core, in every rank) the ranks' idle worker threads crowd out gloo's
  own and an all-reduce of 64 KB among 4 ranks on 8 cores took 7.8 ms
  against 0.8 ms.
- No fallback: an NCCL failure raises and is never retried on gloo.

``mesh_from_topology_env`` parses the JAX package's ``KFT_MESH``/``KFT_DCN``
contract for serving, where only the ``tensor`` axis is ported, and
raises for any other axis set above 1.

``WorldMesh`` is the training world's counterpart of ``MeshConfig`` /
``build_mesh`` over the batch axes: ``data`` x ``fsdp`` processes, one
device each (``rendezvous/bootstrap.py`` starts them and chooses the
backend), with one process group per axis. Under ``data`` every rank
holds the whole train state and the gradients are all-reduced; under
``fsdp`` each rank holds its shard of the parameters and the optimizer
state (``parallel/sharding.fsdp_*``), all-gathers the parameters before
its micro batches and reduce-scatters the gradients after them.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import shutil
import tempfile
from typing import Any, Mapping, Optional, Sequence

import torch

# Outer-to-inner canonical order (the JAX package's, for the parse).
AXIS_ORDER = ("pipeline", "data", "fsdp", "expert", "context", "tensor")

PARALLEL_SLICE = ("is the parallel/ slice of the PyTorch port (queue 1 "
                  "item 8.7); only the tensor axis is ported for serving, "
                  "and the data and fsdp axes for training")

# rank 0's wait for the other ranks' answer to one command, unless the
# mesh is given another: a first command may build the CUDA kernels
DEFAULT_TIMEOUT_S = 600.0


def parse_topology_env(env: Mapping[str, str]) -> dict:
    """``KFT_MESH=data=2,tensor=4`` (and ``KFT_DCN=data=2``) -> axis sizes,
    with the JAX parse's checks (``kubeflow_tpu.parallel.mesh.
    mesh_from_topology_env``); DCN axes come back as ``dcn_<axis>``."""
    sizes: dict[str, int] = {}
    for part in env.get("KFT_MESH", "").split(","):
        if part:
            k, v = part.split("=")
            if k not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {k!r}")
            sizes[k] = int(v)
    for part in env.get("KFT_DCN", "").split(","):
        if part:
            k, v = part.split("=")
            sizes["dcn_" + k] = int(v)
    return sizes


def mesh_from_topology_env(env: Mapping[str, str],
                           devices: Optional[Sequence] = None,
                           ) -> Optional["TensorMesh"]:
    """The mesh ``KFT_MESH`` asks for, or None when it asks for no
    tensor parallelism. Axes other than ``tensor`` set above 1 raise
    (NotImplementedError, naming the slice). ``devices`` defaults to one
    card per rank (``cuda:0..tp-1``; fewer visible cards raise, as
    ``build_mesh`` does) or, with ``KFT_FORCE_PLATFORM=cpu``, the CPU."""
    sizes = parse_topology_env(env)
    other = {k: v for k, v in sizes.items() if k != "tensor" and v > 1}
    if other:
        raise NotImplementedError(
            f"KFT_MESH={env.get('KFT_MESH', '')!r} "
            f"KFT_DCN={env.get('KFT_DCN', '')!r}: a mesh over "
            f"{sorted(other)} {PARALLEL_SLICE}")
    tp = sizes.get("tensor", 1)
    if tp <= 1:
        return None
    if devices is None:
        platform = (env.get("KFT_FORCE_PLATFORM") or "").strip().lower()
        devices = (["cpu"] * tp if platform == "cpu"
                   else cuda_devices(tp))
    return TensorMesh(tp, devices)


def cuda_devices(tp: int) -> list[str]:
    """One card per rank; raises when fewer than ``tp`` are visible."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < tp:
        raise RuntimeError(
            f"tensor={tp} needs {tp} CUDA devices, one per rank; {n} "
            "visible (pass devices= to place several ranks on one card, "
            "or set KFT_FORCE_PLATFORM=cpu to run on the CPU)")
    return [f"cuda:{i}" for i in range(tp)]


class TensorMesh:
    """``tp`` ranks over ``devices`` (rank r computes on ``devices[r]``):
    all CPU, or all CUDA. Distinct cards talk over NCCL; a list that
    repeats a card, or the CPU, over gloo. Before ``launch`` (rank 0) or
    ``join`` (ranks 1..) the object is only a description and can be
    handed to spawned processes."""

    def __init__(self, tp: int, devices: Sequence, *,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 rendezvous_dir: Optional[str] = None):
        devs = [torch.device(d) for d in devices]
        if tp < 1 or len(devs) != tp:
            raise ValueError(f"tensor={tp} needs {tp} devices, got "
                             f"{[str(d) for d in devs]}")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"mesh devices must be all cpu or all cuda, "
                             f"got {[str(d) for d in devs]}")
        if "cuda" in kinds:
            devs = [torch.device("cuda", d.index or 0) for d in devs]
        self.tp = tp
        self.devices = devs
        self.shared = len(set(devs)) < tp
        self.backend = ("nccl" if "cuda" in kinds and not self.shared
                        else "gloo")
        self.timeout_s = float(timeout_s)
        # where launch() puts its rendezvous file (a fresh temporary
        # directory when None); the file is new for every launch
        self.rendezvous_dir = rendezvous_dir
        self.rendezvous: Optional[str] = None
        self.rank = 0
        self._groups: Optional[dict] = None
        self._tmpdir: Optional[str] = None
        self._threads: Optional[int] = None     # torch's, before join

    # ------------------------------------------------------------ identity

    @property
    def shape(self) -> dict:
        """Axis sizes, as ``jax.sharding.Mesh.shape`` gives them."""
        return {"tensor": self.tp}

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def describe(self) -> dict:
        return {"tensor": self.tp, "backend": self.backend,
                "shared_card": self.shared,
                "devices": [str(d) for d in self.devices]}

    def __getstate__(self):
        # what a spawned rank needs: the description, never the groups
        state = dict(self.__dict__)
        state["_groups"] = None
        state["_tmpdir"] = None
        state["_threads"] = None
        return state

    # ------------------------------------------------------------ lifetime

    def launch(self, target, args: tuple = ()) -> list:
        """Rank 0: spawn ranks 1..tp-1, each running
        ``target(mesh, *args)`` once it has joined, then join as rank 0.
        Returns the worker processes (daemonic: they end with this
        process at the latest). One launched mesh per process:
        torch.distributed's default group is the process's."""
        import torch.distributed as dist
        import torch.multiprocessing as mp

        if dist.is_initialized():
            raise RuntimeError("torch.distributed is already initialized in "
                               "this process (a running mesh?); shut it "
                               "down first")
        self._tmpdir = tempfile.mkdtemp(prefix="kft-tp-",
                                        dir=self.rendezvous_dir)
        self.rendezvous = os.path.join(self._tmpdir, "rendezvous")
        ctx = mp.get_context("spawn")
        procs = []
        try:
            for rank in range(1, self.tp):
                p = ctx.Process(target=_rank_entry,
                                args=(self, rank, target, args),
                                daemon=True, name=f"kft-tp-rank{rank}")
                p.start()
                procs.append(p)
            self.join(0)
        except BaseException:
            for p in procs:
                p.kill()
                p.join()
            self._cleanup()
            raise
        return procs

    def join(self, rank: int) -> None:
        """Join the mesh as ``rank``: select the rank's card and create
        the three groups (blocks until every rank has joined)."""
        import torch.distributed as dist

        self.rank = rank
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if self.backend == "gloo":
            self._threads = torch.get_num_threads()
            torch.set_num_threads(1)
        # the default group carries commands: workers wait on it while the
        # server idles, so it must outlast any idle period
        dist.init_process_group(
            "gloo", init_method="file://" + self.rendezvous, rank=rank,
            world_size=self.tp, timeout=datetime.timedelta(days=7))
        ack = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=self.timeout_s))
        dev = dist.new_group(backend=self.backend)
        self._groups = {"ack": ack, "dev": dev}

    def shutdown(self) -> None:
        """Leave the process groups (every rank calls it once)."""
        import torch.distributed as dist

        if self._groups is not None:
            self._groups = None
            if dist.is_initialized():
                dist.destroy_process_group()
        if self._threads is not None:
            torch.set_num_threads(self._threads)
            self._threads = None
        self._cleanup()

    def _cleanup(self) -> None:
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None
            self.rendezvous = None

    # ------------------------------------------------------------- control

    def send_command(self, obj: Any) -> None:
        """Rank 0: one command to every other rank."""
        import torch.distributed as dist

        dist.broadcast_object_list([obj], src=0)

    def recv_command(self) -> Any:
        """Ranks 1..: wait for rank 0's next command."""
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def gather_answers(self, obj: Any) -> list:
        """Every rank's ``obj``, in rank order, on every rank (the ack
        group: raises when a rank died, or after the mesh's timeout)."""
        import torch.distributed as dist

        out = [None] * self.tp
        dist.all_gather_object(out, obj, group=self._groups["ack"])
        return out

    # --------------------------------------------------------- collectives

    def _via_host(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or max) of ``x`` over the ranks, in place; returns ``x``.
        Every rank gets the same bytes."""
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = x.cpu() if self._via_host(x) else x
        dist.all_reduce(buf, op=red, group=self._groups["dev"])
        if buf is not x:
            x.copy_(buf)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        import torch.distributed as dist

        buf = x.cpu() if self._via_host(x) else x.contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.tp)]
        dist.all_gather(parts, buf, group=self._groups["dev"])
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if out.device != x.device else out


def tensor_parallel(mesh) -> Optional[TensorMesh]:
    """``mesh`` when it shards anything (tp > 1), else None: a 1-rank
    mesh runs today's single-card path unchanged."""
    return mesh if mesh is not None and mesh.tp > 1 else None


def _rank_entry(mesh: TensorMesh, rank: int, target, args: tuple) -> None:
    mesh.join(rank)
    try:
        target(mesh, *args)
    finally:
        mesh.shutdown()


# ---------------------------------------------------------------------------
# The training world: the batch axes over processes
# ---------------------------------------------------------------------------

# gloo's collectives run on host tensors in pieces of at most this many
# bytes (one call over a multi-GB tensor would hold as much again in
# gloo's own buffers), spread over GLOO_LANES groups of the same ranks,
# one thread each: one gloo group moves ~1.1 GB/s between two processes
# on one host, four ~3 GB/s (an all-reduce of 800 MB on 8 cores)
GLOO_PIECE_BYTES = 1 << 26
GLOO_LANES = 4


@dataclasses.dataclass(frozen=True)
class Backend:
    """The backend of a world's model collectives, and why it was chosen
    (``rendezvous.bootstrap.choose_backend``)."""
    name: str
    reason: str


def resolve_world_axes(num_processes: int, data: int = 1,
                       fsdp: int = -1) -> tuple[int, int]:
    """``MeshConfig.resolved``'s rule over the batch axes, one device a
    process: at most one axis is -1 and absorbs what the other leaves
    (unset, every process goes on ``fsdp``); the sizes must multiply to
    ``num_processes``. Raises ValueError with the JAX package's
    messages."""
    sizes = {"data": data, "fsdp": fsdp}
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one -1 axis allowed, got {wild}")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wild:
        if num_processes % fixed != 0:
            raise ValueError(
                f"cannot infer {wild[0]}: {num_processes} devices/slice not "
                f"divisible by fixed product {fixed}")
        sizes[wild[0]] = num_processes // fixed
    elif fixed != num_processes:
        raise ValueError(
            f"mesh product {fixed} != devices per slice {num_processes}")
    return sizes["data"], sizes["fsdp"]


class WorldMesh:
    """``data`` x ``fsdp`` training processes, one device each (module
    docstring). Rank ``r`` sits at ``(r // fsdp, r % fsdp)``: ``data``
    is the outer axis, as in the JAX package's ``AXIS_ORDER``, so the
    rank is also this process's place in the batch (the JAX batch
    sharding ``("data", "fsdp")``).

    Built after ``torch.distributed``'s default group exists (gloo,
    ``rendezvous.bootstrap.join_world``); every rank builds it with the
    same sizes. The model's collectives run over groups of ``backend``:
    NCCL on device tensors, or gloo, where a CUDA tensor goes through a
    pinned host copy (one staging buffer, grown to the largest call) in
    pieces of ``GLOO_PIECE_BYTES`` spread over ``GLOO_LANES`` groups.
    Per axis a group: ``world`` (every rank), ``data`` (the ranks
    holding the same shard) and ``fsdp`` (the ranks sharing one
    replica); an axis of size 1 makes no call.

    ``timings`` sums, per rank, the seconds and bytes of the host-staged
    collectives: the device-to-host copies, the gloo calls and the
    host-to-device copies (NCCL's are queued on the stream and are not
    timed here)."""

    def __init__(self, data: int, fsdp: int, rank: int, device,
                 backend: Backend):
        if data < 1 or fsdp < 1:
            raise ValueError(f"data={data} fsdp={fsdp}: sizes must be >= 1")
        self.data, self.fsdp = int(data), int(fsdp)
        self.size = self.data * self.fsdp
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a world of {self.size}")
        self.rank = int(rank)
        self.data_index, self.fsdp_index = divmod(self.rank, self.fsdp)
        self.device = torch.device(device)
        self.backend = backend
        self._groups: dict = {}
        self._staging: Optional[torch.Tensor] = None
        self.timings = {"d2h_s": 0.0, "gloo_s": 0.0, "h2d_s": 0.0,
                        "d2h_bytes": 0, "h2d_bytes": 0, "calls": 0}
        if self.size > 1:
            self._make_groups()

    @classmethod
    def from_layout(cls, layout: Mapping[str, int], rank: int, device,
                    backend: Backend) -> "WorldMesh":
        """From ``rendezvous.bootstrap.world_layout``'s axis sizes: the
        DCN part of an axis multiplies into it (one device a process, so
        the slices are processes too)."""
        return cls(layout.get("data", 1) * layout.get("dcn_data", 1),
                   layout.get("fsdp", 1) * layout.get("dcn_fsdp", 1),
                   rank, device, backend)

    # ------------------------------------------------------------ identity

    @property
    def shape(self) -> dict:
        """Axis sizes, as ``jax.sharding.Mesh.shape`` gives them."""
        return {"data": self.data, "fsdp": self.fsdp}

    def axis_size(self, axis: str) -> int:
        return {"world": self.size, "data": self.data,
                "fsdp": self.fsdp}[axis]

    def axis_index(self, axis: str) -> int:
        return {"world": self.rank, "data": self.data_index,
                "fsdp": self.fsdp_index}[axis]

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def via_host(self) -> bool:
        return self.backend.name == "gloo" and self.device.type == "cuda"

    def describe(self) -> dict:
        return {"data": self.data, "fsdp": self.fsdp, "rank": self.rank,
                "device": str(self.device), "backend": self.backend.name,
                "reason": self.backend.reason}

    def _make_groups(self) -> None:
        """Per axis the groups of this rank: one over NCCL, GLOO_LANES
        over gloo. Every process takes part in creating every group, in
        the same order."""
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise RuntimeError(
                f"a world of data={self.data} x fsdp={self.fsdp} needs the "
                f"default process group over {self.size} processes "
                "(rendezvous.bootstrap.initialize or join_world first)")
        be = self.backend.name
        lanes = GLOO_LANES if be == "gloo" else 1

        def groups(ranks=None) -> list:
            return [dist.new_group(ranks, backend=be) for _ in range(lanes)]

        self._groups["world"] = groups()
        for j in range(self.fsdp if self.data > 1 else 0):
            g = groups([i * self.fsdp + j for i in range(self.data)])
            if j == self.fsdp_index:
                self._groups["data"] = g
        for i in range(self.data if self.fsdp > 1 else 0):
            g = groups([i * self.fsdp + j for j in range(self.fsdp)])
            if i == self.data_index:
                self._groups["fsdp"] = g

    # ------------------------------------------------------------- control

    def barrier(self) -> None:
        """Every rank of the world reaches this call (the default group)."""
        import torch.distributed as dist

        if self.size > 1:
            dist.barrier()

    def broadcast_object(self, obj: Any) -> Any:
        """The coordinator's ``obj`` on every rank (the default group)."""
        import torch.distributed as dist

        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    # --------------------------------------------------------- collectives

    def _host(self, numel: int, dtype: torch.dtype) -> torch.Tensor:
        """A pinned host tensor of ``numel`` elements (the staging buffer,
        grown when too small)."""
        nbytes = numel * dtype.itemsize
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = None
            self._staging = torch.empty((nbytes,), dtype=torch.uint8,
                                        pin_memory=True)
        return self._staging[:nbytes].view(dtype)

    def _to_host(self, host: torch.Tensor, x: torch.Tensor) -> None:
        import time

        torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        host.copy_(x.reshape(-1))
        self.timings["d2h_s"] += time.perf_counter() - t0
        self.timings["d2h_bytes"] += host.numel() * host.itemsize

    def _from_host(self, x: torch.Tensor, host: torch.Tensor) -> None:
        import time

        t0 = time.perf_counter()
        x.view(-1).copy_(host)
        torch.cuda.current_stream(self.device).synchronize()
        self.timings["h2d_s"] += time.perf_counter() - t0
        self.timings["h2d_bytes"] += host.numel() * host.itemsize

    def _ranges(self, numel: int, itemsize: int) -> list:
        n = max(GLOO_PIECE_BYTES // itemsize, 1)
        return [(i, min(i + n, numel)) for i in range(0, numel, n)]

    def _gloo(self, axis: str, calls: list) -> None:
        """Run ``calls`` (each ``call(group)``, one gloo collective on one
        piece) over the axis's lanes: lane i takes calls i, i + lanes, ...
        in order, on its own thread when there is more than one call."""
        import threading
        import time

        lanes = self._groups[axis]
        t0 = time.perf_counter()
        if len(calls) == 1:
            calls[0](lanes[0])
        else:
            errors: list = []

            def lane(i: int) -> None:
                try:
                    for call in calls[i::len(lanes)]:
                        call(lanes[i])
                except BaseException as e:      # raised below
                    errors.append(e)

            threads = [threading.Thread(target=lane, args=(i,))
                       for i in range(min(len(lanes), len(calls)))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        self.timings["gloo_s"] += time.perf_counter() - t0
        self.timings["calls"] += 1

    def all_reduce(self, x: torch.Tensor, axis: str = "world"
                   ) -> torch.Tensor:
        """Sum ``x`` (contiguous) over ``axis``, in place; returns ``x``.
        Every rank of the axis gets the same bytes."""
        import torch.distributed as dist

        if self.axis_size(axis) == 1:
            return x
        if self.backend.name == "nccl":
            dist.all_reduce(x, group=self._groups[axis][0])
            return x
        host = x.view(-1)
        if self.via_host:
            host = self._host(x.numel(), x.dtype)
            self._to_host(host, x)
        self._all_reduce_host(host, axis)
        if self.via_host:
            self._from_host(x, host)
        return x

    def _all_reduce_host(self, host: torch.Tensor, axis: str) -> None:
        import torch.distributed as dist

        self._gloo(axis, [
            lambda g, a=a, b=b: dist.all_reduce(host[a:b], group=g)
            for a, b in self._ranges(host.numel(), host.itemsize)])

    def reduce_scatter(self, out: torch.Tensor, x: torch.Tensor,
                       axis: str = "fsdp") -> torch.Tensor:
        """``out`` [k] = this rank's k-element part of ``x`` [n * k] (n the
        axis size, parts in axis order) summed over ``axis``. Under gloo
        this is an all-reduce of ``x`` (clobbering it on the CPU) and a
        copy of the rank's part."""
        import torch.distributed as dist

        n, k = self.axis_size(axis), out.numel()
        if x.numel() != n * k:
            raise ValueError(f"reduce_scatter of {x.numel()} elements into "
                             f"{n} parts of {k}")
        idx = self.axis_index(axis)
        if n == 1:
            return out.copy_(x.view(out.shape))
        if self.backend.name == "nccl":
            dist.reduce_scatter_tensor(out, x, group=self._groups[axis][0])
            return out
        host = x.view(-1)
        if self.via_host:
            host = self._host(x.numel(), x.dtype)
            self._to_host(host, x)
        self._all_reduce_host(host, axis)
        part = host[idx * k:(idx + 1) * k]
        if self.via_host:
            self._from_host(out, part)
        else:
            out.view(-1).copy_(part)
        return out

    def all_gather(self, out: torch.Tensor, x: torch.Tensor,
                   axis: str = "fsdp") -> torch.Tensor:
        """``out`` [n * k] = every rank's ``x`` [k] of ``axis``,
        concatenated in axis order."""
        import torch.distributed as dist

        n, k = self.axis_size(axis), x.numel()
        if out.numel() != n * k:
            raise ValueError(f"all_gather of {n} parts of {k} into "
                             f"{out.numel()} elements")
        if n == 1:
            return out.copy_(x.view(out.shape))
        if self.backend.name == "nccl":
            dist.all_gather_into_tensor(out, x, group=self._groups[axis][0])
            return out
        if self.via_host:
            host = self._host((n + 1) * k, x.dtype)
            src, dst = host[:k], host[k:]
            self._to_host(src, x)
        else:
            src, dst = x.reshape(-1), out.view(-1)
        rows = dst.view(n, k)
        self._gloo(axis, [
            lambda g, a=a, b=b: dist.all_gather(
                [rows[r, a:b] for r in range(n)], src[a:b], group=g)
            for a, b in self._ranges(k, x.itemsize)])
        if self.via_host:
            self._from_host(out, dst)
        return out

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

Only the ``tensor`` axis is ported. ``mesh_from_topology_env`` parses the
JAX package's ``KFT_MESH``/``KFT_DCN`` contract and raises for any other
axis set above 1.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Any, Mapping, Optional, Sequence

import torch

# Outer-to-inner canonical order (the JAX package's, for the parse).
AXIS_ORDER = ("pipeline", "data", "fsdp", "expert", "context", "tensor")

PARALLEL_SLICE = ("is the parallel/ slice of the PyTorch port (queue 1 "
                  "item 8); only the tensor axis is ported")

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

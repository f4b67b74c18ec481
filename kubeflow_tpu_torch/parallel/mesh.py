"""Device meshes of the PyTorch port (counterpart of
``kubeflow_tpu.parallel.mesh``).

The JAX package runs one program over a ``jax.sharding.Mesh`` and XLA
inserts the collectives. PyTorch's idiom is one process per rank under
``torch.distributed``; ``TensorMesh`` is that for serving: ``expert`` x
``tensor`` ranks (rank = expert index x tensor + tensor index, ``tensor``
innermost as in ``AXIS_ORDER``), the device each rank computes on, and
the process groups they talk over.

- Rank 0 is the calling process. ``launch`` spawns ranks 1..n-1 (the
  ``spawn`` start method) and rendezvouses with them through a file, so
  no fixed port is ever taken.
- The default group carries rank 0's commands (workers wait on it for as
  long as the server idles) and what rank 0 scatters to the ranks;
  ``ack`` (gloo, with the mesh's timeout) carries every rank's answer
  back to rank 0, so a rank that died or hangs makes rank 0 raise instead
  of wait. The model's collectives run over one group per axis
  (``tensor``: the ranks of one expert index; ``expert``: the ranks of
  one tensor index) and over the whole mesh (``mesh``, also named
  ``rows``: every serving rank feeds the same rows): NCCL when every
  rank has a card of its own, gloo on the CPU or when the caller places
  several ranks on one card (NCCL refuses two ranks on one device).
  gloo's collectives run on CPU tensors here: a CUDA tensor is copied to
  the host and back. A rank in a gloo mesh runs torch's CPU ops on one
  thread: with the default (one a core, in every rank) the ranks' idle
  worker threads crowd out gloo's own and an all-reduce of 64 KB among
  4 ranks on 8 cores took 7.8 ms against 0.8 ms.
- No fallback: an NCCL failure raises and is never retried on gloo.

``mesh_from_topology_env`` parses the JAX package's ``KFT_MESH``/``KFT_DCN``
contract for serving, where the ``expert`` and ``tensor`` axes are
ported, and raises for any other axis set above 1.

``WorldMesh`` is the training world's counterpart of ``MeshConfig`` /
``build_mesh``: ``pipeline`` x ``data`` x ``fsdp`` x ``expert`` x
``context`` x ``tensor`` processes, one device each
(``rendezvous/bootstrap.py`` starts them and chooses the backend), with
process groups per axis and per set of axes. Under ``data`` every rank
holds the whole train state and the gradients are
all-reduced; under ``fsdp`` each rank holds its shard of the parameters
and the optimizer state (``parallel/fsdp.py``), gathers each layer's
weights before it runs and reduce-scatters its gradients after it; under
``tensor`` each rank holds its Megatron cut of every ``heads`` /
``kv_heads`` / ``mlp`` / ``vocab`` leaf and the ranks of the axis,
which feed the same rows, join their products through autograd-aware
collectives (``parallel/tensor.py``); under ``expert`` each rank holds
its share of every MoE layer's experts, feeds the same rows as its
expert peers, and the MoE layer joins their outputs
(``parallel/moe.py``); under ``context`` each rank feeds its chunk of
the same rows' tokens and holds the same state as its context peers, and
attention joins the chunks (``parallel/ring_attention.py``: K/V passed
round the ring, ``ring_shift``, or the sequence cut swapped for a head
cut, ``all_to_all``); under ``pipeline`` each rank holds one stage of
the layers and feeds the same rows as its pipeline peers, whose
activations it passes on round the ring (``parallel/pipeline.py``:
``ring_shift`` and ``broadcast``).
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
                  "item 8.7); the expert and tensor axes are ported for "
                  "serving, and "
                  "the pipeline, data, fsdp, expert, context and tensor "
                  "axes for training, pipeline over gloo alone (over NCCL "
                  "it is not verified: queue 3 fault 8)")

# rank 0's wait for the other ranks' answer to one command, unless the
# mesh is given another: a first command may build the CUDA kernels
DEFAULT_TIMEOUT_S = 600.0
# a context or pipeline collective's wait under gloo (NCCL's groups keep
# their own watchdog timeout): a send posted without its receive raises
# after this rather than hang the world
CONTEXT_TIMEOUT_S = 600.0


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


# the axes a serving mesh cuts, outermost first
SERVING_AXES = ("expert", "tensor")


def mesh_from_topology_env(env: Mapping[str, str],
                           devices: Optional[Sequence] = None,
                           ) -> Optional["TensorMesh"]:
    """The mesh ``KFT_MESH`` asks for, or None when it cuts nothing.
    ``expert`` and ``tensor`` make the mesh; any other axis set above 1,
    and any ``KFT_DCN`` axis, raises (NotImplementedError, naming the
    slice). ``devices`` defaults to one card per rank (``cuda:0..n-1``
    for n = expert x tensor ranks; fewer visible cards raise, as
    ``build_mesh`` does) or, with ``KFT_FORCE_PLATFORM=cpu``, the CPU."""
    sizes = parse_topology_env(env)
    other = {k: v for k, v in sizes.items()
             if k not in SERVING_AXES and v > 1}
    if other:
        raise NotImplementedError(
            f"KFT_MESH={env.get('KFT_MESH', '')!r} "
            f"KFT_DCN={env.get('KFT_DCN', '')!r}: a mesh over "
            f"{sorted(other)} {PARALLEL_SLICE}")
    tp, ep = sizes.get("tensor", 1), sizes.get("expert", 1)
    if tp < 1 or ep < 1:
        raise ValueError(f"KFT_MESH={env.get('KFT_MESH', '')!r}: the "
                         "serving axes are fixed sizes >= 1")
    if tp * ep <= 1:
        return None
    if devices is None:
        platform = (env.get("KFT_FORCE_PLATFORM") or "").strip().lower()
        devices = (["cpu"] * (tp * ep) if platform == "cpu"
                   else cuda_devices(tp * ep))
    return TensorMesh(tp, devices, expert=ep)


def cuda_devices(n: int) -> list[str]:
    """One card per rank; raises when fewer than ``n`` are visible."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"a mesh of {n} ranks needs {n} CUDA devices, one per rank; "
            f"{have} visible (pass devices= to place several ranks on one "
            "card, or set KFT_FORCE_PLATFORM=cpu to run on the CPU)")
    return [f"cuda:{i}" for i in range(n)]


# a serving mesh's groups by name: each holds the ranks that differ only
# on its axes. Every serving rank feeds the same rows, so ``rows`` (the
# MoE layer's peers, as a training world names them) is the whole mesh
SERVING_GROUPS = {"tensor": ("tensor",), "expert": ("expert",),
                  "mesh": SERVING_AXES, "rows": SERVING_AXES}


class TensorMesh:
    """``expert`` x ``tp`` ranks over ``devices`` (rank r computes on
    ``devices[r]`` and sits at expert index r // tp, tensor index
    r % tp): all CPU, or all CUDA. Distinct cards talk over NCCL; a list
    that repeats a card, or the CPU, over gloo. Before ``launch`` (rank
    0) or ``join`` (ranks 1..) the object is only a description and can
    be handed to spawned processes; a description's ``rank`` may be set
    to stand as another rank (what a parameter draw or a load reads)."""

    def __init__(self, tp: int, devices: Sequence, *, expert: int = 1,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 rendezvous_dir: Optional[str] = None):
        devs = [torch.device(d) for d in devices]
        n = tp * expert
        if tp < 1 or expert < 1 or len(devs) != n:
            what = (f"tensor={tp}" if expert == 1
                    else f"expert={expert} x tensor={tp}")
            raise ValueError(f"{what} needs {n} devices, got "
                             f"{[str(d) for d in devs]}")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"mesh devices must be all cpu or all cuda, "
                             f"got {[str(d) for d in devs]}")
        if "cuda" in kinds:
            devs = [torch.device("cuda", d.index or 0) for d in devs]
        self.tp = tp
        self.ep = expert
        self.size = n
        self.devices = devs
        self.shared = len(set(devs)) < n
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
        return {"expert": self.ep, "tensor": self.tp}

    @property
    def tensor_index(self) -> int:
        return self.rank % self.tp

    @property
    def expert_index(self) -> int:
        return self.rank // self.tp

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def members(self, axis: str, rank: Optional[int] = None) -> tuple:
        """The ranks of ``rank``'s (default: this rank's) group over
        ``axis`` (``SERVING_GROUPS``; any other axis is the rank alone),
        in rank order."""
        rank = self.rank if rank is None else rank
        axes = SERVING_GROUPS.get(axis, ())
        x, t = divmod(rank, self.tp)
        xs = range(self.ep) if "expert" in axes else (x,)
        ts = range(self.tp) if "tensor" in axes else (t,)
        return tuple(i * self.tp + j for i in xs for j in ts)

    def axis_size(self, axis: str) -> int:
        """The number of ranks in this rank's group over ``axis`` (a
        serving group's name; a training world's axes, which a serving
        mesh does not cut, count 1)."""
        return len(self.members(axis))

    def axis_index(self, axis: str) -> int:
        """This rank's place in its group over ``axis``."""
        return self.members(axis).index(self.rank)

    def describe(self) -> dict:
        return {"expert": self.ep, "tensor": self.tp,
                "backend": self.backend, "shared_card": self.shared,
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
        """Rank 0: spawn ranks 1..n-1, each running ``target(mesh,
        *args)`` once it has joined, then join as rank 0. Returns the
        worker processes (daemonic: they end with this process at the
        latest). One launched mesh per process: torch.distributed's
        default group is the process's."""
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
            for rank in range(1, self.size):
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
        the groups (blocks until every rank has joined). Every rank
        creates every group, in the same order; a group of the same ranks
        as another is that group."""
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
            world_size=self.size, timeout=datetime.timedelta(days=7))
        groups = {"ack": dist.new_group(backend="gloo",
                                        timeout=datetime.timedelta(
                                            seconds=self.timeout_s))}
        made: dict = {}
        for name in SERVING_GROUPS:
            for r in range(self.size):
                ranks = self.members(name, r)
                if len(ranks) > 1 and ranks not in made:
                    made[ranks] = dist.new_group(list(ranks),
                                                 backend=self.backend)
            mine = self.members(name)
            groups[name] = made.get(mine)          # None: a group of one
        self._groups = groups

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

    def scatter(self, objs: Optional[Sequence] = None) -> Any:
        """Rank 0 hands rank r ``objs[r]`` (over the command group, after
        a command that says so); every rank returns its own. Ranks 1..
        pass nothing."""
        import torch.distributed as dist

        box = [None]
        dist.scatter_object_list(
            box, list(objs) if self.rank == 0 else None, src=0)
        return box[0]

    def gather_answers(self, obj: Any) -> list:
        """Every rank's ``obj``, in rank order, on every rank (the ack
        group: raises when a rank died, or after the mesh's timeout)."""
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._groups["ack"])
        return out

    def gather_to_root(self, obj: Any) -> Optional[list]:
        """Every rank's ``obj`` in rank order on rank 0 (None elsewhere),
        over the ack group: data that only rank 0 needs crosses once."""
        import torch.distributed as dist

        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self._groups["ack"])
        return out

    # --------------------------------------------------------- collectives

    def _via_host(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    def all_reduce(self, x: torch.Tensor, axis: str = "mesh", kind=None,
                   op: str = "sum") -> torch.Tensor:
        """Sum (or max) of ``x`` over this rank's group over ``axis``
        (``SERVING_GROUPS``), in place; returns ``x``. Every rank of the
        group gets the same bytes; a group of one makes no call.
        ``kind`` is a training world's timings label, unused here."""
        import torch.distributed as dist

        group = self._groups[axis] if axis in SERVING_GROUPS else None
        if group is None:
            if self.axis_size(axis) > 1:
                raise RuntimeError(f"the mesh has not joined ({axis})")
            return x
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = x.cpu() if self._via_host(x) else x
        dist.all_reduce(buf, op=red, group=group)
        if buf is not x:
            x.copy_(buf)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1,
                   axis: str = "tensor") -> torch.Tensor:
        """The ``x`` of this rank's group over ``axis``, concatenated
        along ``dim`` in rank order."""
        import torch.distributed as dist

        n = self.axis_size(axis)
        if n == 1:
            return x
        buf = x.cpu() if self._via_host(x) else x.contiguous()
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=self._groups[axis])
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if out.device != x.device else out


def tensor_parallel(mesh) -> Optional[TensorMesh]:
    """``mesh`` when it cuts anything (more than one rank), else None: a
    1-rank mesh runs today's single-card path unchanged."""
    return mesh if mesh is not None and mesh.size > 1 else None


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
# on one host, four ~3 GB/s (an all-reduce of 800 MB on 8 cores). A
# tensor of fewer than GLOO_LANES full pieces is cut into one piece a
# lane, none under GLOO_MIN_PIECE_BYTES, so that a 16.8 MB activation
# uses every lane too
GLOO_PIECE_BYTES = 1 << 26
GLOO_MIN_PIECE_BYTES = 1 << 20
GLOO_LANES = 4


@dataclasses.dataclass(frozen=True)
class Backend:
    """The backend of a world's model collectives, and why it was chosen
    (``rendezvous.bootstrap.choose_backend``)."""
    name: str
    reason: str


def resolve_world_axes(num_processes: int, data: int = 1,
                       fsdp: int = -1, tensor: int = 1,
                       expert: int = 1, context: int = 1,
                       pipeline: int = 1) -> tuple[int, int]:
    """``MeshConfig.resolved``'s rule over the world's axes, one device a
    process: at most one batch axis is -1 and absorbs what the others
    leave (unset, every process the ``pipeline``, ``expert``,
    ``context`` and ``tensor`` axes leave goes on ``fsdp``);
    ``pipeline``, ``expert``, ``context`` and ``tensor`` are fixed; the
    sizes must multiply to ``num_processes``. Returns ``(data, fsdp)``.
    Raises ValueError with the JAX package's messages."""
    for name, size in (("tensor", tensor), ("expert", expert),
                       ("context", context), ("pipeline", pipeline)):
        if size < 1:
            raise ValueError(f"{name}={size}: the {name} axis is fixed; "
                             "only data or fsdp may be -1")
    sizes = {"pipeline": pipeline, "data": data, "fsdp": fsdp,
             "expert": expert, "context": context, "tensor": tensor}
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


# the world's axes, outermost first (``AXIS_ORDER``'s)
WORLD_AXES = ("pipeline", "data", "fsdp", "expert", "context", "tensor")

# the world's groups: each holds the ranks that differ only on its axes
GROUP_AXES = {"world": WORLD_AXES, "data": ("data",), "fsdp": ("fsdp",),
              "expert": ("expert",), "context": ("context",),
              "tensor": ("tensor",),
              # the ranks holding different rows (expert, context and
              # tensor peers feed the same rows)
              "batch": ("data", "fsdp"),
              # the ranks holding different tokens (context peers hold
              # different chunks of the same rows): every sum over tokens
              "tokens": ("data", "fsdp", "context"),
              # the ranks holding the same part of the state and
              # different tokens: the gradient all-reduce
              "data_context": ("data", "context"),
              # the ranks feeding the same rows: an MoE layer's peers
              "rows": ("expert", "tensor"),
              # the ranks holding the parts of one replica of the state,
              # and the pairs of its axes that cut one leaf
              "replica": ("fsdp", "expert", "tensor"),
              "fsdp_tensor": ("fsdp", "tensor"),
              "fsdp_expert": ("fsdp", "expert"),
              # the ranks holding the other stages of the same rows and
              # state (parallel/pipeline.py), and the sets of axes that
              # cut one stage leaf beside it
              "pipeline": ("pipeline",),
              "pipeline_fsdp": ("pipeline", "fsdp"),
              "pipeline_expert": ("pipeline", "expert"),
              "pipeline_tensor": ("pipeline", "tensor"),
              "pipeline_rows": ("pipeline", "expert", "tensor"),
              "pipeline_fsdp_tensor": ("pipeline", "fsdp", "tensor"),
              "pipeline_fsdp_expert": ("pipeline", "fsdp", "expert"),
              "pipeline_replica": ("pipeline", "fsdp", "expert", "tensor")}


def group_of(axes) -> str:
    """The name of the group over ``axes`` (a collection of axis names,
    or a group's name)."""
    if isinstance(axes, str):
        return axes
    want = {a for a in axes}
    for name, over in GROUP_AXES.items():
        if set(over) == want:
            return name
    raise ValueError(f"no group over the axes {sorted(want)}")


class WorldMesh:
    """``pipeline`` x ``data`` x ``fsdp`` x ``expert`` x ``context`` x
    ``tensor`` training processes, one device each (module docstring).
    Rank ``r`` sits at ``(p, d, f, x, c, t)`` with ``r = ((((p * data +
    d) * fsdp + f) * expert + x) * context + c) * tensor + t``:
    ``pipeline`` outermost and ``tensor`` innermost, as in the JAX
    package's ``AXIS_ORDER``, so tensor peers are neighbouring ranks (and
    cards), and a rank's place in the batch (the JAX batch sharding
    ``("data", "fsdp")``) is ``d * fsdp + f`` (``axis_index("batch")``):
    pipeline, expert, context and tensor peers feed the same rows,
    context peers each its chunk ``c`` of their tokens (the JAX ``seq``
    -> ``context`` rule), pipeline peers each its stage ``p`` of the
    layers (the JAX ``pipe_stage`` -> ``pipeline`` rule).

    Built after ``torch.distributed``'s default group exists (gloo,
    ``rendezvous.bootstrap.join_world``); every rank builds it with the
    same sizes. The model's collectives run over groups of ``backend``:
    NCCL on device tensors, or gloo, where a CUDA tensor goes through a
    pinned host copy (one staging buffer, grown to the largest call) in
    pieces of at most ``GLOO_PIECE_BYTES`` spread over ``GLOO_LANES``
    groups.
    The groups (``GROUP_AXES``): ``world``, one per axis (``data``: the
    ranks holding the same shard; ``fsdp``: the ranks sharing one
    replica's expert and tensor slice; ``expert``: the ranks holding the
    other experts of the same rows; ``tensor``: the ranks holding the
    other Megatron slices of the same rows; ``context``: the ranks
    holding the other chunks of the same rows' tokens), ``batch``
    (``data`` x ``fsdp``), ``tokens`` (``data`` x ``fsdp`` x
    ``context``: every sum over tokens), ``data_context`` (the gradient
    all-reduce), ``rows`` (``expert`` x ``tensor``: an MoE layer's peers),
    ``replica`` (``fsdp`` x ``expert`` x ``tensor``) and the pairs of its
    axes that cut one leaf (over which a leaf's reductions are summed),
    ``pipeline`` (the ranks holding the other stages), and ``pipeline``
    beside each set of axes that cuts a leaf. ``batch``, ``tokens`` and
    ``data_context`` never include ``pipeline``: pipeline peers hold
    the same rows and, after the pipeline's broadcast, the same loss.
    Groups of one rank make no call; groups of the same ranks are one.

    ``timings`` sums, per rank, the seconds and bytes of the host-staged
    collectives: the device-to-host copies, the gloo calls and the
    host-to-device copies (NCCL's are queued on the stream and are not
    timed here); the ``tensor`` axis's collectives, wherever they run:
    their calls, bytes and host seconds (``tensor_*``; under NCCL the
    enqueue only); and the MoE layers' (``moe_*``, the same readings:
    the routing counts' all-gather and the statistics' all-reduce over
    ``tokens``, the copies' and the output's all-reduces over ``rows``);
    and the ``context`` axis's ``ring_shift`` and ``all_to_all``
    (``context_*``, the same readings); and the ``pipeline`` axis's
    ``ring_shift`` and ``broadcast`` (``pipeline_*``, the same
    readings).

    ``pipeline`` under NCCL raises NotImplementedError
    (``PARALLEL_SLICE``)."""

    def __init__(self, data: int, fsdp: int, rank: int, device,
                 backend: Backend, tensor: int = 1, expert: int = 1,
                 context: int = 1, pipeline: int = 1):
        if min(data, fsdp, tensor, expert, context, pipeline) < 1:
            raise ValueError(f"pipeline={pipeline} data={data} fsdp={fsdp} "
                             f"expert={expert} context={context} "
                             f"tensor={tensor}: sizes must be >= 1")
        if pipeline > 1 and backend.name == "nccl":
            raise NotImplementedError(
                f"a training world over pipeline={pipeline} under NCCL "
                f"{PARALLEL_SLICE}")
        self.data, self.fsdp = int(data), int(fsdp)
        self.expert, self.tensor = int(expert), int(tensor)
        self.context, self.pipeline = int(context), int(pipeline)
        self.size = (self.pipeline * self.data * self.fsdp * self.expert
                     * self.context * self.tensor)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a world of {self.size}")
        self.rank = int(rank)
        (self.pipeline_index, self.data_index, self.fsdp_index,
         self.expert_index, self.context_index,
         self.tensor_index) = self._coords(self.rank)
        self.device = torch.device(device)
        self.backend = backend
        self._groups: dict = {}
        self._members: dict = {}
        self._staging: Optional[torch.Tensor] = None
        self.timings = {"d2h_s": 0.0, "gloo_s": 0.0, "h2d_s": 0.0,
                        "d2h_bytes": 0, "h2d_bytes": 0, "calls": 0,
                        "tensor_calls": 0, "tensor_bytes": 0,
                        "tensor_s": 0.0, "moe_calls": 0, "moe_bytes": 0,
                        "moe_s": 0.0, "context_calls": 0,
                        "context_bytes": 0, "context_s": 0.0,
                        "pipeline_calls": 0, "pipeline_bytes": 0,
                        "pipeline_s": 0.0}
        for name in GROUP_AXES:
            self._members[name] = self._ranks_of(name, self.rank)
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
                   rank, device, backend, tensor=layout.get("tensor", 1),
                   expert=layout.get("expert", 1),
                   context=layout.get("context", 1),
                   pipeline=layout.get("pipeline", 1))

    # ------------------------------------------------------------ identity

    def _coords(self, rank: int) -> tuple:
        out = []
        for n in (self.tensor, self.context, self.expert, self.fsdp,
                  self.data):
            rank, i = divmod(rank, n)
            out.append(i)
        return (rank, *reversed(out))

    def _ranks_of(self, name: str, rank: int) -> tuple:
        """The ranks of group ``name`` that ``rank`` belongs to, in rank
        order (they differ from it only on the group's axes)."""
        over = GROUP_AXES[name]
        mine = dict(zip(WORLD_AXES, self._coords(rank)))
        return tuple(r for r in range(self.size) if all(
            c == mine[a] for a, c in zip(WORLD_AXES, self._coords(r))
            if a not in over))

    @property
    def shape(self) -> dict:
        """Axis sizes, as ``jax.sharding.Mesh.shape`` gives them (the
        batch axes always; ``pipeline``, ``expert``, ``context`` and
        ``tensor`` where they are over 1)."""
        out = {"pipeline": self.pipeline} if self.pipeline > 1 else {}
        out.update(data=self.data, fsdp=self.fsdp)
        for axis in ("expert", "context", "tensor"):
            if getattr(self, axis) > 1:
                out[axis] = getattr(self, axis)
        return out

    def axis_size(self, axis) -> int:
        """The number of ranks in this rank's group over ``axis`` (an
        axis, a group's name, or a collection of axes)."""
        return len(self._members[group_of(axis)])

    def axis_index(self, axis) -> int:
        """This rank's place in its group over ``axis``."""
        return self._members[group_of(axis)].index(self.rank)

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def via_host(self) -> bool:
        return self.backend.name == "gloo" and self.device.type == "cuda"

    def describe(self) -> dict:
        return {"pipeline": self.pipeline, "data": self.data,
                "fsdp": self.fsdp, "expert": self.expert,
                "context": self.context, "tensor": self.tensor,
                "rank": self.rank,
                "device": str(self.device), "backend": self.backend.name,
                "reason": self.backend.reason}

    def _make_groups(self) -> None:
        """Per group of more than one rank, this rank's: one process
        group over NCCL, GLOO_LANES over gloo; groups of the same ranks
        share them. Every process takes part in creating every group, in
        the same order."""
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise RuntimeError(
                f"a world of pipeline={self.pipeline} x data={self.data} "
                f"x fsdp={self.fsdp} x expert={self.expert} x "
                f"context={self.context} x tensor={self.tensor} needs the "
                f"default process group over {self.size} processes "
                "(rendezvous.bootstrap.initialize or join_world first)")
        be = self.backend.name
        lanes = GLOO_LANES if be == "gloo" else 1
        made: dict = {}
        for name in GROUP_AXES:
            parts = sorted({self._ranks_of(name, r) for r in range(self.size)})
            if len(parts[0]) == 1:
                continue
            for ranks in parts:
                if ranks not in made:
                    made[ranks] = [dist.new_group(list(ranks), backend=be)
                                   for _ in range(lanes)]
            self._groups[name] = made[self._members[name]]

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

    @staticmethod
    def _ranges(numel: int, itemsize: int, lanes: int) -> list:
        """The pieces ``(start, stop)`` of a gloo call over ``numel``
        elements: at most GLOO_PIECE_BYTES each, and as many as
        ``lanes`` where that takes pieces of GLOO_MIN_PIECE_BYTES or
        more."""
        n = min(max(-(-numel // lanes), GLOO_MIN_PIECE_BYTES // itemsize),
                GLOO_PIECE_BYTES // itemsize)
        n = max(n, 1)
        return [(i, min(i + n, numel)) for i in range(0, numel, n)]

    def _gloo(self, axis: str, calls: list) -> None:
        """Run ``calls`` (each ``call(group)``, one gloo collective on one
        piece) over the axis's lanes: lane i takes calls i, i + lanes, ...
        in order, on its own thread when there is more than one call."""
        import threading
        import time

        lanes = self._groups[group_of(axis)]
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

    def _timed(self, axis, x: torch.Tensor, call, kind=None) -> None:
        """``call()``, counted in ``timings``' ``{kind}_*`` (``x``: the
        collective's input): ``kind`` "moe" for an MoE layer's calls,
        else "tensor" or "pipeline" for that axis's, else not counted."""
        import time

        if kind is None and group_of(axis) in ("tensor", "pipeline"):
            kind = group_of(axis)
        if kind is None:
            call()
            return
        if self.via_host:
            torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        call()
        self.timings[kind + "_s"] += time.perf_counter() - t0
        self.timings[kind + "_calls"] += 1
        self.timings[kind + "_bytes"] += x.numel() * x.itemsize

    def all_reduce(self, x: torch.Tensor, axis="world",
                   kind=None) -> torch.Tensor:
        """Sum ``x`` (contiguous) over ``axis`` (an axis or a group's
        name, ``GROUP_AXES``), in place; returns ``x``. Every rank of the
        axis gets the same bytes. ``kind``: the ``timings`` readings it
        counts in (``_timed``)."""
        if self.axis_size(axis) > 1:
            self._timed(axis, x, lambda: self._all_reduce(x, axis), kind)
        return x

    def _all_reduce(self, x: torch.Tensor, axis) -> None:
        import torch.distributed as dist

        if self.backend.name == "nccl":
            dist.all_reduce(x, group=self._groups[group_of(axis)][0])
            return
        host = x.view(-1)
        if self.via_host:
            host = self._host(x.numel(), x.dtype)
            self._to_host(host, x)
        self._all_reduce_host(host, axis)
        if self.via_host:
            self._from_host(x, host)

    def _all_reduce_host(self, host: torch.Tensor, axis: str) -> None:
        import torch.distributed as dist

        self._gloo(axis, [
            lambda g, a=a, b=b: dist.all_reduce(host[a:b], group=g)
            for a, b in self._ranges(host.numel(), host.itemsize,
                                     len(self._groups[group_of(axis)]))])

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
            dist.reduce_scatter_tensor(out, x,
                                       group=self._groups[group_of(axis)][0])
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
                   axis="fsdp", kind=None) -> torch.Tensor:
        """``out`` [n * k] = every rank's ``x`` [k] of ``axis``,
        concatenated in axis order (``kind``: as ``all_reduce``'s)."""
        n, k = self.axis_size(axis), x.numel()
        if out.numel() != n * k:
            raise ValueError(f"all_gather of {n} parts of {k} into "
                             f"{out.numel()} elements")
        if n == 1:
            return out.copy_(x.view(out.shape))
        self._timed(axis, out, lambda: self._all_gather(out, x, axis), kind)
        return out

    def _all_gather(self, out: torch.Tensor, x: torch.Tensor, axis) -> None:
        import torch.distributed as dist

        n, k = self.axis_size(axis), x.numel()
        if self.backend.name == "nccl":
            dist.all_gather_into_tensor(out, x,
                                        group=self._groups[group_of(axis)][0])
            return
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
            for a, b in self._ranges(k, x.itemsize,
                                     len(self._groups[group_of(axis)]))])
        if self.via_host:
            self._from_host(out, dst)

    def ring_shift(self, x: torch.Tensor, axis: str = "context",
                   reverse: bool = False) -> torch.Tensor:
        """A new tensor holding the ``x`` of the rank before this one on
        ``axis`` (index ``c - 1``, cyclically), while this rank's ``x``
        goes to the rank after it (``c + 1``): one step round the ring;
        with ``reverse``, one step the other way (from ``c + 1``, to ``c
        - 1``). Every rank of the axis calls it with a tensor of the same
        shape and dtype. Counted in ``timings``' ``pipeline_*`` over
        ``pipeline``, else ``context_*``."""
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        if self.axis_size(axis) == 1:
            return out.copy_(x)
        kind = "pipeline" if group_of(axis) == "pipeline" else "context"
        self._timed(axis, x,
                    lambda: self._ring_shift(out, x, axis, reverse), kind)
        return out

    def _ring_shift(self, out: torch.Tensor, x: torch.Tensor,
                    axis: str, reverse: bool = False) -> None:
        import torch.distributed as dist

        members = self._members[group_of(axis)]
        c, n = members.index(self.rank), len(members)
        step = -1 if reverse else 1
        nxt, prv = members[(c + step) % n], members[(c - step) % n]
        if self.backend.name == "nccl":
            # one NCCL group call: both ranks of a pair post their send
            # and receive together, whatever order the ranks reach it in
            group = self._groups[group_of(axis)][0]
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, out, prv, group)])
            for w in works:
                w.wait()
            return
        src, dst = x.contiguous().view(-1), out.view(-1)
        if self.via_host:
            host = self._host(2 * x.numel(), x.dtype)
            src, dst = host[:x.numel()], host[x.numel():]
            self._to_host(src, x)

        def sendrecv(group) -> None:
            # both posted before either is waited for, so no rank blocks
            # in a send whose receive its peer has not reached
            works = [dist.isend(src, nxt, group=group),
                     dist.irecv(dst, prv, group=group)]
            for w in works:
                w.wait(datetime.timedelta(seconds=CONTEXT_TIMEOUT_S))

        self._gloo(axis, [sendrecv])
        if self.via_host:
            self._from_host(out, dst)

    def broadcast(self, x: torch.Tensor, axis: str = "pipeline",
                  index: int = 0) -> torch.Tensor:
        """``x`` (contiguous) overwritten, in place, with the ``x`` of the
        rank of index ``index`` on ``axis``; returns ``x``. Every rank of
        the axis calls it with a tensor of the same shape and dtype.
        Counted in ``timings``' ``pipeline_*`` over ``pipeline``."""
        if self.axis_size(axis) > 1:
            self._timed(axis, x, lambda: self._broadcast(x, axis, index))
        return x

    def _broadcast(self, x: torch.Tensor, axis: str, index: int) -> None:
        import torch.distributed as dist

        src = self._members[group_of(axis)][index]
        lanes = self._groups[group_of(axis)]
        if self.backend.name == "nccl":
            dist.broadcast(x, src, group=lanes[0])
            return
        host = x.view(-1)
        if self.via_host:
            host = self._host(x.numel(), x.dtype)
            if self.rank == src:
                self._to_host(host, x)
        self._gloo(axis, [
            lambda g, a=a, b=b: dist.broadcast(host[a:b], src, group=g)
            for a, b in self._ranges(host.numel(), host.itemsize,
                                     len(lanes))])
        if self.via_host and self.rank != src:
            self._from_host(x, host)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                   axis: str = "context") -> torch.Tensor:
        """The ``jax.lax.all_to_all(x, axis, split_axis=split_dim,
        concat_axis=concat_dim, tiled=True)`` of ``x``: ``x`` cut into n
        equal chunks along ``split_dim`` (n the axis size), chunk j sent
        to the rank of index j, and the n chunks this rank receives
        concatenated along ``concat_dim`` in index order. Counted in
        ``timings``' ``context_*``."""
        n = self.axis_size(axis)
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all of dim {x.shape[split_dim]} over "
                             f"{axis}={n}")
        if n == 1:
            return x.clone(memory_format=torch.contiguous_format)
        # [n, *chunk]: chunk j first, then the rest in x's order
        parts = torch.stack(x.chunk(n, split_dim))
        got = torch.empty_like(parts)
        self._timed(axis, x, lambda: self._all_to_all(got, parts, axis),
                    "context")
        return torch.cat(got.unbind(0), dim=concat_dim)

    def _all_to_all(self, out: torch.Tensor, x: torch.Tensor,
                    axis: str) -> None:
        import torch.distributed as dist

        if self.backend.name == "nccl":
            dist.all_to_all_single(out, x,
                                   group=self._groups[group_of(axis)][0])
            return
        src, dst = x.view(-1), out.view(-1)
        if self.via_host:
            host = self._host(2 * x.numel(), x.dtype)
            src, dst = host[:x.numel()], host[x.numel():]
            self._to_host(src, x)
        self._gloo(axis, [lambda group: dist.all_to_all_single(
            dst, src, group=group, async_op=True).wait(
                datetime.timedelta(seconds=CONTEXT_TIMEOUT_S))])
        if self.via_host:
            self._from_host(out, dst)

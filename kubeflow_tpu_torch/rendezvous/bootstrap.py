"""In-worker bootstrap: controller-stamped env -> an initialised
``torch.distributed`` world and this process's device (counterpart of
``kubeflow_tpu.rendezvous.bootstrap``).

The controller stamps one of two contracts on every worker pod
(``kubeflow_tpu/controller/reconciler.py``, ``cluster_env``):

- a JAXJob: ``KFT_COORDINATOR`` (host:port), ``KFT_NUM_PROCESSES``,
  ``KFT_PROCESS_ID``, with ``KFT_MESH`` / ``KFT_DCN`` for the layout;
- a PyTorchJob: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``.

``world_from_env`` reads the first and, where it is absent, the second.
``initialize`` picks the device (``KFT_FORCE_PLATFORM`` through
``device.platform_device``; on cards one card per process,
``cuda:{process_id % device_count}``; without a card and without
``KFT_FORCE_PLATFORM=cpu`` it raises) and, for more than one process,
joins the world (``join_world``): a gloo default group at
``tcp://{coordinator}``, over which the ranks exchange where they run,
and from that the backend of the model's collectives
(``choose_backend``): NCCL when every rank has a card of its own, gloo
when ranks share a card or run on the CPU (NCCL refuses two ranks on
one device). The choice and its reason are logged and kept on
``WorldInfo.backend``. It is made from where the processes are, never
from what fails: an NCCL error raises and is not retried on gloo.

The world's layout: each process is one device, and a ``KFT_MESH`` whose
``pipeline`` x ``data`` x ``fsdp`` x ``expert`` x ``context`` x
``tensor`` product (times ``KFT_DCN``'s ``data`` and ``fsdp``) is the
number of processes is accepted as that layout
(``parallel.mesh.WorldMesh`` trains over it). ``KFT_DCN`` spans the
batch axes only, as in the reference. Any other axis above 1 raises
``parallel.mesh.PARALLEL_SLICE``, and so does ``pipeline`` once the
world has chosen NCCL.

``KFT_COMPILE_CACHE`` has no counterpart here: the JAX worker points
XLA's persistent compile cache at it, and the port compiles no XLA
programs (its kernels build once per checkout, under ``_build/``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
from typing import Mapping, Optional

import torch

from kubeflow_tpu_torch.device import platform_device, resolve_device
from kubeflow_tpu_torch.parallel.mesh import (
    PARALLEL_SLICE, Backend, parse_topology_env, resolve_world_axes,
)

log = logging.getLogger(__name__)

# the world's axes: one device a process, so their product is the
# number of processes (fsdp absorbs the rest when it is not given)
WORLD_AXES = ("pipeline", "data", "fsdp", "expert", "context", "tensor",
              "dcn_data", "dcn_fsdp")


@dataclasses.dataclass
class WorldInfo:
    coordinator: str
    num_processes: int
    process_id: int
    job_name: str = ""
    # the model collectives' backend, once ``initialize`` joined a world
    backend: Optional[Backend] = None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def load_downward_env(path: str = "/etc/podinfo/annotations",
                      env: Optional[Mapping[str, str]] = None) -> dict:
    """Fold late-bound pod annotations into the env contract.

    On a real cluster, values decided at gang admission (after the pod
    spec is immutable) travel as ``kubeflow-tpu.org/env.<KEY>``
    annotations surfaced through a downward-API volume, one
    ``key="escaped value"`` per line. Direct env always wins; annotations
    only fill gaps."""
    env = env if env is not None else os.environ
    if not os.path.exists(path):
        return dict(env)
    out = dict(env)
    prefix = "kubeflow-tpu.org/env."
    with open(path) as f:
        for line in f:
            key, eq, raw = line.strip().partition("=")
            if not eq or not key.startswith(prefix):
                continue
            val = raw.strip()
            if val.startswith('"') and val.endswith('"'):
                # downward-API files escape values Go-string style
                val = val[1:-1].replace('\\"', '"').replace("\\\\", "\\")
            out.setdefault(key[len(prefix):], val)
    return out


def world_from_env(env: Optional[Mapping[str, str]] = None) -> WorldInfo:
    """The JAXJob contract (``KFT_COORDINATOR`` / ``KFT_NUM_PROCESSES`` /
    ``KFT_PROCESS_ID``) or, where none of it is set, the PyTorchJob one
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``)."""
    env = env if env is not None else os.environ
    env = load_downward_env(env=env)
    jax_keys = ("KFT_COORDINATOR", "KFT_NUM_PROCESSES", "KFT_PROCESS_ID")
    if not any(k in env for k in jax_keys) and "MASTER_ADDR" in env:
        return WorldInfo(
            coordinator=f"{env['MASTER_ADDR']}:"
                        f"{env.get('MASTER_PORT', '29500')}",
            num_processes=int(env.get("WORLD_SIZE", "1")),
            process_id=int(env.get("RANK", "0")),
            job_name=env.get("KFT_JOB_NAME", ""),
        )
    return WorldInfo(
        coordinator=env.get("KFT_COORDINATOR", "127.0.0.1:8476"),
        num_processes=int(env.get("KFT_NUM_PROCESSES", "1")),
        process_id=int(env.get("KFT_PROCESS_ID", "0")),
        job_name=env.get("KFT_JOB_NAME", ""),
    )


def world_layout(env: Mapping[str, str], num_processes: int,
                 backend: Optional[str] = None) -> dict:
    """``KFT_MESH`` / ``KFT_DCN`` -> the world's axis sizes
    (``WORLD_AXES``), one device a process. ``pipeline``, ``data``,
    ``fsdp``, ``expert``, ``context`` and ``tensor`` follow
    ``MeshConfig.resolved``'s rule (``parallel.mesh.resolve_world_axes``):
    ``pipeline``, ``expert``, ``context`` and ``tensor`` are fixed, and
    unset,
    ``fsdp`` takes every process the others leave, as the JAX mesh's
    default puts every device on fsdp. Raises NotImplementedError
    (``PARALLEL_SLICE``) for any other axis above 1 and, where
    ``backend`` (the world's, once chosen) is "nccl", for ``pipeline``;
    ValueError when the sizes do not multiply to the number of
    processes."""
    sizes = parse_topology_env(env)
    other = {k: v for k, v in sizes.items()
             if k not in WORLD_AXES and v > 1}
    under = ""
    if sizes.get("pipeline", 1) > 1 and backend == "nccl":
        other["pipeline"], under = sizes["pipeline"], " under NCCL"
    if other:
        raise NotImplementedError(
            f"KFT_MESH={env.get('KFT_MESH', '')!r} "
            f"KFT_DCN={env.get('KFT_DCN', '')!r}: a training world over "
            f"{sorted(other)}{under} {PARALLEL_SLICE}")
    layout = {k: sizes.get(k, 1) for k in WORLD_AXES}
    data, fsdp = sizes.get("data", 1), sizes.get("fsdp", -1)
    if -1 in (data, fsdp):
        slices = layout["dcn_data"] * layout["dcn_fsdp"]
        if slices <= 0 or num_processes % slices:
            raise ValueError(f"mesh {sizes} does not divide "
                             f"{num_processes} processes")
        layout["data"], layout["fsdp"] = resolve_world_axes(
            num_processes // slices, data, fsdp, layout["tensor"],
            layout["expert"], layout["context"], layout["pipeline"])
    total = 1
    for v in layout.values():
        total *= v
    if total != num_processes:
        raise ValueError(f"mesh {layout} holds {total} devices; the world "
                         f"has {num_processes} processes, one device each")
    return layout


def process_device(world: WorldInfo,
                   env: Optional[Mapping[str, str]] = None) -> torch.device:
    """This process's device: the CPU when ``KFT_FORCE_PLATFORM=cpu``,
    else card ``process_id % device_count`` (raises without a card)."""
    env = env if env is not None else os.environ
    asked = platform_device(env.get("KFT_FORCE_PLATFORM"))
    if asked == "cpu":
        return resolve_device("cpu")
    resolve_device("cuda")                      # raises without a card
    return resolve_device(
        f"cuda:{world.process_id % torch.cuda.device_count()}")


def card_identity(device: torch.device) -> str:
    """Where this process computes: ``cpu``, or the host and the card's
    UUID (two ranks whose identities are equal share a card)."""
    if device.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{props.uuid}"


def choose_backend(identities: list) -> Backend:
    """The backend of the model's collectives from every rank's
    ``card_identity``: NCCL when each rank has a card of its own, gloo
    when two ranks share one or the ranks run on the CPU. A world that
    mixes the CPU and cards raises."""
    cpu = sum(i == "cpu" for i in identities)
    n = len(identities)
    if cpu == n:
        return Backend("gloo", f"the {n} ranks run on the CPU")
    if cpu:
        raise ValueError(f"{cpu} of {n} ranks run on the CPU and the rest "
                         "on cards; a world runs on one or the other")
    shared = n - len(set(identities))
    if shared:
        return Backend("gloo", f"{n} ranks on {n - shared} card(s): NCCL "
                               "refuses two ranks on one card")
    return Backend("nccl", f"each of the {n} ranks has a card of its own")


def join_world(init_method: str, rank: int, size: int,
               device: torch.device, timeout_s: float = 300.0) -> Backend:
    """Create the world's default process group (gloo, at
    ``init_method``: ``tcp://host:port`` or ``file://path``), exchange
    every rank's ``card_identity`` over it, and return the backend the
    model's collectives take (``choose_backend``), logged with its
    reason. A CPU rank computes on one thread: idle OpenMP workers in
    every rank crowd out gloo's own threads."""
    if device.type == "cpu":
        torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=init_method, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    identities = [None] * size
    torch.distributed.all_gather_object(identities, card_identity(device))
    backend = choose_backend(identities)
    log.info("rank %d/%d: %s collectives (%s)", rank, size, backend.name,
             backend.reason)
    return backend


def initialize(env: Optional[Mapping[str, str]] = None,
               timeout_s: float = 300.0):
    """The world from the env, its device, and for more than one process
    the world joined at ``tcp://{coordinator}`` within ``timeout_s``
    (``join_world``; the backend chosen lands on ``world.backend``).
    Returns ``(world, device)``; the layout (``world_layout``) is
    checked before any process group starts, and again against the
    backend the world chose."""
    env = load_downward_env(env=env if env is not None else os.environ)
    world = world_from_env(env)
    world_layout(env, world.num_processes)
    device = process_device(world, env)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world.num_processes > 1:
        world.backend = join_world(
            f"tcp://{world.coordinator}", world.process_id,
            world.num_processes, device, timeout_s)
        world_layout(env, world.num_processes, world.backend.name)
    return world, device


def world_mesh(world: WorldInfo, device: torch.device,
               env: Optional[Mapping[str, str]] = None):
    """The ``parallel.mesh.WorldMesh`` of an initialized world of more
    than one process, laid out by ``KFT_MESH`` / ``KFT_DCN``
    (``world_layout``), or None for one process."""
    from kubeflow_tpu_torch.parallel.mesh import WorldMesh

    if world.num_processes == 1:
        return None
    env = load_downward_env(env=env if env is not None else os.environ)
    return WorldMesh.from_layout(
        world_layout(env, world.num_processes, world.backend.name),
        world.process_id, device, world.backend)


def wait_for_workers(world: WorldInfo) -> None:
    """Check the world's size through ``torch.distributed``: every
    process of ``world`` has joined the default group. The waiting is
    ``init_process_group``'s, within ``initialize``'s timeout (the JAX
    package polls its device count instead). One process needs no
    group."""
    if world.num_processes == 1:
        return
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call initialize() first")
    size = dist.get_world_size()
    if size != world.num_processes:
        raise TimeoutError(f"the process group holds {size} of "
                           f"{world.num_processes} processes")

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
``cuda:{process_id % device_count}``) and, for more than one process,
calls ``torch.distributed.init_process_group`` at
``tcp://{coordinator}``: NCCL on cards, gloo on the CPU.

The world's layout: each process is one device, and a ``KFT_MESH`` whose
``data`` x ``fsdp`` product (times ``KFT_DCN``'s) is the number of
processes is accepted as that layout. Any other axis above 1 raises
``parallel.mesh.PARALLEL_SLICE``: only the tensor axis is ported, and
that one serves, it does not train.

``KFT_COMPILE_CACHE`` has no counterpart here: the JAX worker points
XLA's persistent compile cache at it, and the port compiles no XLA
programs (its kernels build once per checkout, under ``_build/``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Mapping, Optional

import torch

from kubeflow_tpu_torch.device import platform_device, resolve_device
from kubeflow_tpu_torch.parallel.mesh import (
    PARALLEL_SLICE, parse_topology_env,
)

# the world's axes: one device a process, so their product is the
# number of processes (fsdp absorbs the rest when it is not given)
WORLD_AXES = ("data", "fsdp", "dcn_data", "dcn_fsdp")


@dataclasses.dataclass
class WorldInfo:
    coordinator: str
    num_processes: int
    process_id: int
    job_name: str = ""

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


def world_layout(env: Mapping[str, str], num_processes: int) -> dict:
    """``KFT_MESH`` / ``KFT_DCN`` -> the world's axis sizes
    (``WORLD_AXES``), one device a process. Unset, the world is
    ``fsdp=num_processes``, as the JAX mesh's default puts every device
    on fsdp. Raises NotImplementedError (``PARALLEL_SLICE``) for any
    other axis above 1 and ValueError when the sizes do not multiply to
    the number of processes."""
    sizes = parse_topology_env(env)
    other = {k: v for k, v in sizes.items()
             if k not in WORLD_AXES and v > 1}
    if other:
        raise NotImplementedError(
            f"KFT_MESH={env.get('KFT_MESH', '')!r} "
            f"KFT_DCN={env.get('KFT_DCN', '')!r}: a training world over "
            f"{sorted(other)} {PARALLEL_SLICE}")
    layout = {k: sizes.get(k, 1) for k in WORLD_AXES}
    if sizes.get("fsdp", -1) == -1:
        rest = 1
        for k in WORLD_AXES:
            if k != "fsdp":
                rest *= layout[k]
        if rest <= 0 or num_processes % rest:
            raise ValueError(f"mesh {sizes} does not divide "
                             f"{num_processes} processes")
        layout["fsdp"] = num_processes // rest
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


def initialize(env: Optional[Mapping[str, str]] = None,
               timeout_s: float = 300.0):
    """The world from the env, its device, and for more than one process
    ``torch.distributed.init_process_group`` at ``tcp://{coordinator}``
    (NCCL on cards, gloo on the CPU) within ``timeout_s``. Returns
    ``(world, device)``; the layout (``world_layout``) is checked before
    any process group starts."""
    env = load_downward_env(env=env if env is not None else os.environ)
    world = world_from_env(env)
    world_layout(env, world.num_processes)
    device = process_device(world, env)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world.num_processes > 1:
        torch.distributed.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{world.coordinator}",
            world_size=world.num_processes, rank=world.process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    return world, device


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

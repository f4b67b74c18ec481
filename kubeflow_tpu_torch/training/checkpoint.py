"""Checkpoint and resume (counterpart of
``kubeflow_tpu.training.checkpoint``, which writes through Orbax, a JAX
library; the port has its own format).

Format: one directory per step, ``{directory}/{step}/``, holding
``state.pt`` (a flat ``{leaf name: CPU tensor}`` dict written by
``torch.save`` and read back with ``weights_only=True``) and
``manifest.json`` (the step, each leaf's shape, dtype and kind, and the
tree's structure: nested dicts, tuples and lists). A step is written
under a temporary name (``.tmp-...``) and renamed when complete, so
``latest_step`` never sees a half-written step, and a process killed
mid-write leaves only a temporary directory that nothing reads.

Timing of the copy: the device-to-host copy is finished when ``save``
returns, and only serializing runs in the background thread. The
trainer's optimizer writes the parameters and its state in place
(``training/optim.py``; a replayed step graph must), so a copy deferred
to the thread would read a later step.

Remote durability, as in the reference: ``mirror=`` replicates every
finished step to a second directory (a mounted bucket in production) in
a background thread, and ``restore`` falls back to the mirror when the
local directory is empty or stale. The default copier handles local and
``file://`` paths; ``copy_fn`` swaps in an object-store client. A
``gs://`` or ``s3://`` ``directory`` raises: there is no client here.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Callable, Optional

import numpy as np
import torch

_REMOTE_SCHEMES = ("gs://", "s3://")
_STATE = "state.pt"
_MANIFEST = "manifest.json"
_FORMAT = 1


def _no_client(path: str) -> str:
    return (f"no object-store client in this environment for {path!r}; "
            "pass copy_fn= (or mount the bucket and use its path)")


def _default_mirror_alarm(exc: Exception) -> None:
    """Operator contract (as KFT_HEARTBEAT_FILE): pods get
    KFT_WARNING_FILE injected; appending a line raises a Warning condition
    on the owning job, so a degraded mirror shows before the local disk
    it guards is needed."""
    path = os.environ.get("KFT_WARNING_FILE")
    if not path:
        return
    rec = {
        "ts": time.time(),
        "reason": "CheckpointMirrorDegraded",
        "message": f"{type(exc).__name__}: {exc}",
    }
    if path.startswith(("http://", "https://")):
        from kubeflow_tpu_torch.training.loop import post_heartbeat

        post_heartbeat(path, warning=rec)
        return
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _is_remote(path: str) -> bool:
    return path.startswith(_REMOTE_SCHEMES)


def _strip_file_scheme(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


def _complete(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _MANIFEST))


def _steps_in(directory: str) -> list[int]:
    """The complete steps under ``directory`` (digit-named directories
    holding a manifest), ascending."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and _complete(os.path.join(directory, n)))


def _to_host(tree, prefix: str, flat: dict, leaves: dict):
    """Copy every leaf of ``tree`` to a new CPU tensor in ``flat`` (by its
    "/"-joined path, as ``optim.named_leaves`` names it), describe it in
    ``leaves``, and return the tree's structure."""
    if isinstance(tree, dict):
        return {"dict": {str(k): _to_host(v, f"{prefix}{k}/", flat, leaves)
                         for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return {kind: [_to_host(v, f"{prefix}{i}/", flat, leaves)
                       for i, v in enumerate(tree)]}
    name = prefix[:-1]
    if isinstance(tree, torch.Tensor):
        t, kind = tree.detach(), "tensor"
        t = t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
    else:
        t, kind = torch.from_numpy(np.array(tree)), "numpy"
    flat[name] = t
    leaves[name] = {"shape": list(t.shape), "dtype": str(t.dtype)[6:],
                    "kind": kind}
    return {"leaf": name}


def _build(spec, flat: dict, leaves: dict):
    """The tree ``spec`` describes, its leaves taken from ``flat``."""
    if "dict" in spec:
        return {k: _build(v, flat, leaves) for k, v in spec["dict"].items()}
    if "tuple" in spec:
        return tuple(_build(v, flat, leaves) for v in spec["tuple"])
    if "list" in spec:
        return [_build(v, flat, leaves) for v in spec["list"]]
    name = spec["leaf"]
    t = flat[name]
    return t.numpy() if leaves[name]["kind"] == "numpy" else t


def _fill(template, flat: dict, prefix: str = ""):
    """``template``'s structure with the saved leaf of each path, each
    checked against the template leaf's shape and dtype and placed on its
    device (a numpy template leaf gets a numpy array)."""
    if isinstance(template, dict):
        return {k: _fill(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_fill(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    name = prefix[:-1]
    if name not in flat:
        raise ValueError(f"checkpoint has no leaf {name!r}")
    t = flat[name]
    if isinstance(template, torch.Tensor):
        if tuple(t.shape) != tuple(template.shape) \
                or t.dtype != template.dtype:
            raise ValueError(
                f"leaf {name!r}: saved {tuple(t.shape)} {t.dtype}, template "
                f"{tuple(template.shape)} {template.dtype}")
        return t.to(template.device)
    return t.numpy()


class CheckpointManager:
    """Saves and restores a state (a nested dict/tuple/list of tensors or
    numpy arrays) by step under ``directory``, keeping the newest
    ``max_to_keep`` steps; the reference's methods and behaviour over the
    format of the module docstring.

    ``save_seconds`` and ``write_seconds`` / ``write_bytes`` list, per
    save, the blocking device-to-host copy and the serializing that
    followed it (in the background thread when ``async_save``)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True, mirror: Optional[str] = None,
                 copy_fn: Optional[Callable[[str, str], None]] = None,
                 on_mirror_error: Optional[Callable[[Exception], None]]
                 = None):
        if _is_remote(directory):
            raise NotImplementedError(_no_client(directory))
        self.directory = os.path.abspath(_strip_file_scheme(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.mirror = (_strip_file_scheme(mirror)
                       if mirror and not _is_remote(mirror) else mirror)
        self._copy = copy_fn or self._default_copy
        self.mirror_errors = 0          # background replication failures
        self.last_mirror_error: Optional[str] = None
        self._on_mirror_error = on_mirror_error or _default_mirror_alarm
        self._mirror_lock = threading.Lock()
        self._mirror_kick = threading.Event()
        self._mirror_stop = threading.Event()
        self._mirror_thread: Optional[threading.Thread] = None
        self._writer: Optional[threading.Thread] = None
        self._writing: Optional[int] = None     # the step in the thread
        self._write_error: Optional[BaseException] = None
        self.save_seconds: list = []
        self.write_seconds: list = []
        self.write_bytes: list = []
        if self.mirror is not None and not _is_remote(self.mirror):
            os.makedirs(self.mirror, exist_ok=True)

    # ------------------------------------------------------------- save --

    def all_steps(self) -> list[int]:
        """The complete steps on disk, plus the one being written."""
        steps = set(_steps_in(self.directory))
        if self._writing is not None:
            steps.add(self._writing)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save ``state`` as ``step``. Without ``force`` nothing is saved
        (False) when this step or a newer one exists; ``force`` saves an
        older step too, and raises when this step exists (as Orbax).
        The copy to host memory is complete on return; the write runs in
        the background when ``async_save``, one write at a time."""
        steps = self.all_steps()
        if step in steps and force:
            raise ValueError(f"Checkpoint for step {step} already exists.")
        if not force and steps and steps[-1] >= step:
            return False
        self._join_writer()
        t0 = time.perf_counter()
        flat: dict = {}
        leaves: dict = {}
        tree = _to_host(state, "", flat, leaves)
        self.save_seconds.append(time.perf_counter() - t0)
        manifest = {"format": _FORMAT, "step": int(step), "leaves": leaves,
                    "tree": tree}
        self._writing = int(step)
        if self.async_save:
            self._writer = threading.Thread(
                target=self._write_guarded, args=(int(step), flat, manifest),
                daemon=True, name="ckpt-write")
            self._writer.start()
        else:
            self._write_guarded(int(step), flat, manifest)
            self._raise_write_error()
        if self.mirror is not None:
            self._kick_mirror()
        return True

    def _write_guarded(self, step: int, flat: dict, manifest: dict) -> None:
        try:
            self._write(step, flat, manifest)
        except BaseException as e:     # surfaced by wait/save/close
            self._write_error = e
        finally:
            self._writing = None

    def _write(self, step: int, flat: dict, manifest: dict) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory,
                           f".tmp-{step}-{os.getpid()}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        torch.save(flat, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):       # an incomplete leftover
            shutil.rmtree(final)
        os.replace(tmp, final)
        self.write_seconds.append(time.perf_counter() - t0)
        self.write_bytes.append(os.path.getsize(
            os.path.join(final, _STATE)))
        self._prune()

    def _prune(self) -> None:
        with self._mirror_lock:
            steps = _steps_in(self.directory)
            for old in steps[:max(0, len(steps) - self.max_to_keep)]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)

    def _join_writer(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_write_error()

    def _raise_write_error(self) -> None:
        err, self._write_error = self._write_error, None
        if err is not None:
            raise err

    # ---------------------------------------------------------- restore --

    def restore(self, step: Optional[int] = None, template: Any = None):
        """``(step, state)`` of ``step`` (default the newest), or
        ``(None, None)`` when there is none. Without ``template`` the
        state has the saved structure, its tensors on the CPU; with one,
        the template's structure, each leaf checked against the
        template's shape and dtype and placed on its device."""
        if self.mirror is not None and self._needs_mirror_fetch(step):
            self._fetch_from_mirror(step)
        self._join_writer()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.directory, str(step))
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        flat = torch.load(os.path.join(path, _STATE), map_location="cpu",
                          weights_only=True)
        for name, meta in manifest["leaves"].items():
            t = flat[name]
            if list(t.shape) != meta["shape"] \
                    or str(t.dtype)[6:] != meta["dtype"]:
                raise ValueError(f"step {step}: leaf {name!r} does not "
                                 "match its manifest")
        if template is not None:
            return step, _fill(template, flat)
        return step, _build(manifest["tree"], flat, manifest["leaves"])

    def wait(self):
        self._join_writer()
        if self.mirror is not None:
            self._mirror_sync_guarded()

    def close(self):
        self._mirror_stop.set()
        self._mirror_kick.set()
        if self._mirror_thread is not None:
            self._mirror_thread.join(timeout=30)
        self._join_writer()
        if self.mirror is not None:
            self._mirror_sync_guarded()

    # ----------------------------------------------------------- mirror --

    @staticmethod
    def _default_copy(src: str, dst: str) -> None:
        if _is_remote(dst):
            raise NotImplementedError(_no_client(dst))
        tmp = dst + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        shutil.copytree(src, tmp)
        os.replace(tmp, dst)

    def _kick_mirror(self) -> None:
        if self._mirror_thread is None:
            self._mirror_thread = threading.Thread(
                target=self._mirror_loop, daemon=True, name="ckpt-mirror")
            self._mirror_thread.start()
        self._mirror_kick.set()

    def _mirror_loop(self) -> None:
        while not self._mirror_stop.is_set():
            self._mirror_kick.wait()
            self._mirror_kick.clear()
            try:
                writer = self._writer
                if writer is not None:
                    writer.join()
                self.mirror_sync()
            except Exception as e:
                self._record_mirror_error(e)

    def _record_mirror_error(self, e: Exception) -> None:
        """The mirror never kills the step loop, but a dead mirror is the
        failure to surface before the node dies: count it and raise the
        alarm."""
        self.mirror_errors += 1
        self.last_mirror_error = f"{type(e).__name__}: {e}"
        try:
            self._on_mirror_error(e)
        except Exception:
            pass

    def _mirror_sync_guarded(self) -> None:
        try:
            self.mirror_sync()
        except Exception as e:
            self._record_mirror_error(e)

    def mirror_sync(self) -> list[int]:
        """Replicate every finished local step absent from the mirror.
        Idempotent; returns the steps copied this call."""
        if self.mirror is None:
            return []
        copied = []
        with self._mirror_lock:
            for step in _steps_in(self.directory):
                src = os.path.join(self.directory, str(step))
                dst = os.path.join(self.mirror, str(step))
                if not _is_remote(dst) and os.path.exists(dst):
                    continue
                self._copy(src, dst)
                copied.append(step)
        return copied

    def _needs_mirror_fetch(self, want: Optional[int]) -> bool:
        """Restart-aware restore: a replacement worker may land on a node
        whose local directory is EMPTY (a fresh standby) or STALE (it
        served an older incarnation); then the mirror holds the truth.
        Fetch when the local directory lacks the requested step, or, for
        a latest-step restore, when the mirror is ahead of it."""
        local = _steps_in(self.directory)
        if not local:
            return True
        if want is not None:
            return want not in local
        if _is_remote(self.mirror):
            return False
        newest = max(_steps_in(self.mirror), default=None)
        return newest is not None and newest > local[-1]

    def _fetch_from_mirror(self, want: Optional[int] = None) -> Optional[int]:
        """Pull the requested step (or the newest) back from the mirror
        so restore proceeds as from a local step."""
        if self.mirror is None or _is_remote(self.mirror):
            return None
        steps = _steps_in(self.mirror)
        if not steps:
            return None
        if want is not None and want not in steps:
            return None
        step = want if want is not None else steps[-1]
        dst = os.path.join(self.directory, str(step))
        if not _complete(dst):
            if os.path.exists(dst):
                shutil.rmtree(dst)
            self._copy(os.path.join(self.mirror, str(step)), dst)
        return step

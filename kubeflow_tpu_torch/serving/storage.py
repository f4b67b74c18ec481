"""Storage initializer — model download by storageUri.

Parity: SURVEY.md §2.4 'Storage' (kserve.storage + the agent downloader:
gcs/s3/pvc/http/hf). TPU build keeps the same uri scheme dispatch; schemes
whose SDKs aren't in this environment are gated with a clear error instead
of a hard import.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tarfile
import urllib.parse
import urllib.request
import zipfile

_MARKER = ".kft_materialized.json"


def _marker_path(dest_dir: str) -> str:
    return os.path.join(dest_dir, _MARKER)


def _already_materialized(storage_uri: str, dest_dir: str):
    """Remote downloads are recorded with a marker so the init step and the
    server (which both call download) don't fetch the artifact twice."""
    try:
        with open(_marker_path(dest_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("uri_sha") != _uri_sha(storage_uri):
        return None
    path = doc.get("path")
    return path if path and os.path.exists(path) else None


def _uri_sha(storage_uri: str) -> str:
    return hashlib.sha256(storage_uri.encode()).hexdigest()[:16]


def _record(storage_uri: str, dest_dir: str, path: str) -> str:
    with open(_marker_path(dest_dir), "w") as f:
        json.dump({"uri_sha": _uri_sha(storage_uri), "path": path}, f)
    return path


def download(storage_uri: str, dest_dir: str) -> str:
    """Materialize the model behind ``storage_uri`` into ``dest_dir`` and
    return the local path (the storage-initializer initContainer contract:
    runs before the server starts, mounts at /mnt/models). Idempotent for
    remote schemes: a completed download leaves a marker and later calls
    return immediately."""
    os.makedirs(dest_dir, exist_ok=True)
    parsed = urllib.parse.urlparse(storage_uri)
    scheme = parsed.scheme or "file"
    if scheme == "file":
        return _from_local(parsed.path or storage_uri, dest_dir)
    if scheme == "pvc":
        # pvc://volume/path — volume is mounted at /mnt/pvc/<volume> by the
        # pod webhook; locally this is just a directory
        path = os.path.join("/mnt/pvc", parsed.netloc,
                            parsed.path.lstrip("/"))
        return _from_local(path, dest_dir)
    done = _already_materialized(storage_uri, dest_dir)
    if done is not None:
        return done
    if scheme in ("http", "https"):
        fname = os.path.basename(parsed.path) or "model"
        target = os.path.join(dest_dir, fname)
        urllib.request.urlretrieve(storage_uri, target)
        return _record(storage_uri, dest_dir,
                       _maybe_unpack(target, dest_dir))
    if scheme == "hf":
        return _record(
            storage_uri, dest_dir,
            _from_huggingface(parsed.netloc + parsed.path, dest_dir))
    if scheme in ("gs", "s3", "azure"):
        return _from_mounted_bucket(scheme, parsed, dest_dir)
    raise ValueError(f"unsupported storage uri scheme {scheme!r}")


# Mounted-bucket convention: on GKE the pod webhook mounts buckets with
# FUSE (gcsfuse / s3 mountpoint) under these roots, so gs://bucket/path is
# readable as a plain directory — no cloud SDK in the serving image at all
# (the TPU-native choice: the kernel page cache streams weights, and the
# same path works for every framework). Override the root with
# KFT_BUCKET_MOUNT_ROOT, e.g. in tests.
_BUCKET_MOUNT_ROOTS = {"gs": "/gcs", "s3": "/s3", "azure": "/azure"}


def _from_mounted_bucket(scheme: str, parsed, dest_dir: str) -> str:
    root = os.environ.get("KFT_BUCKET_MOUNT_ROOT",
                          _BUCKET_MOUNT_ROOTS[scheme])
    path = os.path.normpath(
        os.path.join(root, parsed.netloc, parsed.path.lstrip("/")))
    # storage_uri is tenant-supplied: ".." must never escape the mount root
    # (gs://../etc would otherwise resolve to /etc)
    if not path.startswith(os.path.normpath(root) + os.sep):
        raise ValueError(
            f"storage uri escapes the {scheme} mount root: {path!r}")
    if not os.path.exists(path):
        raise RuntimeError(
            f"{scheme}://{parsed.netloc} is not mounted at {root} (expected "
            f"{path}); mount the bucket (gcsfuse/mountpoint via the pod "
            f"webhook) or mirror the model to file://")
    return _from_local(path, dest_dir)


def _from_local(path: str, dest_dir: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.isdir(path):
        return path          # serve in place; no copy needed
    return _maybe_unpack(path, dest_dir, copy=True)


def _maybe_unpack(path: str, dest_dir: str, copy: bool = False) -> str:
    if tarfile.is_tarfile(path):
        with tarfile.open(path) as tf:
            tf.extractall(dest_dir, filter="data")
        return dest_dir
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            zf.extractall(dest_dir)
        return dest_dir
    if copy:
        target = os.path.join(dest_dir, os.path.basename(path))
        if os.path.abspath(target) != os.path.abspath(path):
            shutil.copy2(path, target)
        return target
    return path


def _from_huggingface(repo_id: str, dest_dir: str) -> str:
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError(
            "hf:// uris need huggingface_hub (bundled with transformers); "
            f"import failed: {e}") from e
    return snapshot_download(repo_id=repo_id, local_dir=dest_dir)

"""Device selection: CUDA unless the caller asks for the CPU.

The port's entry points never fall back to the CPU on their own: a
serving replica that silently decoded on the host would be a different
system, not a slower one. ``resolve_device`` is the one rule every entry
point applies.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); ``"cpu"`` ->
    the CPU; ``"cuda"``/``"cuda:N"`` -> that GPU (raises when absent).
    Any other device type raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' (or set "
                "KFT_FORCE_PLATFORM=cpu for the serving runtime) to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "visible")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def platform_device(platform: Optional[str]) -> Optional[str]:
    """The runtime's ``KFT_FORCE_PLATFORM`` value -> a device request:
    unset -> None (CUDA or raise), ``cpu`` -> ``"cpu"``, ``cuda``/``gpu``
    -> ``"cuda"``. Other platforms (``tpu``) are not this package's."""
    if not platform:
        return None
    p = platform.strip().lower()
    if p == "cpu":
        return "cpu"
    if p in ("cuda", "gpu"):
        return "cuda"
    raise ValueError(f"KFT_FORCE_PLATFORM={platform!r}: this runtime runs "
                     "on cuda or cpu")

"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` or ``"cuda"`` gives ``cuda:0``; only an explicit ``"cpu"``
    gives the CPU.  Raises ``RuntimeError`` when a CUDA device is asked for
    (explicitly or by default) and none is available: nothing falls back to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run on the CPU")
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on a DeviceMesh: the current card
    for a "cuda" mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)

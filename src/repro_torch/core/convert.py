"""Blade images across the two packages: an arena written by one recovers
in the other.

The JAX package's blade (``repro.core.backend.NVMBackend``) keeps its arena
and each mirror's in a host ``bytearray``; the port's keeps them in
``torch.uint8`` tensors on a device.  The layout is the same byte for byte
(naming region, allocation bitmap, block heap; log areas with checksummed
transactions), so carrying a blade across is a copy of its bytes and a
``reboot()``, which rebuilds every volatile structure from the arena and
replays committed logs, as after a power loss.  This is the blade's
counterpart of ``repro_torch.models.convert`` for model weights.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .backend import NVMBackend

Image = Union[bytes, bytearray, memoryview, np.ndarray]


def _as_tensor(image: Image) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(bytes(image), dtype=np.uint8).copy())


def load_blade(arena: Image, mirrors: Sequence[Image] = (), *,
               device: Optional[Union[str, torch.device]] = None,
               **blade_kwargs) -> NVMBackend:
    """A port blade holding `arena` and one mirror per entry of `mirrors`
    (bytes or uint8 numpy arrays of the arena's length: a reference blade's
    ``arena`` and ``mirrors[i].arena``), rebooted.  `blade_kwargs` are the
    image's geometry as ``NVMBackend`` takes it (``block_size``,
    ``name_slots``, ``blade_id``, ``cost``); the capacity is the image's
    length.  On the card unless ``device="cpu"``."""
    host = _as_tensor(arena)
    blade = NVMBackend(capacity=host.numel(), num_mirrors=len(mirrors), device=device,
                       **blade_kwargs)
    blade.arena.copy_(host)
    for m, image in zip(blade.mirrors, mirrors):
        mt = _as_tensor(image)
        if mt.numel() != host.numel():
            raise ValueError("a mirror image differs in length from the arena")
        m.arena.copy_(mt)
    return blade.reboot()


def blade_image(blade: NVMBackend) -> Tuple[bytes, List[bytes]]:
    """(arena, [mirror arenas]) of a port blade as host bytes: what a
    reference blade's ``bytearray``s take to recover it."""
    return (blade.arena.cpu().numpy().tobytes(),
            [m.arena.cpu().numpy().tobytes() for m in blade.mirrors])

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

A cluster crosses the same way, blade by blade (``cluster_image`` /
``load_cluster``): its shard directory and lease table are blobs in every
blade's naming region, so a cluster built on the images recovers both from
the bytes alone (``NVMCluster.bootstrap_directory``), as a cold-started
authority does.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .backend import NVMBackend

if TYPE_CHECKING:  # pragma: no cover
    from ..cluster.router import NVMCluster

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


def cluster_image(cluster: "NVMCluster") -> Dict[int, Tuple[bytes, List[bytes]]]:
    """{blade id: (arena, [mirror arenas])} of a port cluster as host bytes
    (``blade_image`` of each blade)."""
    return {bid: blade_image(be) for bid, be in sorted(cluster.blades.items())}


def load_cluster(images: Mapping[int, Tuple[Image, Sequence[Image]]], *,
                 device: Optional[Union[str, torch.device]] = None,
                 **cluster_kwargs) -> "NVMCluster":
    """A port cluster whose blade `bid` holds ``images[bid]`` (its arena and
    one image per mirror: a reference cluster's ``blades[bid].arena`` and
    ``mirrors[i].arena``), every blade rebooted, the directory and the
    lease table bootstrapped from the blades' bytes.  `cluster_kwargs` are
    the geometry as ``NVMCluster`` takes it (``block_size``,
    ``name_slots``, ``cost``, ``lease_ttl_ns``); the capacity is the
    images' length.  On the card unless ``device="cpu"``."""
    from ..cluster.router import NVMCluster

    lengths = {len(arena) for arena, _ in images.values()}
    if len(lengths) != 1:
        raise ValueError("a cluster's blades differ in capacity")
    mirrors = {len(ms) for _, ms in images.values()}
    if len(mirrors) != 1:
        raise ValueError("a cluster's blades differ in their number of mirrors")
    cluster = NVMCluster(n_blades=len(images), capacity_per_blade=lengths.pop(),
                         num_mirrors=mirrors.pop(), device=device, **cluster_kwargs)
    cluster.blades = {
        bid: load_blade(arena, ms, device=cluster.device, block_size=cluster.block_size,
                        name_slots=cluster.name_slots, blade_id=bid, cost=cluster.cost)
        for bid, (arena, ms) in sorted(images.items())}
    cluster.bootstrap_directory()
    return cluster

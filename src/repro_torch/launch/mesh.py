"""Device meshes + per-architecture sharding policy.

The port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims over the
default process group, which the caller initialises (``make_mesh`` never
starts one).  ``make_production_mesh`` is a function, never a module-level
constant, so importing this module touches no device or process group.

``rules_for`` resolves the logical-axis -> mesh-axis rule table per
(architecture x mesh); it reads only ``mesh.shape`` and ``mesh.axis_names``
(``mesh_dim_names`` on a DeviceMesh):

  * attention: TP over heads when n_heads divides the model axis; otherwise
    sequence-parallel attention (activations sharded on S over 'model',
    KV gathered per layer) so compute still scales 1/(data*model);
  * decode: when heads cannot shard, the KV cache length axis shards over
    'model' instead (each device scans 1/16th of the cache);
  * MoE: expert-parallel (expert axis over 'model') when E divides the
    model axis, else TP-MoE (expert ffn width over 'model');
  * fsdp: weight embed-axis additionally sharded over the data axes
    (ZeRO-3-style), used by the >30B archs.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.params import sharding_rules

MESH_DEVICES = ("cuda", "cpu", "meta")


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: Optional[str] = None):
    """A DeviceMesh of `shape` named `axes` over the initialised default
    process group, on the card unless `device` is "cpu" or "meta" (a meta
    mesh is a CPU mesh, normally over the fake process group, whose tensors
    the caller makes on the ``meta`` device).  Raises when no process group
    is initialised, when its size is not the product of `shape`, and (for
    the card) when no CUDA device is available."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if device is None else str(device)
    if kind not in MESH_DEVICES:
        raise ValueError(f"mesh device {device!r}: one of {MESH_DEVICES}")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialised; call "
                           "torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"make_mesh: the process group has {dist.get_world_size()} ranks, "
                           f"the mesh {tuple(shape)} needs {math.prod(shape)}")
    if kind == "cuda":
        resolve_device("cuda")  # raises without a card
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh("cuda" if kind == "cuda" else "cpu", tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of a stand-in with ``shape``
    (a dict, as JAX's Mesh.shape) and ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def rules_for(cfg: ModelConfig, mesh, *, kind: str = "train") -> Dict:
    shape = mesh_shape(mesh)
    multi_pod = "pod" in shape
    msize = shape.get("model", 1)
    rules = sharding_rules(fsdp=cfg.fsdp, multi_pod=multi_pod)

    heads_ok = cfg.n_heads_eff % msize == 0
    if not heads_ok:
        rules["act_heads"] = None
        rules["act_kv_heads"] = None
        rules["heads"] = None          # attention weights replicated over TP
        if kind == "decode":
            rules["act_cache_len"] = "model"   # shard the KV cache length
        else:
            rules["act_seq"] = "model"         # sequence-parallel attention
    else:
        if cfg.n_kv_heads % msize != 0:
            rules["act_kv_heads"] = None
            rules["kv_heads"] = None
        if kind == "decode":
            rules["act_cache_len"] = None

    if cfg.moe is not None and cfg.moe.num_experts % msize != 0:
        rules["expert"] = None
        rules["expert_mlp"] = "model"  # TP-MoE width sharding
    return rules

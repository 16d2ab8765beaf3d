"""Parameter metadata, initialisation and sharding rules.

Every parameter carries *logical* axis names (MaxText-style), as in the JAX
package; a rule table maps logical axes to the named dims of a
``torch.distributed.device_mesh.DeviceMesh``, so DP / FSDP / TP / EP are
configuration, not model code.  ``make_shardings`` gives each leaf its
``DTensor`` placements on a mesh, ``place`` puts a tree of tensors there
(the counterpart of ``jax.jit(..., in_shardings=...)``), and ``constrain``
redistributes an activation to the placements of its logical axes (the
counterpart of ``with_sharding_constraint``).  Without a mesh nothing here
builds a DTensor: ``constrain`` returns a plain tensor as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..tree import flatten_named, tree_map, tree_map_named

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | scaled
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} and axes {self.logical_axes} differ in rank")


def _is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def init_params(specs: Tree, generator: torch.Generator) -> Tree:
    """Draws every parameter on the generator's device.

    The same distributions as the JAX package: ``"scaled"`` divides by the
    square root of the fan-in ``shape[-2]`` (for ``wq`` ``(d, h, hd)`` that
    is ``h``), as ``repro.models.params.init_params`` does.  The bits differ
    (``torch.Generator`` against ``jax.random``); tests carry weights across
    with ``models.convert`` instead.
    """
    device = generator.device

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        scale = s.init_scale
        if s.init == "scaled":  # fan-in scaled
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            scale = s.init_scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(scale).to(s.dtype)

    return tree_map(one, specs, is_leaf=_is_spec)


def abstract_params(specs: Tree) -> Tree:
    """Shape-and-dtype stand-ins (tensors on the ``meta`` device)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    specs, is_leaf=_is_spec)


def param_count(specs: Tree) -> int:
    return sum(math.prod(s.shape) for _, s in flatten_named(specs, is_leaf=_is_spec))


# ------------------------------------------------------------------ sharding
# Default logical-axis -> mesh-axis rules.  `fsdp` adds data-axis sharding on
# the weights' embed axis (ZeRO-3-style); optimizer state follows params.
def sharding_rules(*, fsdp: bool = False, multi_pod: bool = False) -> Dict[str, Any]:
    fsdp_axes: Tuple[str, ...] = ()
    if fsdp:
        fsdp_axes = (("pod", "data") if multi_pod else ("data",))
    return {
        # weight axes
        "embed": fsdp_axes or None,     # d_model rows of weight matrices
        "mlp": "model",                 # ffn hidden
        "heads": "model",               # attention heads (fused q dim)
        "kv_heads": None,               # kv heads often < mesh; replicate
        "vocab": "model",               # embedding/output vocab
        "expert": "model",              # MoE expert axis (EP)
        "expert_mlp": None,
        "layers": None,
        "conv": None,
        "state": None,
        "head_dim": None,
        # activation axes
        "act_batch": ("pod", "data") if multi_pod else ("data",),
        "act_seq": None,                # "model" => sequence-parallel attention
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_vocab": "model",
        "act_cache_len": None,          # "model" => decode KV cache sharded on S
    }


Spec = Tuple[Any, ...]  # per tensor dim: None, a mesh axis name, or a tuple of names


def logical_to_spec(axes: Sequence[Optional[str]], rules: Dict[str, Any]) -> Spec:
    """The mesh axes of each tensor dim, as JAX's PartitionSpec entries."""
    parts = []
    used = set()
    for ax in axes:
        r = rules.get(ax) if ax is not None else None
        # never map two tensor dims onto the same mesh axis
        if r is not None:
            flat = (r,) if isinstance(r, str) else tuple(r)
            if any(f in used for f in flat):
                r = None
            else:
                used.update(flat)
        parts.append(r)
    return tuple(parts)


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fit(shape: Sequence[int], spec: Spec, sizes: Dict[str, int]) -> Spec:
    """`spec` with the mesh axes that do not divide their dim dropped (e.g.
    tiny smoke configs); an axis the mesh lacks counts as size 1."""
    fixed = []
    for dim, part in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if part is None:
            fixed.append(None)
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        size = math.prod(sizes.get(a, 1) for a in axes)
        fixed.append(part if dim % size == 0 else None)
    return tuple(fixed)


def spec_placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """The DTensor placements of a spec: on each mesh dim, ``Shard(d)`` for the
    tensor dim d that names it (a dim named by two mesh dims, such as
    ``("pod", "data")``, is sharded on both, the first the major), else
    ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, part in enumerate(spec) if part is not None and
                    name in ((part,) if isinstance(part, str) else tuple(part))), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def placements_of(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
                  rules: Dict[str, Any]) -> Tuple[Any, ...]:
    """The placements of a tensor of `shape` with logical `axes` on `mesh`."""
    return spec_placements(_fit(shape, logical_to_spec(axes, rules), _mesh_sizes(mesh)), mesh)


def make_shardings(specs: Tree, mesh, rules: Dict[str, Any]) -> Tree:
    """Each ParamSpec's placements on `mesh` under `rules`."""
    return tree_map(lambda s: placements_of(s.shape, s.logical_axes, mesh, rules), specs,
                    is_leaf=_is_spec)


def _is_placements(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(p, (Shard, Replicate)) for p in x)


def place(tree: Tree, shardings: Tree, mesh) -> Tree:
    """Every tensor of `tree` as a DTensor on `mesh` with its placements in
    `shardings` (a tree of the same structure, placements tuples at the
    leaves; 0-d tensors may be missing there and are replicated).  Each rank
    holds the whole tensor and keeps its own shard of it: no communication.
    A DTensor passes through redistributed."""
    by_name = dict(flatten_named(shardings, is_leaf=_is_placements))

    def one(name: str, t: torch.Tensor):
        pl = by_name.get(name, (Replicate(),) * mesh.ndim)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return shard(t, pl, mesh)

    return tree_map_named(one, tree)


def shard(t: torch.Tensor, placements: Sequence[Any], mesh) -> DTensor:
    """A DTensor of `t`, which every rank holds whole, on `placements`: each
    rank keeps a copy of its own slice, so the whole can go (where no mesh
    dim of size > 1 shards it, `t` itself: on a 1 x 1 mesh the DTensor
    shares `t`'s memory), and nothing is communicated."""
    t = t.detach()
    if t.device.type not in ("meta", mesh.device_type):
        t = t.to(mesh.device_type)
    local = t
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and mesh.size(i) > 1:
            n = local.shape[p.dim] // mesh.size(i)
            local = local.narrow(p.dim, coord[i] * n, n)
    local = local.contiguous() if local is t else local.clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def local_shape(shape: Sequence[int], placements: Sequence[Any], mesh) -> Tuple[int, ...]:
    """The shape of this rank's shard (dims divide evenly, as `_fit` keeps)."""
    out = list(shape)
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            out[p.dim] //= size
    return tuple(out)


def constrain(x: torch.Tensor, rules: Dict[str, Any], *axes: Optional[str]) -> torch.Tensor:
    """Redistributes a DTensor to the placements of the logical activation
    `axes` (dims past them replicated; mesh axes that do not divide their dim
    dropped), as ``with_sharding_constraint``; a plain tensor is returned as
    it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    target = spec_placements(_fit(x.shape, logical_to_spec(axes, rules), _mesh_sizes(mesh)),
                             mesh)
    from .spmd import to_placements

    return to_placements(x, target)


def cache_placements(name: str, shape: Sequence[int], mesh, rules: Dict[str, Any],
                     bdim: int) -> Tuple[Any, ...]:
    """Placements of a decode-cache leaf by its name, as the JAX package's
    dry run assigns them (``repro.launch.dryrun._cache_shardings``): the
    batch dim `bdim` (the dim after a stacked group's layers axis; JAX takes
    the first dim equal to the batch, the layers axis when the two are
    equal) over the batch axes; attention "k"/"v"
    (..., B, Hkv, S, hd) on their KV heads over act_kv_heads, or else on
    their length over act_cache_len; a recurrent "h" and "conv" over
    "model" on their channels; each only where the mesh axes divide it."""
    sizes = _mesh_sizes(mesh)
    batch_part = logical_to_spec(("act_batch",), rules)[0]
    len_part = rules.get("act_cache_len")
    kv_part = rules.get("act_kv_heads")
    model_ok = lambda dim: dim % sizes.get("model", 1) == 0  # noqa: E731
    nd = len(shape)
    parts: List[Any] = [None] * nd
    batch = shape[bdim]
    axes = (batch_part,) if isinstance(batch_part, str) else tuple(batch_part or ())
    bsz = math.prod(sizes.get(a, 1) for a in axes) if axes else 1
    if batch % max(bsz, 1) == 0 and axes:
        parts[bdim] = batch_part
    if name in ("k", "v") and nd >= 4:
        if kv_part and model_ok(shape[nd - 3]):
            parts[nd - 3] = kv_part
        elif len_part and model_ok(shape[nd - 2]):
            parts[nd - 2] = len_part
    elif name == "h" and nd >= 2:
        # mamba [.., B, di, N] / rglru [.., B, D]
        dim = nd - 2 if nd >= 3 and shape[-1] <= 64 else nd - 1
        if model_ok(shape[dim]) and "model" not in str(parts):
            parts[dim] = "model"
    elif name == "conv":
        if model_ok(shape[-1]):
            parts[-1] = "model"
    return spec_placements(tuple(parts), mesh)

"""Dry run: place every (architecture x input shape) cell on the production
mesh and extract its roofline terms, without a card.  The port of
``repro.launch.dryrun``.

It runs in one process, on the ``meta`` device, over a fake process group
of the production mesh's size (``torch.testing._internal.distributed
.fake_pg``: collectives return at once and move nothing).  Per cell:

  1. the FULL config placed on the mesh: the parameters, the optimizer state
     (ZeRO: the fsdp rules) and the batch, or the decode cache, as DTensors
     with meta shards.  Their local shapes give the per-device argument
     bytes; the JAX package's compile proof becomes this placement proof
     (``--compile-only`` stops here);
  2. two SMALL depths (L1 = one repeating block, L2 = two) traced once each
     under ``analysis.CostMode``: per-device FLOPs, op bytes and collectives;
     their difference is the exact cost of one block, so
     cell cost = base + block * n_blocks (``launch/analysis.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --compile-only
  python -m repro_torch.launch.dryrun --all --multi-pod --out dryrun.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..models import DecoderLM, param_count
from ..models.config import ModelConfig
from ..models.params import local_shape, make_shardings, placements_of
from ..training.optimizer import OptConfig, init_opt_state
from ..training.train_step import TrainConfig, make_train_step, state_shardings
from ..tree import flatten_named, tree_map_named
from .analysis import CellCost, combine_linear, cost_of, diff_cost, per_device_bytes
from .mesh import make_production_mesh, rules_for

BIG_ARCHS = ("kimi-k2-1t-a32b", "grok-1-314b", "llava-next-34b", "stablelm-12b")


# --------------------------------------------------------------------- config
def runtime_config(arch: str, kind: str, *, overrides: Optional[dict] = None) -> ModelConfig:
    kw: Dict[str, Any] = dict(remat="dots" if kind == "train" else "none",
                              fsdp=(kind == "train" or arch in BIG_ARCHS))
    kw.update(overrides or {})
    return get_config(arch, **kw)


def opt_config(arch: str) -> OptConfig:
    if arch in ("kimi-k2-1t-a32b", "grok-1-314b"):
        # AdamW state alone would blow HBM at this scale
        return OptConfig(kind="adafactor", momentum_dtype="bfloat16")
    return OptConfig(kind="adamw")


def start_fake_world(size: int) -> None:
    """A fake process group of `size` ranks in this process (rank 0), unless
    one of that size is up already."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up; "
                               f"the mesh needs {size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def on_mesh(x: torch.Tensor, placements, mesh) -> DTensor:
    """A DTensor of x's shape and dtype with a meta shard."""
    local = torch.empty(local_shape(x.shape, placements, mesh), dtype=x.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def _abstract(tree, shardings, mesh):
    """`tree`'s meta tensors as DTensors on `mesh`, placed by `shardings`
    (missing leaves replicated), as ``models.params.place`` places real ones."""
    by_name = dict(flatten_named(shardings, is_leaf=lambda v: isinstance(v, tuple)))
    return tree_map_named(lambda n, t: on_mesh(t, by_name.get(n, (Replicate(),) * mesh.ndim),
                                               mesh), tree)


def _batch(cfg: ModelConfig, batch: int, seq: int, mesh, rules, labels=True) -> Dict[str, DTensor]:
    """The batch sharded over act_batch where it divides (as ``_batch_specs``)."""
    if cfg.embed_inputs:
        shapes = {"tokens": ((batch, seq), torch.int32)}
    else:
        shapes = {"embeds": ((batch, seq, cfg.d_model), torch.bfloat16)}
    if labels:
        shapes["labels"] = ((batch, seq), torch.int32)
    return {k: on_mesh(torch.empty(s, dtype=dt, device="meta"),
                       placements_of(s, ("act_batch",), mesh, rules), mesh)
            for k, (s, dt) in shapes.items()}


# ----------------------------------------------------------------- lowerings
def lower_cell(arch: str, shape_id: str, mesh, *, depth_override: Optional[int] = None,
               overrides: Optional[dict] = None, trace: bool = False) -> Dict[str, Any]:
    """Places one cell on `mesh` (meta shards) and, with `trace`, runs it
    once under CostMode.  Returns its per-device argument bytes by part,
    the placement seconds and, traced, its CellCost ("cost")."""
    seq, gbatch, kind = SHAPES[shape_id]
    cfg = runtime_config(arch, kind, overrides=overrides)
    if depth_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth_override,
                                  first_k_dense=min(cfg.first_k_dense, depth_override))
    if kind == "decode":
        cfg = dataclasses.replace(cfg, max_cache_len=seq)
    rules = rules_for(cfg, mesh, kind=kind)
    model = DecoderLM(cfg)
    t0 = time.perf_counter()
    params = _abstract(model.abstract(), make_shardings(model.param_specs(), mesh, rules), mesh)
    rec: Dict[str, Any] = {"params_bytes": per_device_bytes(params)}
    if kind == "train":
        tcfg = TrainConfig(opt=opt_config(arch))
        abstract = {"params": model.abstract(), "opt": init_opt_state(model.abstract(), tcfg.opt),
                    "step": torch.zeros((), dtype=torch.int32, device="meta")}
        state = _abstract(abstract, state_shardings(model, tcfg, rules, mesh), mesh)
        batch = _batch(cfg, gbatch, seq, mesh, rules)
        rec["opt_bytes"] = per_device_bytes(state["opt"])
        rec["batch_bytes"] = per_device_bytes(batch)
        run = lambda: make_train_step(model, tcfg, rules, mesh)(state, batch)  # noqa: E731
    elif kind == "prefill":
        batch = _batch(cfg, gbatch, seq, mesh, rules, labels=False)
        rec["batch_bytes"] = per_device_bytes(batch)
        run = lambda: model.prefill(params, batch, rules, mesh)  # noqa: E731
    else:  # decode
        cache = model.init_cache(gbatch, seq, device="meta", rules=rules, mesh=mesh)
        if cfg.embed_inputs:
            tok = on_mesh(torch.empty((gbatch,), dtype=torch.int32, device="meta"),
                          (Replicate(),) * mesh.ndim, mesh)
        else:
            tok = on_mesh(torch.empty((gbatch, 1, cfg.d_model), dtype=torch.bfloat16,
                                      device="meta"), (Replicate(),) * mesh.ndim, mesh)
        rec["cache_bytes"] = per_device_bytes(cache["groups"])
        rec["batch_bytes"] = per_device_bytes({"tokens": tok})
        run = lambda: model.decode_step(params, cache, tok, rules, mesh)  # noqa: E731
    rec["argument_bytes_per_device"] = sum(v for k, v in rec.items() if k.endswith("_bytes"))
    rec["place_seconds"] = time.perf_counter() - t0
    if trace:
        with torch.no_grad() if kind != "train" else contextlib.nullcontext():
            rec["cost"] = cost_of(run)
    return rec


def _block_depths(cfg: ModelConfig) -> Tuple[int, int, float, float]:
    """(L1, L2, n_blocks_for_full, tail_layers) for the diff method."""
    plen = len(cfg.block_pattern)
    fkd = cfg.first_k_dense
    L1 = fkd + plen
    L2 = fkd + 2 * plen
    rest = cfg.n_layers - fkd
    n_blocks = rest / plen  # fractional tail approximated per-layer
    return L1, L2, n_blocks, rest % plen


def analyze_cell(arch: str, shape_id: str, mesh, overrides: Optional[dict] = None
                 ) -> Dict[str, Any]:
    seq, gbatch, kind = SHAPES[shape_id]
    cfg = runtime_config(arch, kind, overrides=overrides)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_id,
                           "mesh": "x".join(map(str, mesh.shape)),
                           "kind": kind, "seq": seq, "global_batch": gbatch,
                           "overrides": overrides or {}}
    # 1. the full config placed on the mesh (the placement proof + bytes)
    full = lower_cell(arch, shape_id, mesh, overrides=overrides)
    rec["compile_seconds"] = full.pop("place_seconds")
    rec["memory_analysis"] = full
    # 2. exact per-block costs from two small depths
    L1, L2, n_blocks, _tail = _block_depths(cfg)
    cost1 = lower_cell(arch, shape_id, mesh, depth_override=L1, overrides=overrides,
                       trace=True)["cost"]
    cost2 = lower_cell(arch, shape_id, mesh, depth_override=L2, overrides=overrides,
                       trace=True)["cost"]
    block = diff_cost(cost1, cost2)
    base = diff_cost(block, cost1)  # base = cost1 - block
    total = combine_linear(base, block, n_blocks)
    rec["per_device"] = {
        "flops": total.flops,
        "hbm_bytes": total.hbm_bytes,
        "wire_bytes": total.wire_bytes,
        "collectives": total.collectives,
    }
    rec["roofline"] = total.roofline()
    # model flops: 6*N*D (dense) / 6*N_active*D (MoE), global then per device
    n_devices = math.prod(mesh.shape)
    N = param_count(DecoderLM(cfg).param_specs())
    n_active = N
    if cfg.moe is not None:
        me = cfg.moe
        full_expert = me.num_experts * 3 * cfg.d_model * me.d_expert
        act_expert = (me.top_k + me.num_shared) * 3 * cfg.d_model * me.d_expert
        moe_layers = sum(1 for k_ in cfg.layer_kinds() if k_[1] == "moe")
        n_active = N - moe_layers * (full_expert - act_expert)
    tokens = gbatch * seq if kind != "decode" else gbatch
    mult = {"train": 6, "prefill": 2, "decode": 2}[kind]
    model_flops = mult * n_active * tokens / n_devices
    rec["model_flops_per_device"] = model_flops
    rec["useful_flops_fraction"] = model_flops / total.flops if total.flops else 0.0
    rec["params_billion"] = N / 1e9
    return rec


# ---------------------------------------------------------------------- main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--compile-only", action="store_true",
                    help="full-config placement and per-device bytes only (no trace)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    start_fake_world(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device="meta")
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES if shape_applicable(a, s)]
    else:
        cells = [(args.arch, args.shape)]

    results = []
    for arch, shape in cells:
        t0 = time.time()
        try:
            if args.compile_only:
                placed = lower_cell(arch, shape, mesh)
                rec = {"arch": arch, "shape": shape, "mesh": "x".join(map(str, mesh.shape)),
                       "status": "ok", "compile_seconds": placed.pop("place_seconds"),
                       **placed}
            else:
                rec = analyze_cell(arch, shape, mesh)
                rec["status"] = "ok"
        except Exception as e:  # noqa: BLE001 — report and continue; the exit code says
            rec = {"arch": arch, "shape": shape, "status": "fail",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        rec["wall_seconds"] = time.time() - t0
        results.append(rec)
        extra = ""
        if rec["status"] == "ok" and "roofline" in rec:
            r, pd = rec["roofline"], rec["per_device"]
            colls = {k: int(v["count"]) for k, v in pd["collectives"].items()}
            extra = (f" flops={pd['flops']:.4g} bytes={pd['hbm_bytes']:.4g}"
                     f" wire={pd['wire_bytes']:.4g} collectives={colls}"
                     f" bottleneck={r['bottleneck']}"
                     f" t_c={r['compute_s']:.4f}s t_m={r['memory_s']:.4f}s"
                     f" t_n={r['collective_s']:.4f}s"
                     f" useful={rec['useful_flops_fraction']:.2f}")
        elif rec["status"] == "ok":
            extra = f" argument_bytes_per_device={rec['argument_bytes_per_device']}"
        print(f"[dryrun] {arch} x {shape} [{rec.get('mesh', '')}] -> {rec['status']}"
              f" ({rec['wall_seconds']:.1f}s){extra}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=_jsonable)
    ok = sum(1 for r in results if r["status"] == "ok")
    print(f"[dryrun] {ok}/{len(results)} cells ok")
    return 0 if ok == len(results) else 1


def _jsonable(x):
    if isinstance(x, CellCost):
        return dataclasses.asdict(x)
    return float(x)


if __name__ == "__main__":
    sys.exit(main())

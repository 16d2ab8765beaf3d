#!/usr/bin/env python3
"""Where the distribution layer's host time goes on the card.

Serves llama3.2-3b (published widths, cut to --layers) through a 1 x 1
("data", "model") mesh on a one-rank NCCL process group: a prefill, warm-up
decode steps, then --steps timed decode steps.  Prints one JSON object:
ms a step on the mesh and without it, how many times a step DTensor ran
its sharding and tensor-meta propagation outside its cache (by op), and
the host functions with the most self time (cProfile, ms a step; cProfile's
own cost inflates each).  Run from the root of a checkout, on a machine
with a CUDA card:

    python3 scripts/mesh_host_cost.py --layers 2 --steps 3
"""

import argparse
import collections
import cProfile
import dataclasses
import json
import os
import pstats
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if not torch.cuda.is_available():
        print("mesh_host_cost: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models import DecoderLM
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.serving.engine import _whole

    misses = {"tensor_meta": collections.Counter(), "sharding": collections.Counter()}
    for kind, name in (("tensor_meta", "_propagate_tensor_meta_non_cached"),
                       ("sharding", "propagate_op_sharding_non_cached")):
        orig = getattr(ShardingPropagator, name)

        def spy(self, op_schema, _orig=orig, _kind=kind):
            misses[_kind][str(op_schema.op)] += 1
            return _orig(self, op_schema)

        setattr(ShardingPropagator, name, spy)

    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=args.layers)
    model = DecoderLM(cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64)).astype(np.int64)
    out = {"arch": "llama3.2-3b", "layers": args.layers, "batch": 4, "prompt_len": 64,
           "steps": args.steps, "device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            params = model.init(torch.Generator(device="cuda").manual_seed(0))
            scfg = ServeConfig(batch_slots=4, max_new_tokens=8)
            for path, eng in (("plain", ServeEngine(model, params, scfg, device="cuda")),
                              ("mesh", ServeEngine(model, params, scfg,
                                                   rules_for(cfg, mesh, kind="decode"), mesh))):
                with torch.inference_mode():
                    toks = eng._tokens(torch.as_tensor(prompts, device="cuda"))
                    logits, cache = model.prefill(eng.params, {"tokens": toks}, eng.rules,
                                                  eng.mesh)

                    def step():
                        nonlocal logits, cache
                        nxt = torch.argmax(_whole(logits), dim=-1)
                        logits, cache = model.decode_step(eng.params, cache, eng._tokens(nxt),
                                                          eng.rules, eng.mesh)

                    for _ in range(3):
                        step()
                    torch.cuda.synchronize()
                    for c in misses.values():
                        c.clear()
                    t0 = time.perf_counter()
                    for _ in range(args.steps):
                        step()
                    torch.cuda.synchronize()
                    rec = {"ms_a_step": (time.perf_counter() - t0) * 1e3 / args.steps,
                           "misses_a_step": {k: {op: n / args.steps for op, n in c.most_common()}
                                             for k, c in misses.items()}}
                    prof = cProfile.Profile()
                    prof.enable()
                    for _ in range(args.steps):
                        step()
                    torch.cuda.synchronize()
                    prof.disable()
                stats = pstats.Stats(prof).stats
                rec["host_top_self_ms"] = [
                    [f"{os.path.basename(f[0])}:{f[1]}:{f[2]}", v[2] * 1e3 / args.steps]
                    for f, v in sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]]
                out[path] = rec
        finally:
            dist.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What the model path's spans cost when they are on, on the card.

Builds one benchmark cell's model at its shape, on the seed's weights
(``bench/configs``, ``bench/weights.py``, ``bench/traffic``), warms it, then
times train steps (each ending in the loss read) or ``generate`` calls
(8 prompts of the deck's median length) in turns: ``--n`` with spans off,
``--n`` inside ``obs.observe(spans=True)``, ``--reps`` times.  Prints one
JSON object: the card and its power limit, the host-clock ms of every call
off and on, their medians and the cost of spans on in percent, and what the
spans read: each phase's device ms a root (the median over the calls on)
and their sum beside the median call.  Run from the root of a checkout, on
a machine with a CUDA card:

    python3 scripts/span_cost.py --cell falcon-mamba-7b.train --reps 4 --n 3
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = {"train": ("train.step", ("train.forward", "train.backward", "train.optimizer",
                                   "train.grad_norm")),
          "serve": ("serve.generate", ("serve.prefill", "serve.decode_step", "serve.copy_out"))}


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
    except OSError:
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=2_718_281_829)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--n", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from bench import core, traffic, weights
    from repro_torch import obs
    from repro_torch.models.model import DecoderLM
    from repro_torch.obs import profile as spans

    files = core.cell_files(args.cell, json.loads((ROOT / "BENCHMARK.json").read_text()))
    cfg, tr = files["config"], files["traffic"]
    mc, dev, seed = cfg["model_config"], torch.device("cuda"), args.seed
    layout = core.reference(cfg).layout(mc)
    model = DecoderLM(core.model_config(mc))
    params = weights.nest(weights.make(layout, seed, dev))
    entry = tr["entry"]
    if entry == "train":
        from repro_torch.training import OptConfig, TrainConfig, make_train_step
        from repro_torch.training.optimizer import init_opt_state

        tcfg = TrainConfig(opt=OptConfig(**cfg["optimizer"]))
        state = {"params": params, "opt": init_opt_state(params, tcfg.opt),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step = make_train_step(model, tcfg)
        batch = traffic.train_batch(tr, mc["vocab_size"], seed, 0, dev)

        def call():
            nonlocal state
            state, m = step(state, batch)
            float(m["loss"])
    else:
        from repro_torch.serving.engine import ServeConfig, ServeEngine

        engine = ServeEngine(model, params, ServeConfig(batch_slots=tr["batch"],
                                                        max_new_tokens=tr["max_new_tokens"]),
                             device=dev)
        deck = traffic.deck(tr)
        prompts = traffic.prompts(tr, mc["vocab_size"], seed, 0, deck[len(deck) // 2])

        def call():
            engine.generate(prompts)

    for _ in range(2):
        call()
    off, on = [], []
    root, phases = PHASES[entry]
    read = {name: [] for name in phases}
    for _ in range(args.reps):
        for _ in range(args.n):
            t = time.perf_counter()
            call()
            off.append((time.perf_counter() - t) * 1e3)
        with obs.observe(spans=True):
            for _ in range(args.n):
                t = time.perf_counter()
                call()
                on.append((time.perf_counter() - t) * 1e3)
            for name in phases:
                read[name] += spans.phase_ms(root, name, args.n)
    phase = {name: float(np.median(ms)) for name, ms in read.items()}
    top = [phase[n] for n in phases if n != "train.grad_norm"]  # it lies in the optimizer
    out = {"cell": args.cell, "card": card(), "shape": (tr["batch"], tr.get("seq"))
           if entry == "train" else (tr["batch"], len(prompts[0])),
           "off_ms": off, "on_ms": on, "off_p50": float(np.median(off)),
           "on_p50": float(np.median(on)),
           "cost_pct": 100.0 * (float(np.median(on)) / float(np.median(off)) - 1.0),
           "phase_device_ms": phase, "phase_sum_ms": sum(top),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

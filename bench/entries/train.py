"""The training entry: a closed loop of ``make_train_step``'s
``train_step`` on the benchmark's weights and batches.

Set-up builds one train state from the seed's weights, runs the check's
first steps through the window's own call and feed (they warm every shape
the window runs), and hands the same state to the window.  Each window
step ends in the loss read, which waits for the step's optimizer update.

The check (after the window, with the program's state freed): the
reference trains the same weights on the same batches for the same steps,
and the numbers that the cell's file gives a limit are compared.  They
are read from what the step returns alone (its loss and the parameters),
never from the optimizer's own state, whose layout is the program's to
change; the first step's change stands for the first gradient as the
optimizer got it:

  loss_gap          the largest relative gap of a step's loss;
  change1_gap       how far the first step moved each tensor (the norm of
                    the change), by the worst tensor;
  change1_gap_median  the same, the median tensor's gap;
  change_gap        how far all the steps moved each tensor, by the worst
                    tensor;
  change_gap_median the same, the median tensor's gap.

A tensor's gap is |program - reference| over the larger of the reference's
value for that tensor and the median tensor's.  Tensors whose reference
gradient at the first step is under a thousandth of the median tensor's
move by rounding alone and are left out of the changes.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np

from .. import core, traffic as traffic_mod, weights
from ..reference import common
from ..trace import Trace
from ..yardstick import train_step_flops

PROFILED_STEPS = 2   # steps of each traced pass, after the window


def change_norms(current: Dict, layout, seed: int, device) -> Dict[str, float]:
    """Each tensor's distance from its starting draw, a slice at a time."""
    out = {}
    for leaf in layout:
        start, now = weights.draw(leaf, seed, device), current[leaf[0]]
        pieces = zip(start, now) if start.dim() >= 3 else [(start, now)]
        out[leaf[0]] = math.sqrt(sum(float(((b.float() - a.float()) ** 2).sum())
                                     for a, b in pieces))
        del start
    return out


def run(ctx: core.Context) -> core.Run:
    import torch
    from repro_torch.models.model import DecoderLM
    from repro_torch.training import OptConfig, TrainConfig, make_train_step
    from repro_torch.training.optimizer import init_opt_state

    cfg, tr, cell = ctx.files["config"], ctx.files["traffic"], ctx.files["cell"]
    mc, dev, seed = cfg["model_config"], ctx.device, ctx.seed
    ref = core.reference(cfg)
    layout = ref.layout(mc)
    model = DecoderLM(core.model_config(mc))
    weights.check_layout(layout, core.program_specs(model.param_specs()))
    rec = core.Run(entry="train", config=cfg, traffic=tr)
    n_check = cell["check"]["steps"]
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def feed(i):
        batch = traffic_mod.train_batch(tr, mc["vocab_size"], seed, i, dev)
        if "half_batch" in ctx.faults:  # a planted fault: half the rows left out
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return batch

    flat = weights.make(layout, seed, dev)
    tcfg = TrainConfig(opt=OptConfig(**cfg["optimizer"]))
    params = weights.nest(flat)
    state = {"params": params, "opt": init_opt_state(params, tcfg.opt),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    program_step = make_train_step(model, tcfg)

    def step(state, batch):
        if "frozen_state" in ctx.faults:  # a planted fault: the state comes back unchanged
            with torch.no_grad():
                loss = model.loss(state["params"], batch)
            return state, {"loss": loss, "grad_norm": torch.ones((), device=dev)}
        return program_step(state, batch)

    # set-up: the check's steps, through the window's call and feed
    losses, aside = [], 0.0
    for i in range(n_check):
        state, m = step(state, feed(i))
        losses.append(float(m["loss"]))
        if i == 0:
            t = time.perf_counter()
            change1_prog = change_norms(flat, layout, seed, dev)
            aside += time.perf_counter() - t
    sync()
    t = time.perf_counter()
    change_prog = change_norms(flat, layout, seed, dev)
    aside += time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the window
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec.setup_s = time.time() - ctx.t_start - aside
    t0 = time.perf_counter()
    i = n_check
    while time.perf_counter() - t0 < ctx.seconds:
        ts = time.perf_counter()
        state, m = step(state, feed(i))
        float(m["loss"])
        rec.step_s.append(time.perf_counter() - ts)
        i += 1
    rec.window_s = time.perf_counter() - t0
    steps = len(rec.step_s)
    rec.attempted, rec.tokens = steps, steps * tr["batch"] * tr["seq"]
    rec.model_flops = steps * train_step_flops(mc, tr["batch"], tr["seq"])
    if cuda:
        rec.window_peak_bytes = torch.cuda.max_memory_allocated()
        rec.memory_peak_bytes = max(setup_peak, rec.window_peak_bytes)
    if ctx.trace:  # the traced sub-window, after the measured one
        rec.trace = Trace()
        rec.profiled = {"steps": PROFILED_STEPS,  # and the same work's untraced seconds
                        "untraced_s": PROFILED_STEPS * float(np.median(rec.step_s))}
        for host in (True, False):
            rec.trace.start(torch, host)
            for _ in range(PROFILED_STEPS):
                with torch.profiler.record_function("bench.train_step"):
                    state, m = step(state, feed(i))
                    float(m["loss"])
                i += 1
            rec.trace.stop(torch)

    # the check: the program's state freed, the reference from the seed
    del state, params, program_step, flat, m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rec.numbers = {"program": {"losses": losses, "change1": change1_prog, "change": change_prog},
                   "reference": reference_numbers(cfg, tr, n_check, seed, dev)}
    rec.readings = compare(rec.numbers["program"], rec.numbers["reference"])
    rec.check = {k: {"value": rec.readings[k], "limit": limit}
                 for k, limit in cell["limits"].items()}
    rec.check_s = time.perf_counter() - t
    rec.correct = core.judge(rec.check)
    return rec


def reference_numbers(cfg: Dict, tr: Dict, steps: int, seed: int, device,
                      precision: str = "float32", rows: int = 0) -> Dict:
    """The reference's (or its control's) losses, first gradient's norms by
    tensor, and changes after the first step and after `steps` steps;
    `rows` > 0 trains on that many rows of each batch (a planted fault)."""
    import torch

    mc = cfg["model_config"]
    ref = core.reference(cfg)
    layout = ref.layout(mc)
    common.set_float32_exact()
    W = weights.make(layout, seed, device)
    opt = common.Adafactor(W, cfg["optimizer"])
    prod = common.Products(precision)
    losses, grad, change1 = [], None, None
    for i in range(steps):
        b = traffic_mod.train_batch(tr, mc["vocab_size"], seed, i, device)
        if rows:
            b = {k: v[:rows] for k, v in b.items()}
        loss, grads = common.loss_and_grads(ref.layer, W, b["tokens"], b["labels"], mc, prod)
        losses.append(loss)
        if grad is None:
            grad = common.norms(grads)
        opt.step(W, grads)
        del grads
        if change1 is None:
            change1 = change_norms(W, layout, seed, device)
    del opt
    change = change_norms(W, layout, seed, device)
    del W
    gc.collect()
    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad": grad, "change1": change1, "change": change}


def worst(prog: Dict, ref: Dict, key: str, n: int = 5):
    """The `n` tensors of the largest gap in `key` ("change1" or "change"):
    (name, program's norm, reference's norm, gap)."""
    r, p = ref[key], prog[key]
    med = sorted(r.values())[len(r) // 2]
    gaps = {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in r}
    return [(k, p[k], r[k], gaps[k]) for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every gap of `prog` against `ref` (each of the same steps): the
    losses', and the changes' by the worst and the median tensor, the
    tensors that only rounding moves left out by the reference's first
    gradient."""
    g = ref["grad"]
    med = sorted(g.values())[len(g) // 2]
    moved = [k for k in g if g[k] >= 1e-3 * med]
    n = min(len(prog["losses"]), len(ref["losses"]))
    change1 = common.gaps(prog["change1"], ref["change1"], moved)
    change = common.gaps(prog["change"], ref["change"], moved)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"][:n], ref["losses"][:n])),
        "change1_gap": change1[-1], "change1_gap_median": change1[len(change1) // 2],
        "change_gap": change[-1], "change_gap_median": change[len(change) // 2],
    }

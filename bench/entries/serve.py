"""The serving entry: a closed loop of ``ServeEngine.generate`` calls, one
batch of equal-length prompts a call, greedy.

A request is admitted when its call begins; its time to first token is
the call's wall time.  Set-up builds the engine on the seed's weights and
warms the deck's longest and shortest prompt lengths.

The check (after the window, with the engine freed): a sample of the
window's requests drawn from the seed, as many from each slot of the batch
(each row of a ``generate`` call), the longest prompt always among them.  The reference runs each sampled prompt alone and reads, at its last
position, how far below the reference's best logit the served token's logit
lies; ``logit_gap`` is the widest such gap of the sample.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np

from .. import core, traffic as traffic_mod, weights
from ..reference import common
from ..trace import Trace
from ..yardstick import prefill_flops

PROFILED_BATCHES = 3  # batches of each traced pass, after the window
WARM = 1 << 40        # the warm-up batches' indices, apart from the window's


def run(ctx: core.Context) -> core.Run:
    import torch
    from repro_torch.models.model import DecoderLM
    from repro_torch.serving.engine import ServeConfig, ServeEngine

    cfg, tr, cell = ctx.files["config"], ctx.files["traffic"], ctx.files["cell"]
    mc, dev, seed = cfg["model_config"], ctx.device, ctx.seed
    ref = core.reference(cfg)
    layout = ref.layout(mc)
    model = DecoderLM(core.model_config(mc))
    weights.check_layout(layout, core.program_specs(model.param_specs()))
    rec = core.Run(entry="serve", config=cfg, traffic=tr)
    cuda = dev.type == "cuda"
    vocab, new = mc["vocab_size"], tr["max_new_tokens"]

    engine = ServeEngine(model, weights.nest(weights.make(layout, seed, dev)),
                         ServeConfig(batch_slots=tr["batch"], max_new_tokens=new, greedy=True),
                         device=dev)

    def serve(prompts: np.ndarray):
        toks, stats = engine.generate(prompts)
        if "altered_token" in ctx.faults:  # a planted fault: a token changed where it is made
            toks = toks.copy()
            toks[0, prompts.shape[1]] = (toks[0, prompts.shape[1]] + 1) % vocab
        return toks, stats

    # set-up: warm the deck's longest and shortest lengths
    deck = traffic_mod.deck(tr)
    for j, length in enumerate((deck[-1], deck[0])):
        serve(traffic_mod.prompts(tr, vocab, seed, WARM + j, length))
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the window
    rec.setup_s = time.time() - ctx.t_start
    order = traffic_mod.lengths(tr, 1 << 14)
    served: List[Tuple[int, int, np.ndarray]] = []  # (batch, length, served tokens)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        length = order[i]
        prompts = traffic_mod.prompts(tr, vocab, seed, i, length)
        ts = time.perf_counter()
        toks, stats = serve(prompts)
        rec.ttft_s.extend([time.perf_counter() - ts] * tr["batch"])
        rec.prefill_s.append(stats["prefill_s"])
        if not stats["logits_finite"]:
            rec.failed += tr["batch"]
        served.append((i, length, toks[:, length:]))
        rec.tokens += tr["batch"] * (length + new)
        rec.model_flops += prefill_flops(mc, tr["batch"], length)
        i += 1
    rec.window_s = time.perf_counter() - t0
    rec.attempted = i * tr["batch"]
    if cuda:
        rec.memory_peak_bytes = max(setup_peak, torch.cuda.max_memory_allocated())
    if ctx.trace:  # the traced sub-window, after the measured one
        lengths = order[i:i + PROFILED_BATCHES]
        took = {}  # each length's untraced seconds, the window's median
        for (_, length, _), s in zip(served, rec.ttft_s[::tr["batch"]]):
            took.setdefault(length, []).append(s)
        rec.trace = Trace()
        untraced = (sum(float(np.median(took[n])) for n in lengths)
                    if all(n in took for n in lengths) else None)
        rec.profiled = {"lengths": lengths, "batch": tr["batch"], "untraced_s": untraced}
        for host in (True, False):  # the same batches twice
            rec.trace.start(torch, host)
            for j, length in enumerate(lengths):
                with torch.profiler.record_function("bench.generate"):
                    serve(traffic_mod.prompts(tr, vocab, seed, i + j, length))
            rec.trace.stop(torch)

    # the check: the engine freed, the reference from the seed
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rec.sample = sample = sample_requests(served, tr["batch"], seed, cell["check"]["requests"])
    gaps = reference_gaps(cfg, tr, seed, dev, sample, ["float32"])["float32"]
    rec.readings = {"logit_gap": max(gaps)}
    rec.check = {"logit_gap": {"value": max(gaps), "limit": cell["limits"]["logit_gap"]}}
    rec.check_s = time.perf_counter() - t
    rec.correct = core.judge(rec.check)
    return rec


def sample_requests(served, rows: int, seed: int, n: int) -> List[Tuple[int, int, int, int]]:
    """(batch, row, length, served token) of `n` requests drawn from the
    seed among those served: n // rows from each row (slot) of the batch,
    and the rest from rows drawn, so that every slot is checked where
    n >= rows; the longest prompt's first request is one of them."""
    reqs = [(b, r, length, int(toks[r, 0])) for b, length, toks in served for r in range(rows)]
    longest = max(range(len(reqs)), key=lambda j: (reqs[j][2], -j))
    rng = np.random.default_rng([seed % (1 << 64), 3])
    want = [n // rows] * rows
    for r in rng.permutation(rows)[: n % rows]:
        want[r] += 1
    want[reqs[longest][1]] -= 1
    chosen = [longest]
    for r in range(rows):
        slot = [j for j in rng.permutation(len(reqs)) if reqs[j][1] == r and j != longest]
        chosen += slot[: max(0, want[r])]
    return [reqs[j] for j in sorted(chosen)]


def reference_gaps(cfg: Dict, tr: Dict, seed: int, device, sample, precisions: List[str]
                   ) -> Dict[str, List[float]]:
    """For each precision, each sampled request's gap: the reference's best
    logit at the prompt's last position less its logit of the token put
    first (the served token for "float32"; the token the lower precision
    ranks first for the control, "float8")."""
    import torch

    mc = cfg["model_config"]
    ref = core.reference(cfg)
    common.set_float32_exact()
    W = weights.make(ref.layout(mc), seed, device)
    out: Dict[str, List[float]] = {p: [] for p in precisions}
    exact = common.Products("float32")
    for b, r, length, token in sample:
        prompt = torch.as_tensor(traffic_mod.prompts(tr, mc["vocab_size"], seed, b, length)[r],
                                 device=device)[None]
        logits = common.last_logits(ref.layer, W, prompt, mc, exact)[0]
        best = float(logits.max())
        for p in precisions:
            if p == "float32":
                first = token
            else:
                first = int(common.last_logits(ref.layer, W, prompt, mc,
                                               common.Products(p))[0].argmax())
            out[p].append(best - float(logits[first]))
    del W
    gc.collect()
    return out

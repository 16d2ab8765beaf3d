"""Serving CLI: load a committed version from the asymmetric store
(or fresh random weights) and run batched generation, on the card unless
``--device cpu`` is given.

  python -m repro_torch.launch.serve --arch llama3.2-3b --full \\
      --batch 4 --prompt-len 1024 --max-new 32
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..device import resolve_device
from ..models import DecoderLM
from ..serving import ServeConfig, ServeEngine
from ..statestore import AsymStore, CheckpointManager, FileBlade


def main(argv=None) -> Dict[str, Any]:
    """Runs the CLI; returns the run's totals (tokens, seconds, the
    per-request prefill and decode seconds, and whether all logits were
    finite)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--store", default=None)
    ap.add_argument("--version", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--requests", type=int, default=3, help="number of batches")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    model = DecoderLM(cfg)
    scfg = ServeConfig(batch_slots=args.batch, max_new_tokens=args.max_new)
    if args.store:
        ckpt = CheckpointManager(AsymStore(FileBlade(args.store)))
        eng = ServeEngine.load_from_store(model, ckpt, scfg, version=args.version, device=device)
        print(f"[serve] pinned store version {eng.version}")
    else:
        params = model.init(torch.Generator(device=device).manual_seed(args.seed))
        eng = ServeEngine(model, params, scfg, device=device)

    return serve_requests(eng, cfg.vocab_size, args.batch, args.prompt_len, args.requests,
                          args.seed)


def serve_requests(eng: ServeEngine, vocab_size: int, batch: int, prompt_len: int,
                   requests: int, seed: int = 0) -> Dict[str, Any]:
    """`requests` batches of `batch` random prompts of `prompt_len` tokens
    (numpy, from `seed`) through `eng`; returns the totals `main` returns."""
    rng = np.random.default_rng(seed)
    total_tokens = 0
    prefill_s, decode_s, steps, finite = [], [], [], True
    t0 = time.monotonic()
    for r in range(requests):
        prompts = rng.integers(0, vocab_size, (batch, prompt_len)).astype(np.int32)
        toks, stats = eng.generate(prompts)
        total_tokens += toks.shape[0] * stats["decode_steps"]
        prefill_s.append(stats["prefill_s"])
        decode_s.append(stats["decode_s"])
        steps.append(stats["decode_steps"])
        finite = finite and stats["logits_finite"]
        print(f"[serve] batch {r}: generated {stats['decode_steps']} steps/seq; "
              f"first seq tail: {toks[0, -8:].tolist()}")
    dt = time.monotonic() - t0
    print(f"[serve] {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s on {eng.device})")
    return {"device": str(eng.device), "tokens": total_tokens, "seconds": dt,
            "prefill_s": prefill_s, "decode_s": decode_s, "decode_steps": steps,
            "logits_finite": finite}


if __name__ == "__main__":
    main()
    sys.exit(0)

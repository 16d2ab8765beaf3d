"""Training CLI, on the card unless ``--device cpu`` is given.

The smoke config by default (reduced); pass --full for the published config.
Demonstrates the full fault-tolerance loop: step logs, periodic async full
commits, optional delta commits, resume.

  python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 50 \\
      --store /tmp/blade --mirror /tmp/mirror --resume
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..data import DataConfig
from ..device import resolve_device
from ..models import DecoderLM
from ..statestore import AsymStore, CheckpointManager, FileBlade
from ..training import OptConfig, TrainConfig, Trainer, TrainerConfig
from ..training.trainer import CUBLAS_WORKSPACE


def main(argv=None) -> Dict[str, Any]:
    """Runs the CLI; returns the run's totals: the final step and loss, each
    step's metrics and seconds, tokens, wall seconds and, on the card, the
    peak device memory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-topk", type=float, default=0.0)
    ap.add_argument("--optimizer", choices=["adamw", "adafactor"], default="adamw")
    ap.add_argument("--momentum-dtype", choices=["float32", "bfloat16"], default="float32",
                    help="Adafactor's momentum (bfloat16: the JAX package's choice for "
                         "large models)")
    ap.add_argument("--full", action="store_true", help="published config")
    ap.add_argument("--store", default=None, help="persistence blade directory")
    ap.add_argument("--mirror", default=None)
    ap.add_argument("--full-every", type=int, default=10)
    ap.add_argument("--delta-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    # cuBLAS reads this when it starts: before the first CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    model = DecoderLM(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=args.global_batch,
                      seq_len=args.seq_len,
                      embed_dim=0 if cfg.embed_inputs else cfg.d_model)
    tcfg = TrainConfig(opt=OptConfig(kind=args.optimizer, lr=args.lr,
                                     momentum_dtype=args.momentum_dtype),
                       accum_steps=args.accum, grad_topk_frac=args.grad_topk)

    ckpt = None
    if args.store:
        blade = FileBlade(args.store, mirrors=[args.mirror] if args.mirror else None)
        ckpt = CheckpointManager(AsymStore(blade), full_every=args.full_every,
                                 delta_every=args.delta_every, async_commit=True)

    tr = Trainer(model, tcfg, dcfg, ckpt=ckpt, seed=args.seed, device=device)
    # the handler holds the trainer (and its state): give the caller its own back
    previous = signal.getsignal(signal.SIGTERM)
    tr.install_preemption_handler()
    try:
        start = 0
        if args.resume and ckpt is not None and ckpt.store.latest_version() > 0:
            start = tr.resume()
            print(f"[train] resumed from committed version at step {start}")
        else:
            tr.init()
        t0 = time.monotonic()
        out = tr.run(TrainerConfig(total_steps=args.steps), start_step=start)
        seconds = time.monotonic() - t0
    finally:
        signal.signal(signal.SIGTERM, previous)
    for m in out["metrics"][-5:]:
        print(f"[train] step {m['step']:5d} loss={m['loss']:.4f} "
              f"gnorm={m['grad_norm']:.3f} {m['seconds']*1e3:.0f}ms")
    if out["straggler_events"]:
        print(f"[train] straggler events: {out['straggler_events']}")
    if ckpt:
        ckpt.close()
    losses = [m["loss"] for m in out["metrics"]]
    totals = {"device": str(device), "final_step": out["final_step"],
              "final_loss": losses[-1] if losses else None, "losses": losses,
              "grad_norms": [m["grad_norm"] for m in out["metrics"]],
              "step_s": [m["seconds"] for m in out["metrics"]],
              "tokens": len(losses) * args.global_batch * args.seq_len, "seconds": seconds,
              "all_finite": bool(np.all(np.isfinite(losses)))}
    if device.type == "cuda":
        totals["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    print(json.dumps({"final_step": totals["final_step"], "final_loss": totals["final_loss"]}))
    return totals


if __name__ == "__main__":
    main()
    sys.exit(0)

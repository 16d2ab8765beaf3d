#!/usr/bin/env python3
"""Device time of the serve path's scan forwards (`mamba_scan` at
falcon-mamba-7b's prefill, bf16, and fp32 with h0 at a ragged S;
`rglru_scan` at recurrentgemma-9b's, bf16) of the checkout at `--root`,
on inputs made as `chip_smoke.py`'s kernel cases make them.

    python3 scripts/time_scan_forwards.py --root path/to/checkout

Each number is the median of 10 calls, each after a 256 MB L2 flush, timed
with CUDA events; `--reps` such medians a shape, in one process.  To
compare two trees, run it on each in turns (A, B, B, A) on one card.
Needs a CUDA card; prints one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rglru_scan as rs

    if not Path(ms.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {ms.__file__}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def timer(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def mamba(B, S, Din, N, dt, with_h0):
        g = torch.Generator(device="cuda").manual_seed(S + Din + N)
        rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        x, delta = rn(B, S, Din).to(dt), torch.nn.functional.softplus(rn(B, S, Din))
        A = -torch.exp(rn(Din, N) * 0.5)
        Bm, Cm, D = rn(B, S, N).to(dt), rn(B, S, N).to(dt), rn(Din)
        h0 = rn(B, Din, N) if with_h0 else None
        return [timer(lambda: ms.mamba_scan(x, delta, A, Bm, Cm, D, h0))
                for _ in range(args.reps)]

    def rglru(B, S, D, dt):
        g = torch.Generator(device="cuda").manual_seed(S + D)
        rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        x = rn(B, S, D).to(dt)
        r, i = torch.sigmoid(rn(B, S, D)).to(dt), torch.sigmoid(rn(B, S, D)).to(dt)
        log_a = -torch.exp(rn(D) * 0.3) * 0.1
        return [timer(lambda: rs.rglru_scan(x, r, i, log_a, None)) for _ in range(args.reps)]

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "root": str(root), "card": card.strip().splitlines()[0] if card.strip() else None,
        "mamba_bf16_B4_S1024_ms": mamba(4, 1024, 8192, 16, torch.bfloat16, False),
        "mamba_fp32_B4_S1000_h0_ms": mamba(4, 1000, 8192, 16, torch.float32, True),
        "rglru_bf16_B4_S3072_ms": rglru(4, 3072, 4096, torch.bfloat16)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

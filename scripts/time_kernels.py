#!/usr/bin/env python3
"""Device time of kernels of the checkout at `--root`, by named case, on
inputs made as `chip_smoke.py`'s kernel cases make them:

  scan_forwards  the scan forwards: `mamba_scan` at falcon-mamba-7b's
                 prefill (bf16), and fp32 with h0 at a ragged S; `rglru_scan`
                 at recurrentgemma-9b's prefill (B=4, S=3072, D=4096; bf16
                 and fp32), at its training shape (B=2, S=1024, bf16), and
                 fp32 with h0 at a ragged S (1000), each launch by launch;
  train_kernels  recurrentgemma-9b's two training kernels, whole and launch
                 by launch: the flash attention backward at head_dim 256
                 (bf16, MQA 16/1 heads, window 2048: B=2, S=1024, the shape
                 `train_recurrent` gives it, and B=4, S=3072) and the RG-LRU
                 reverse scan (D=4096 with h0 and dhT: B=2, S=1024 in bf16,
                 and B=4, S=3072 in bf16 and fp32); the Mamba reverse scan
                 (Din=8192, N=16, with h0 and dhT: B=1, S=1024 in bf16, the
                 shape `train_recurrent` gives it, and B=4, S=1024 in bf16
                 and fp32); and SDPA's causal backward at the first shape,
                 the flash backward's yardstick;
  flash_forwards the bf16 flash forward (causal) at the serve phase's
                 shapes, whole and by launch, beside SDPA's whole call and
                 its time on the card: kimi-k2-1t-a32b's (B=4, 64/8 heads,
                 D=112) at S=1024 and at its prompt S=256, stablelm-12b's
                 (B=4, 32/8, D=160) and llama3.2-3b's (B=4, 24/8, D=128) at
                 S=1024; and the other head dims: qwen1.5-0.5b's (B=4, MHA
                 16 heads, D=64, S=1024), recurrentgemma-9b's (B=4, 16/1,
                 D=256, S=3072, window 2048; SDPA with the window's mask)
                 and D=32 at the smoke configs' width (B=4, 16 heads, S=1024);
  topk           `topk_compress` at llama3.2-3b's embedding delta (394 M fp32,
                 k = 10) on `chip_smoke.topk_input`'s three inputs (random,
                 lifecycle, ties), with device time;
  lifecycle      `chip_smoke.phase_lifecycle` on the checkout's package: its
                 line (printed first) has the delta commit's compress_s and
                 topk_ms, the device time of its top-k launches;
  apply_runs     K2 (`nvm_log.apply_runs`) on a 64 MB arena and one mirror at
                 the blade replay's shapes (`chip_smoke.APPLY_CASES`) and at
                 1e5 runs: `call_ms` and `launch_ms` (the launch on a table
                 planned before, `_apply_launcher`), medians of 1,000 calls
                 (50 at 1e5 runs) on the host clock, each synchronised
                 (`chip_smoke.host_ms`), with the route where the checkout
                 has one; and the floor, an empty kernel's launch timed
                 alike, where the checkout has one (`nvm_log.floor_launch`).
  checksum       K1 (`nvm_log.fletcher64_segments`) at the reboot's shapes
                 (`chip_smoke.CHECKSUM_CASES`, recorded on CPU blades) and at
                 1e5 segments on a 64 MB span (`chip_smoke.checksum_1e5`):
                 `call_ms` and `launch_host_ms` (the launch on a table
                 prepared before, `_fletcher64_launcher`), medians of 1,000
                 calls (50 at 1e5) on the host clock, each synchronised;
                 `launch_ms`, the launch's CUDA-event time after an L2 flush
                 (`Timer`, medians of 100, `--reps` of them); the route where
                 the checkout has one; and the floor as for apply_runs.

    python3 scripts/time_kernels.py --root path/to/checkout --case train_kernels

The timer is `chip_smoke.Timer` of this script's own checkout, whatever
`--root` names: each number is the median of 10 calls, each after a 256 MB
L2 flush, timed with CUDA events; `--reps` such medians a shape, in one
process.  The split by launch is `Timer.split`: torch.profiler's device
time of each kernel over 10 more calls, divided by the calls, for the
kernel names of `LAUNCHES` that the call ran (they name both the one-pass
RG-LRU reverse scan and the two-pass one, and the flash backward's launches
with and without head splits, so two trees' splits can be compared); the
scans' cases also give `launch_ms`, `Timer.launches`: each launch of a call
in order, by kernel name, where one kernel runs more than once a call (the
Mamba reverse scan's three ordered sums).  To compare two
trees, run it on each in turns (A, B, B, A) on one card.  The training
kernels' cases also give `host_ms`, the median host time of enqueuing one
call (the queue empty before it): where it outlasts the flush, the events
count the difference.  `device_ms` is `Timer.device`: the device time of
every kernel of one call, whatever its host time (the flush left out).
Needs a CUDA card; prints one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
CASES = ("scan_forwards", "train_kernels", "flash_forwards", "topk", "lifecycle", "apply_runs",
         "checksum")
# each kernel of a call whose device time is split out, by a substring of its name
LAUNCHES = {"flash_fwd": ("flash_fwd_sm90",),
            "flash_bwd": ("bwd_prep", "bwd_dkdv", "bwd_dq", "bwd_reduce"),
            "rglru_bwd": ("rglru_scan_bwd_kernel", "rglru_bwd_pass1", "rglru_bwd_pass2",
                          "sum_rows"),
            "rglru_fwd": ("rglru_scan_kernel",),
            "mamba_bwd": ("mamba_scan_bwd_kernel", "mamba_bwd_pass1", "mamba_bwd_pass2",
                          "sum_rows")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--case", choices=CASES, required=True)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    from chip_smoke import Timer, topk_input
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import topk_compress as tk

    if not Path(ms.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {ms.__file__}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    timer = Timer(torch)

    def host_ms(run, iters=10):
        ts = []
        for _ in range(iters):
            timer.flush.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return float(np.median(ts))

    def times(run, launches=None):
        ms_ = [timer(run) for _ in range(args.reps)]
        if launches is None:
            return ms_
        out = {"ms": ms_, "host_ms": host_ms(run), "device_ms": timer.device(run)}
        if launches in LAUNCHES:
            split = timer.split(run, {name: name for name in LAUNCHES[launches]})
            out["split_ms"] = {k: v for k, v in split.items() if v is not None}
        if launches in ("rglru_fwd", "mamba_bwd"):
            out["launch_ms"] = timer.launches(run)
        return out

    def mamba(B, S, Din, N, dt, with_h0):
        g = torch.Generator(device="cuda").manual_seed(S + Din + N)
        rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        x, delta = rn(B, S, Din).to(dt), torch.nn.functional.softplus(rn(B, S, Din))
        A = -torch.exp(rn(Din, N) * 0.5)
        Bm, Cm, D = rn(B, S, N).to(dt), rn(B, S, N).to(dt), rn(Din)
        h0 = rn(B, Din, N) if with_h0 else None
        return times(lambda: ms.mamba_scan(x, delta, A, Bm, Cm, D, h0))

    def rglru_inputs(B, S, D, dt, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        x = rn(B, S, D).to(dt)
        r, i = torch.sigmoid(rn(B, S, D)).to(dt), torch.sigmoid(rn(B, S, D)).to(dt)
        return rn, x, r, i, -torch.exp(rn(D) * 0.3) * 0.1

    def rglru(B, S, D, dt, with_h0=False):  # the inputs of chip_smoke.rglru_case
        rn, x, r, i, log_a = rglru_inputs(B, S, D, dt, S + D)
        h0 = rn(B, D) if with_h0 else None
        return times(lambda: rs.rglru_scan(x, r, i, log_a, h0), "rglru_fwd")

    def flash_bwd(B, S):
        g = torch.Generator(device="cuda").manual_seed(S * 3 + 256)
        q, k, v, do = (torch.randn((B, h, S, 256), generator=g, device="cuda").to(torch.bfloat16)
                       for h in (16, 1, 1, 16))
        o, lse = fa.flash_attention(q, k, v, return_lse=True, causal=True, window=2048)
        return times(lambda: fb.flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                                         window=2048), "flash_bwd")

    def sdpa_bwd(B, S):  # the window of 2048 cuts no key at S <= 2048: causal
        g = torch.Generator(device="cuda").manual_seed(S * 3 + 256)
        q, k, v, do = (torch.randn((B, h, S, 256), generator=g, device="cuda").to(torch.bfloat16)
                       for h in (16, 1, 1, 16))
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                               enable_gqa=True)
        return times(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), "sdpa")

    def flash_fwd(B, Hq, Hkv, S, D, window=None):  # the inputs of chip_smoke.flash_case
        g = torch.Generator(device="cuda").manual_seed(S * 7 + S)
        q, k, v = (torch.randn((B, h, S, D), generator=g, device="cuda").to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - (window or S))
        lib = (lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)) if window else (
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        return {"kernel": times(lambda: fa.flash_attention(q, k, v, causal=True, window=window),
                                "flash_fwd"),
                "sdpa": times(lib, "sdpa")}

    def rglru_bwd(B, S, dt):
        rn, x, r, i, log_a = rglru_inputs(B, S, 4096, dt, S + 4096 + 1)
        h0, dy, dhT = rn(B, 4096), rn(B, S, 4096).to(dt), rn(B, 4096)
        ckpt = rs.rglru_scan(x, r, i, log_a, h0, checkpoints=True)[2]
        return times(lambda: rs.rglru_scan_backward(x, r, i, log_a, h0, dy, dhT, ckpt),
                     "rglru_bwd")

    def mamba_bwd(B, S, dt):  # the inputs of chip_smoke.mamba_bwd_case
        Din, N = 8192, 16
        g = torch.Generator(device="cuda").manual_seed(S + Din + N + 1)
        rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        x, delta = rn(B, S, Din).to(dt), torch.nn.functional.softplus(rn(B, S, Din))
        A = -torch.exp(rn(Din, N) * 0.5)
        Bm, Cm, D, h0 = rn(B, S, N).to(dt), rn(B, S, N).to(dt), rn(Din), rn(B, Din, N)
        dy, dhT = rn(B, S, Din).to(dt), rn(B, Din, N)
        args = (x, delta, A, Bm, Cm, D, h0)
        ckpt = ms.mamba_scan(*args, checkpoints=True)[2]
        return times(lambda: ms.mamba_scan_backward(*args, dy, dhT, ckpt), "mamba_bwd")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"root": str(root), "case": args.case,
           "card": card.strip().splitlines()[0] if card.strip() else None}
    if args.case == "lifecycle":
        from chip_smoke import phase_lifecycle
        from repro_torch.kernels import _build

        _build.build()  # as chip_smoke.py does first: no build inside a commit's timing
        phase_lifecycle(torch)
    elif args.case == "apply_runs":
        from chip_smoke import APPLY_CASES, APPLY_SPAN, NVM_BLADE, apply_inputs, host_ms as hms
        from repro_torch.kernels import _build, nvm_log

        _build.build(["nvm_log"])
        gen = torch.Generator(device="cuda").manual_seed(64)
        base = torch.randint(0, 256, (NVM_BLADE,), dtype=torch.uint8, device="cuda",
                             generator=gen)
        dsts, lo = [base.clone(), base.clone()], NVM_BLADE - APPLY_SPAN
        if hasattr(nvm_log, "floor_launch"):
            out["floor_ms"] = hms(torch, lambda: nvm_log.floor_launch(torch.device("cuda")))
        rng = np.random.default_rng(65)
        for case in (*APPLY_CASES, "1e5"):
            addrs, offs, lens = apply_inputs(case, rng)
            iters = 50 if case == "1e5" else 1000
            args_ = (dsts, dsts[0][lo:], addrs, offs, lens)
            out[f"apply_{case}"] = {
                "runs": int(addrs.size),
                "route": nvm_log.route(2, addrs.size) if hasattr(nvm_log, "route") else None,
                "call_ms": hms(torch, lambda: nvm_log.apply_runs(*args_), iters),
                "launch_ms": hms(torch, nvm_log._apply_launcher(*args_), iters)}
    elif args.case == "checksum":
        from chip_smoke import CHECKSUM_CASES, checksum_1e5, checksum_inputs, host_ms as hms
        from repro_torch.kernels import _build, nvm_log

        _build.build(["nvm_log"])
        if hasattr(nvm_log, "floor_launch"):
            out["floor_ms"] = hms(torch, lambda: nvm_log.floor_launch(torch.device("cuda")))
        for case in (*CHECKSUM_CASES, "1e5"):
            if case == "1e5":
                arena, starts, lens = checksum_1e5(torch, torch.Generator(
                    device="cuda").manual_seed(64), np.random.default_rng(64))
            else:
                arena, starts, lens = checksum_inputs(case)
                arena = arena.cuda()
            iters = 50 if case == "1e5" else 1000
            got = torch.empty(starts.size, dtype=torch.uint64, device="cuda")
            launch = nvm_log._fletcher64_launcher(arena, starts, lens, got)
            out[f"fletcher64_{case}"] = {
                "segments": int(starts.size), "bytes": int(lens.sum()),
                "route": (nvm_log.checksum_route(starts, lens)
                          if hasattr(nvm_log, "checksum_route") else None),
                "call_ms": hms(torch, lambda: nvm_log.fletcher64_segments(arena, starts, lens),
                               iters),
                "launch_host_ms": hms(torch, launch, iters),
                "launch_ms": [timer(launch, 100) for _ in range(args.reps)]}
            del arena, got, launch
            torch.cuda.empty_cache()
    elif args.case == "topk":
        for case in ("random", "lifecycle", "ties"):
            x = topk_input(torch, case, 128256 * 3072)  # llama3.2-3b's embedding
            run = lambda: tk.topk_compress(x, 10)  # noqa: E731
            out[f"topk_{case}_ms"] = {"ms": [timer(run) for _ in range(args.reps)],
                                      "device_ms": timer.device(run)}
            del x
            torch.cuda.empty_cache()
    elif args.case == "scan_forwards":
        out.update(mamba_bf16_B4_S1024_ms=mamba(4, 1024, 8192, 16, torch.bfloat16, False),
                   mamba_fp32_B4_S1000_h0_ms=mamba(4, 1000, 8192, 16, torch.float32, True),
                   rglru_bf16_B4_S3072_ms=rglru(4, 3072, 4096, torch.bfloat16),
                   rglru_fp32_B4_S3072_ms=rglru(4, 3072, 4096, torch.float32),
                   rglru_bf16_B2_S1024_ms=rglru(2, 1024, 4096, torch.bfloat16),
                   rglru_fp32_B4_S1000_h0_ms=rglru(4, 1000, 4096, torch.float32, True))
    elif args.case == "flash_forwards":
        out.update(flash_fwd_d112_B4_S1024=flash_fwd(4, 64, 8, 1024, 112),
                   flash_fwd_d112_B4_S256=flash_fwd(4, 64, 8, 256, 112),
                   flash_fwd_d160_B4_S1024=flash_fwd(4, 32, 8, 1024, 160),
                   flash_fwd_d128_B4_S1024=flash_fwd(4, 24, 8, 1024, 128),
                   flash_fwd_d64_B4_S1024=flash_fwd(4, 16, 16, 1024, 64),
                   flash_fwd_d32_B4_S1024=flash_fwd(4, 16, 16, 1024, 32),
                   flash_fwd_d256_B4_S3072_w2048=flash_fwd(4, 16, 1, 3072, 256, 2048))
    else:
        out.update(flash_bwd_d256_B2_S1024=flash_bwd(2, 1024),
                   flash_bwd_d256_B4_S3072=flash_bwd(4, 3072),
                   sdpa_bwd_d256_B2_S1024=sdpa_bwd(2, 1024))
        torch.cuda.empty_cache()
        out.update(rglru_bwd_bf16_B2_S1024=rglru_bwd(2, 1024, torch.bfloat16),
                   rglru_bwd_bf16_B4_S3072=rglru_bwd(4, 3072, torch.bfloat16),
                   rglru_bwd_fp32_B4_S3072=rglru_bwd(4, 3072, torch.float32))
        torch.cuda.empty_cache()
        out.update(mamba_bwd_bf16_B1_S1024=mamba_bwd(1, 1024, torch.bfloat16),
                   mamba_bwd_bf16_B4_S1024=mamba_bwd(4, 1024, torch.bfloat16),
                   mamba_bwd_fp32_B4_S1024=mamba_bwd(4, 1024, torch.float32))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

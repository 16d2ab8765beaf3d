#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU and checks it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py                  # every phase; exits 0 only if all pass
    python3 chip_smoke.py --only kernel    # build + the kernel cases only
    python3 chip_smoke.py --only kernel,train
    python3 chip_smoke.py --only kernel,train_recurrent
    python3 chip_smoke.py --only kernel,serve
    python3 chip_smoke.py --only kernel,train_stablelm,train_parity
    python3 chip_smoke.py --only mesh
    python3 chip_smoke.py --only build,nvm

It prints one JSON object per line, one line per phase:

  device   the card, its power limit (nvidia-smi), torch and CUDA versions
  build    seconds to compile the CUDA kernels from csrc/ (nvcc, sm_90a)
  kernel   one line per case: the CUDA kernel against its plain PyTorch
           version on the same inputs (max_err within tol; top-k and the
           checksums exactly, and the checksums also against the host's
           fletcher32_padded), with kernel_ms, plain_ms and library_ms
           (torch's scaled_dot_product_attention, its backward, or
           torch.topk on the same inputs, yardsticks the port never calls;
           no single torch call computes a scan or a checksum, so theirs is
           null) from CUDA events,
           each launch after an L2 flush, and bound_ms: the largest of
           bytes / 3.35 TB/s, operations / peak (989 TFLOP/s bf16, 67
           TFLOP/s fp32; the scans compute in fp32) and, for mamba_scan,
           exponentials / the special-function units' rate (132 SMs x 16 a
           clock x 1.98 GHz), from the shapes and masks of the case.  Flash
           and decode lines name their route (flash bf16: "wgmma", decode
           bf16: "mma", fp32: "cuda_core"); bf16 ones also time the
           CUDA-core kernel's bf16 build, which served bf16 before, as
           earlier_kernel_ms.  Decode lines add library_live_ms: SDPA over
           the live prefix of the cache alone, the bytes the kernel reads.
           The backward cases (flash at llama's and recurrentgemma-9b's
           shapes, the two scans' reverse scans with h0 and dhT) hold every
           gradient within their tolerance of its largest entry and two
           runs bitwise equal; the bf16 flash backward at head_dim 256 adds
           its head_splits and each launch's device time (prep_ms, dkdv_ms,
           dq_ms, reduce_ms: torch.profiler), the RG-LRU one its chunk and
           pass1_ms, pass2_ms, sum_ms, the Mamba one its chunk, pass1_ms,
           pass2_ms, sum_ms and launch_ms (each launch in order, its three
           ordered sums one by one), also at falcon-mamba-7b's training
           shape (B=1) and a ragged S.  The RG-LRU forward is also checked
           at recurrentgemma-9b's training shape (B=2, S=1024), and every
           RG-LRU forward case holds two runs bitwise equal (bitwise_repeat).
           topk_compress runs on three inputs of 394 M fp32 at k = 10
           (topk_input: random, lifecycle-like, ties at tau) and on bf16 at
           k = 37, each bitwise against its plain version and a second run,
           with the share of blocks that took the kernel's fallback
           (fallback_share: the kernel's own record, which must equal its
           plain model, topk_compress.fallback_blocks, on the same input).
           Head dims 112 (kimi-k2) and 160
           (stablelm-12b): flash forward at their prefill shapes, backward
           at their training shapes (B=2, S=1024) and decode over a
           32768-slot cache, in bf16 and fp32
  parity   the kernel path against the plain path on the same float32
           weights at published widths (max abs logit error <= 2e-3):
           llama3.2-3b cut to depth 2 (and at depth 28, beside the plain
           path with another block size: the random model is chaotic),
           falcon-mamba-7b cut to depth 2, recurrentgemma-9b cut to one
           (rglru, rglru, local_attn) pattern with a prompt past its window
  serve    the main path, once per model: repro_torch.launch.serve.main at
           the published llama3.2-3b, falcon-mamba-7b, recurrentgemma-9b and
           stablelm-12b configs (bf16) on fresh seeded weights, and
           kimi-k2-1t-a32b at published widths cut to 2 layers (one dense,
           one MoE with all 384 experts) through the ServeEngine and request
           loop serve.main uses (serve.main has no depth flag); each
           kernel's launches counted from zero and held to their exact
           counts, every flash launch on the "wgmma" route and every decode
           launch on "mma"; peak device memory
  profile  torch.profiler over one prefill and three decode steps of
           llama3.2-3b, recurrentgemma-9b, falcon-mamba-7b, stablelm-12b and
           kimi-k2-1t-a32b (2 layers, as served): wall, host-enqueue and
           device ms, the device's idle share, kernel launches, and the
           kernels that take the most time
  store    llama3.2-3b widths cut to 2 layers: a full commit to a mirrored
           FileBlade, restored from the primary and from the mirror, serving
           the same greedy tokens as the weights held in memory
  train    the training path: repro_torch.launch.train.main at the published
           llama3.2-3b (28 layers, bf16, AdamW) for 5 steps of 4 x 1024
           tokens, with no store; flash forward and backward launches held
           to their exact counts, all on the "wgmma" route; step ms,
           tokens/s, peak memory, losses;
           then the step-0 gradient norms of the kernel and plain paths
           (float64, per tensor), and torch.profiler over one step
  train_recurrent  the recurrent family's training path:
           repro_torch.launch.train.main at the published falcon-mamba-7b
           and recurrentgemma-9b (bf16, Adafactor with bf16 momentum) for 4
           steps of 1 x 1024 and 2 x 1024 tokens; the scans' and
           attention's forward and backward launches held to their exact
           counts, all flash on "wgmma"; step ms, tokens/s, peak memory,
           losses, grad norms; then every parameter's step-0 gradient,
           finite and nonzero in every layer; then torch.profiler over one
           step of each after a warm-up step: wall, device ms, idle share,
           launches, and the device time and share of the Mamba scan and its
           reverse scan (falcon-mamba-7b), of the flash backward's launches
           and of the RG-LRU scan and its reverse scan (recurrentgemma-9b);
           and a "remat" line: one falcon-mamba-7b step under each of
           ModelConfig.remat "none", "dots" and "full" (peak memory, step
           ms, launches: each forward kernel twice under remat), every
           gradient bitwise that of "none", "full" below "none" in memory
  train_stablelm  stablelm-12b at published widths cut to 24 of 40 layers
           (bf16, Adafactor with bf16 momentum, no store), through the
           Trainer train.main builds, for 4 steps of 2 x 1024 tokens; flash
           forward and backward at head_dim 160 held to their exact counts,
           all on "wgmma"; step ms, tokens/s, peak memory, losses; then
           every parameter's step-0 gradient, finite and nonzero
  train_parity  llama3.2-3b, falcon-mamba-7b and stablelm-12b widths at
           depth 2, recurrentgemma-9b's at one pattern, and kimi-k2's at
           depth 2 with its experts cut to 8 (top-2; in bf16 the bound is
           held at top-8, where no token's experts can flip between the
           paths, and top-2 is reported beside the plain path's own
           spread): loss and every gradient on
           the kernel path against the plain path, from the same weights and
           batch; in float32 (the CUDA-core kernels; each gradient within
           2e-3 of its largest entry) and in bf16 (the wgmma kernels; within
           2e-2, with wq and wk at the standard fan-in: see
           phase_train_parity)
  lifecycle  tests/test_system.py::test_full_lifecycle at llama3.2-3b widths
           cut to depth 2 (bf16, Adafactor with bf16 momentum, 2 x 256
           tokens), on a mirrored FileBlade: 3 steps with a full commit at
           v2 and a delta commit at v3, a crash, serving from v2 and v3,
           bitwise resume from the primary and from the mirror; each
           commit's seconds split into checksum, copy, write and fsync, and
           the delta commit's compress_s beside topk_ms, the device time of
           its top-k launches (replayed after the commit on the same
           inputs, under torch.profiler, up to ten traces until one holds
           every launch; null if none does);
           every flash launch on the "wgmma" route
  mesh     the distribution layer: a one-rank NCCL process group (file://
           store in a temporary directory) and a 1 x 1 ("data", "model")
           mesh, against the mesh-less path in the same process: the decode
           kernel's log-sum-exp and the flash forward at a q_offset (what a
           larger mesh adds), llama3.2-3b training (28 layers, bf16, AdamW,
           3 steps of 4 x 1024, fsdp rules) and serving (batch 4, prompt
           1024, 32 new, decode rules) bitwise with equal launches, each
           path's step, prefill and decode ms; kimi-k2's MoE block with
           ep_a2a against dense (tests/test_torch_moe.py's bound);
           pipeline_apply at one stage over llama's blocks; and the mesh
           trainer's full and delta commits restored bitwise without a mesh
  nvm      the single-blade AsymNVM machine (repro_torch.core): blades whose
           arenas live on the card, each step run again on a CPU blade in the
           same process, and the arena and mirror digests (sha256), the
           clocks and the Stats held equal after every step: the quickstart
           (examples/quickstart.py part 1: a 16 MB blade with a mirror,
           1000 B+Tree inserts, crash, reboot, recovery, find(77)); Table 3's
           44 cells (benchmarks/table3_throughput.py: the eight structures
           under the six variants, less its SKIP) on 64 MB blades at a
           fifteenth of its 30000 preloaded keys and 3000 ops, and bptree x rcb
           and hashtable x r at its full size, each with its virtual KOPS,
           its wall seconds on the card and on the CPU, the card's copies
           to and from the host and the host's seconds in log decode and
           apply (obs.profile); recovery (tears at a watermark slot with
           keep 0 and 8, a tear mid-flush, a 400-transaction log replayed
           with the checksum memo cleared, mirror promotion, a lagging
           mirror); torch.profiler over a cut hashtable x r cell (device ms
           by kernel, idle share); then the blade's two kernels (K1
           fletcher64_segments, K2 apply_runs, csrc/nvm_log.cu) against
           their plain versions, bitwise, and a second run, on a 64 MB
           span of 1e5 segments and a 64 MB arena with a mirror and 1e5
           runs, a third overlapping: kernel_ms the whole call (its host
           planning included), launch_ms the launch alone on a table
           planned before (both CUDA events after the L2 flush)
  time     the seconds of the whole run, the kernels' build included
  kernels  every kernel of the path: its launches over the phase that runs
           it (serve, train, train_recurrent, train_stablelm or lifecycle,
           plus the mesh phase's: launches_by_phase),
           by head dim for the attention kernels, and the numbers of its
           case; the
           flash and decode entries also name their design (one kernel a
           dtype), decode adds its recurrentgemma-9b case, mamba its design,
           the RG-LRU forward its design and its training-shape case,
           topk_compress its design, fallback share and other inputs, the
           flash backward at head_dim 256 and the two reverse scans their
           designs and per-launch times; the blade's two kernels, with the
           nvm phase's launches (they replace no TPU kernel)

The last line is {"ok": true, "device": {...}}.  Any failure raises and the
script exits non-zero without it.  It also exits non-zero, with no result,
when no CUDA device is available or src/repro_torch is not beside it: its
reason goes to stderr and, as {"phase": "exit", "ok": false, ...}, to stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernel", "parity", "serve", "profile", "store", "train", "train_recurrent",
          "train_stablelm", "train_parity", "lifecycle", "mesh", "nvm")
HBM_BYTES_PER_S = 3.35e12                                   # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}       # dense; fp32 off the tensor cores
SFU_EXP_PER_S = 132 * 16 * 1.98e9   # exponentials: 16 an SM a clock, 132 SMs, 1.98 GHz boost
TOL = {"bfloat16": 2e-2, "float32": 2e-5}                 # tests/test_kernels.py:19-20
RTOL = 1e-2
SCAN_TOL = {"bfloat16": (2e-2, 1e-2), "float32": (5e-4, 1e-3)}  # tests/test_kernels.py:79-80
LLAMA = dict(B=4, Hq=24, Hkv=8, D=128)                     # llama3.2-3b attention widths
RGEMMA = dict(B=4, Hq=16, Hkv=1, D=256)                    # recurrentgemma-9b local attention
STABLELM = dict(B=4, Hq=32, Hkv=8, D=160)                  # stablelm-12b attention widths
KIMI = dict(B=4, Hq=64, Hkv=8, D=112)                      # kimi-k2-1t-a32b attention widths
LLAMA_EMBED = 128256 * 3072                                 # llama3.2-3b's embedding, elements
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 5
# train_recurrent: each model as published (bf16, Adafactor with bf16
# momentum), TRAIN_RECURRENT_STEPS steps of batch x TRAIN_SEQ tokens; per
# step, the forward and the backward launches of each kernel.  The batch is
# the most that fits in 80 GB: falcon-mamba-7b's weights, gradients and
# momentum take 44 GB and 2 x 1024 tokens' activations another ~44 GB
TRAIN_RECURRENT = (("falcon-mamba-7b", 64, 1, {"mamba_scan": 64}),
                   ("recurrentgemma-9b", 38, 2, {"rglru_scan": 26, "flash_attention": 12}))
TRAIN_RECURRENT_STEPS = 4
# train_stablelm: (arch, published layers, layers run, batch).  The
# published 40 layers do not train on one card: 12.14 B parameters at 6 bytes
# each (bf16 weights, gradients and Adafactor momentum) are 73 GB before any
# activation.  24 layers (7.7 B parameters) and 2 x 1024 tokens fit
TRAIN_STABLELM = ("stablelm-12b", 40, 24, 2)
TRAIN_STABLELM_STEPS = 4
FLASH_DESIGN = "wgmma+TMA (bf16); CUDA cores (fp32)"  # the flash kernels: one a dtype
FLASH_FWD_DESIGN = (
    "wgmma+TMA (bf16): a persistent grid of min(tiles, SMs) blocks walking the work tiles "
    "longest first; K and V on barriers of their own, 2-4 stages; each consumer warpgroup "
    "issues Q K_j^T with P_{j-1} V_{j-1} and runs the softmax of S_j under P V, the two "
    "warpgroups taking turns at the tensor cores (named barriers); masks only on edge tiles "
    "(a compile-time path); P V at the true width; CUDA cores (fp32)")
DECODE_DESIGN = ("mma.sync m16n8k16 on a 3-stage cp.async ring, splits from the SM count "
                 "(bf16); CUDA cores, 256-key chunks of the cache (fp32)")
MAMBA_DESIGN = ("4 lanes a channel, N/4 states each; y a tree in a lane, then a "
                "reduce-scatter over the lanes every 16 steps; x, delta, Bm, Cm by cp.async a "
                "tile ahead; in training the state entering every 16 steps written as the "
                "backward's checkpoints (fp32 and bf16)")
RGLRU_DESIGN = ("a block per (row, 32 channels), a lane a channel; its 8 warps split the "
                "sequence into spans of 16 steps a warp: each warp's summary from a zero "
                "carry, folded in warp order through shared memory into each warp's carry in "
                "(its checkpoint), then its steps run from it; the next span's inputs load "
                "meanwhile, kept in x's type until used")
FLASH_BWD_D256_DESIGN = (
    "wgmma+TMA (bf16): dK/dV blocks of 64 keys, each KV group's query heads split over "
    "head_splits blocks (from the shape and SM count; fp32 partials summed in split order by "
    "bwd_reduce); warpgroup 0 computes S^T, warpgroup 1 dP^T over q tiles of 64 rows, P^T "
    "and dS^T exchanged through shared memory, each warpgroup keeping dK, dV of 128 columns; "
    "the dQ kernel on K/V tiles of 48 keys; CUDA cores (fp32)")
TOPK_DESIGN = ("a warp a 1024-block, loaded 16 bytes a lane into padded shared rows; tau the "
               "min(k+1, 32)-th lane max; the entries above tau compacted by ballot (64 at most) "
               "and bitonic-sorted in the warp, then the lowest-index ties at tau; k > 32 or "
               "an overflowing buffer take k rounds of argmax-and-clear in the same kernel")
SCAN_BWD_DESIGN = {
    "mamba_bwd": "chunked reverse scan in two passes, 4 lanes a channel: pass 1 writes the "
                 "summary of every 64 steps right of the first chunk from a zero carry; pass 2, "
                 "a block per (64 channels, chunk, row), chunks sized for 2 blocks an SM, folds "
                 "the summaries to its right in order into the true carry and walks the chunk "
                 "back 16 steps a group, each group's tiles and checkpoint by cp.async a group "
                 "ahead, its states kept in registers; dBm, dCm by a reduce-scatter of "
                 "shuffles over a warp's channels, then the warps, per-block partials summed "
                 "in order",
    "rglru_bwd": "chunked reverse scan in two passes, a thread a (row, 64-step chunk, "
                 "channel): pass 1 writes each chunk's summary from a zero carry, pass 2 folds "
                 "the summaries to its right in order into the true carry and walks the chunk "
                 "again from the forward's checkpoints; dlog_a per (row, chunk), summed in "
                 "order"}
# each launch of a call, by a substring of its kernel's name: the per-launch
# times of the two kernels redesigned for recurrentgemma-9b's training
FLASH_BWD_LAUNCHES = {"prep_ms": "bwd_prep", "dkdv_ms": "bwd_dkdv", "dq_ms": "bwd_dq",
                      "reduce_ms": "bwd_reduce"}
RGLRU_BWD_LAUNCHES = {"pass1_ms": "rglru_bwd_pass1", "pass2_ms": "rglru_bwd_pass2",
                      "sum_ms": "sum_rows"}
# and of the Mamba reverse scan, redesigned for falcon-mamba-7b's training
MAMBA_BWD_LAUNCHES = {"pass1_ms": "mamba_bwd_pass1", "pass2_ms": "mamba_bwd_pass2",
                      "sum_ms": "sum_rows"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _zero_routes() -> None:
    """Sets the attention wrappers' launches_by_route to zero."""
    from repro_torch.kernels import decode_attention, flash_attention, flash_attention_bwd

    for m in (flash_attention, flash_attention_bwd, decode_attention):
        m.launches_by_route = dict.fromkeys(m.ROUTES, 0)


def bound(nbytes: float, flops: float, dtype: str, exps: float = 0.0):
    """(least ms, what bounds it): the largest of bytes over the memory rate,
    operations over the peak of `dtype`, and exponentials over the
    special-function units' rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": flops / PEAK_FLOPS[dtype],
             "sfu": exps / SFU_EXP_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


class Timer:
    """Median device time of one call, each call after an L2 flush (the
    serving path finds each layer's K/V cold: 7 GB of weights pass between
    two visits).  The flush also keeps the card busy while the host enqueues
    the call, so the events time the device, not the host."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.flush_kernels = set()  # the flush's kernel names (Timer.device)

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def _profile(self, fn, iters: int, counts: bool = False):
        """{kernel name: mean device ms a call} over `iters` calls of `fn`,
        each after an L2 flush (torch.profiler); with `counts`, {kernel name:
        (mean device ms a call, launches recorded)}."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        return {e.key: (e.self_device_time_total / 1e3 / iters, e.count) if counts else
                e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                if getattr(e, "self_device_time_total", 0.0) > 0}

    def split(self, fn, names, iters: int = 10):
        """{key: mean device ms a call} of each kernel whose name holds the
        substring `names[key]`, from torch.profiler over `iters` calls, each
        after an L2 flush; None for a kernel the call did not launch."""
        out = dict.fromkeys(names)
        for kernel, t in self._profile(fn, iters).items():
            for key, sub in names.items():
                if sub in kernel:
                    out[key] = (out[key] or 0.0) + t
        return out

    def launches(self, fn, iters: int = 10):
        """[[kernel name, mean device ms], ...]: each launch of one call of
        `fn` in the order the card ran them (torch.profiler over `iters`
        calls, each after an L2 flush; the flush's kernels left out), so a
        kernel launched more than once a call is timed launch by launch.
        None where the trace is not whole calls of the same launches."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                         for e in prof.events() if str(e.device_type).endswith("CUDA"))
        flush = set(self._profile(lambda: None, 2))
        kernels = [(name, us) for _, name, us in kernels if name not in flush]
        if not kernels or len(kernels) % iters:
            return None
        n = len(kernels) // iters
        calls = [kernels[k * n:(k + 1) * n] for k in range(iters)]
        if any([name for name, _ in c] != [name for name, _ in calls[0]] for c in calls):
            return None
        return [[name, float(np.mean([c[j][1] for c in calls])) / 1e3]
                for j, (name, _) in enumerate(calls[0])]

    def device(self, fn, iters: int = 10):
        """Mean device ms a call of every kernel `fn` launches (torch.profiler),
        the flush's own kernel left out: a call's time on the card alone,
        whatever its host time.  The profiler at times drops a session's
        kernels or keeps another's, so a trace counts only when each of its
        kernels was recorded a whole number of times a call (the flush's:
        once), and is taken again otherwise; None (not measured) when ten
        traces were not whole.  It is a measurement beside the events' time,
        never a check: a profiler's lost trace does not fail the run."""
        def whole(trace, n):
            return bool(trace) and all(c > 0 and c % n == 0 for _, c in trace.values())

        for _ in range(10):
            if not self.flush_kernels:
                flush = self._profile(lambda: None, 2, counts=True)
                if whole(flush, 2) and all(c == 2 for _, c in flush.values()):
                    self.flush_kernels = set(flush)
                continue
            trace = {k: v for k, v in self._profile(fn, iters, counts=True).items()
                     if k not in self.flush_kernels}
            if whole(trace, iters):
                return sum(t for t, _ in trace.values())
        print("chip_smoke: torch.profiler gave no whole trace in ten; device time not measured",
              file=sys.stderr, flush=True)
        return None


def flash_case(torch, timer, name, *, B, Hq, Hkv, Sq, Sk, D, dtype, causal=True, window=None,
               device_ms=False):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    route = fa._route(getattr(torch, dtype), D)
    g = torch.Generator(device="cuda").manual_seed(Sq * 7 + Sk)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, Sq, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Hkv, Sk, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Hkv, Sk, D), generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
    out = fa.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs()
    ok = bool((err <= TOL[dtype] + RTOL * want.float().abs()).all())

    # what this run's masks need: the visible (query, key) pairs, and the
    # key rows any query sees
    qpos = np.arange(Sq) + Sk - Sq
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    pairs = int(np.clip(hi - lo, 0, None).sum())
    keys = int(hi.max() - lo.min())
    item = torch.finfo(dt).bits // 8
    nbytes = item * (2 * B * Hq * Sq * D + 2 * B * Hkv * keys * D)
    bound_ms, bound_by = bound(nbytes, 4.0 * B * Hq * D * pairs, dtype)

    mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    qp = torch.arange(Sq, device="cuda")[:, None] + Sk - Sq
    kp = torch.arange(Sk, device="cuda")[None, :]
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    sdpa = torch.nn.functional.scaled_dot_product_attention
    plain_causal = causal and window is None and Sq == Sk
    lib = (lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)) if plain_causal else (
        lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True))
    line = {"phase": "kernel", "kernel": "flash_attention", "case": name, "dtype": dtype,
            "route": route, "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Sk": Sk, "D": D},
            "causal": causal, "window": window, "q_offset": Sk - Sq,
            "max_err": float(err.max()), "tol": {"atol": TOL[dtype], "rtol": RTOL}, "ok": ok,
            "kernel_ms": timer(lambda: fa.flash_attention(q, k, v, **kw)),
            "plain_ms": timer(lambda: ref.flash_attention_reference(q, k, v, **kw)),
            "library_ms": timer(lib),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": 4.0 * B * Hq * D * pairs}
    if device_ms:  # the same two calls' time on the card alone (torch.profiler)
        line["kernel_device_ms"] = timer.device(lambda: fa.flash_attention(q, k, v, **kw))
        line["library_device_ms"] = timer.device(lib)
    if route == "wgmma":
        line["earlier_kernel_ms"] = timer(lambda: _cuda_core_bf16_forward(torch, q, k, v, out, kw))
    emit(line)
    if not ok:
        raise AssertionError(f"flash_attention case {name}: max_err {line['max_err']}")
    return line


def _cuda_core_bf16_forward(torch, q, k, v, out, kw):
    """The CUDA-core forward kernel's bf16 build, which the wrapper no longer
    routes to: the yardstick of the wgmma kernel in the same run."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, sq, d = q.shape
    fa._fn("cuda_core")(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, 1, b, hq,
                        k.shape[1], sq, k.shape[2], d, d ** -0.5, int(kw["causal"]),
                        int(kw["window"] or 0), kw["q_offset"],
                        torch.cuda.current_stream().cuda_stream)


def _cuda_core_bf16_backward(torch, q, k, v, o, lse, do):
    """The CUDA-core backward's bf16 build (causal), as above."""
    from repro_torch.kernels import flash_attention_bwd as fb

    b, hq, s, d = q.shape
    delta = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    grads = [torch.empty_like(t) for t in (q, k, v)]
    fb._fn("cuda_core")(*(t.data_ptr() for t in (q, k, v, o, lse, do, delta, *grads)), 1, b, hq,
                        k.shape[1], s, s, d, d ** -0.5, 1, 0, 0,
                        torch.cuda.current_stream().cuda_stream)


def decode_case(torch, timer, name, *, B, Hq, Hkv, S, D, dtype, lengths):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    route = da._route(getattr(torch, dtype), D)

    g = torch.Generator(device="cuda").manual_seed(S + sum(lengths))
    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(dt)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = da.decode_attention(q, k, v, length=length)
    want = ref.decode_attention_reference(q, k, v, length=length)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs()
    ok = bool((err <= TOL[dtype] + RTOL * want.float().abs()).all())

    live = int(sum(min(n, S) for n in lengths))  # only the live cache is needed
    item = torch.finfo(dt).bits // 8
    nbytes = item * (2 * B * Hq * D + 2 * Hkv * D * live) + 4 * B
    flops = 4.0 * Hq * D * live
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    mask = (torch.arange(S, device="cuda")[None, :] < length[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # SDPA over the whole cache reads every slot; over the live prefix, what
    # the kernel reads
    top = max(min(n, S) for n in lengths)
    k_live, v_live = k[:, :, :top].contiguous(), v[:, :, :top].contiguous()
    line = {"phase": "kernel", "kernel": "decode_attention", "case": name, "dtype": dtype,
            "route": route, "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D},
            "lengths": lengths,
            "n_split": da.n_split(B, Hq, Hkv, D, q.device) if route == "mma" else None,
            "max_err": float(err.max()), "tol": {"atol": TOL[dtype], "rtol": RTOL}, "ok": ok,
            "kernel_ms": timer(lambda: da.decode_attention(q, k, v, length=length)),
            "plain_ms": timer(lambda: ref.decode_attention_reference(q, k, v, length=length)),
            "library_ms": timer(lambda: sdpa(q[:, :, None], k, v, attn_mask=mask,
                                             enable_gqa=True)),
            "library_live_ms": timer(lambda: sdpa(q[:, :, None], k_live, v_live,
                                                  attn_mask=mask[..., :top], enable_gqa=True)),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops}
    if route == "mma":
        line["earlier_kernel_ms"] = timer(lambda: _cuda_core_bf16_decode(torch, q, k, v, length))
    emit(line)
    if not ok:
        raise AssertionError(f"decode_attention case {name}: max_err {line['max_err']}")
    return line


def _cuda_core_bf16_decode(torch, q, k, v, length):
    """The CUDA-core decode kernel's bf16 build, which served bf16 until the
    tensor-core kernel: its yardstick in the same run."""
    from repro_torch.kernels import decode_attention as da

    b, hq, d = q.shape
    lib = da._lib("cuda_core")
    chunks = -(-k.shape[2] // lib.repro_decode_chunk())
    out = torch.empty_like(q)
    ml = torch.empty((b, hq, chunks, 2), dtype=torch.float32, device="cuda")
    acc = torch.empty((b, hq, chunks, d), dtype=torch.float32, device="cuda")
    lib.repro_decode_attention(*(t.data_ptr() for t in (q, k, v, length, out, ml, acc)), 1, b,
                               hq, k.shape[1], k.shape[2], d, chunks, d ** -0.5,
                               torch.cuda.current_stream().cuda_stream)


def _scan_line(kernel, name, dtype, shape, got, want, timer, run, plain, nbytes, flops,
               exps=0.0, **extra):
    """The kernel line of a scan case: (y, hT) against the plain version's;
    `extra` keys added to the line (a `bitwise_repeat` must hold too)."""
    atol, rtol = SCAN_TOL[dtype]
    errs, ok = [], extra.get("bitwise_repeat", True)
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        errs.append(float(err.max()))
        ok = ok and bool((err <= atol + rtol * w.float().abs()).all())
    bound_ms, bound_by = bound(nbytes, flops, "float32", exps)
    line = {"phase": "kernel", "kernel": kernel, "case": name, "dtype": dtype, "shape": shape,
            "max_err": max(errs), "max_err_y_hT": errs, "tol": {"atol": atol, "rtol": rtol},
            "ok": ok, "kernel_ms": timer(run), "plain_ms": timer(plain, iters=3),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops, "exps": exps,
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, **extra}
    emit(line)
    if not ok:
        raise AssertionError(f"{kernel} case {name}: max_err {errs}, {extra}")
    return line


def rglru_case(torch, timer, name, *, B, S, D, dtype, with_h0=False):
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rs

    g = torch.Generator(device="cuda").manual_seed(S + D)
    dt = getattr(torch, dtype)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    x, r, i = rn(B, S, D).to(dt), torch.sigmoid(rn(B, S, D)).to(dt), torch.sigmoid(rn(B, S, D)).to(dt)
    log_a = -torch.exp(rn(D) * 0.3) * 0.1
    h0 = rn(B, D) if with_h0 else None
    got = rs.rglru_scan(x, r, i, log_a, h0)[:2]
    want = ref.rglru_reference(x, r, i, log_a, h0)
    torch.cuda.synchronize()
    item = torch.finfo(dt).bits // 8
    # x, r, i read and y written once; log_a, h0 read and hT written once
    nbytes = item * 4 * B * S * D + 4 * D + 4 * B * D * (2 if with_h0 else 1)
    flops = 12.0 * B * S * D  # c*r*log_a, 2 exp, sqrt, 1-, max, i*x, *, fma (2), 2*
    again = rs.rglru_scan(x, r, i, log_a, h0)[:2]  # the warps' carries fold in a fixed order
    return _scan_line("rglru_scan", name, dtype, {"B": B, "S": S, "D": D, "h0": with_h0},
                      got, want, timer, lambda: rs.rglru_scan(x, r, i, log_a, h0),
                      lambda: ref.rglru_reference(x, r, i, log_a, h0), nbytes, flops,
                      bitwise_repeat=all(a.equal(b) for a, b in zip(got, again)))


def mamba_case(torch, timer, name, *, B, S, Din, N, dtype, with_h0=False):
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(S + Din + N)
    dt = getattr(torch, dtype)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    x = rn(B, S, Din).to(dt)
    delta = torch.nn.functional.softplus(rn(B, S, Din))
    A = -torch.exp(rn(Din, N) * 0.5)
    Bm, Cm = rn(B, S, N).to(dt), rn(B, S, N).to(dt)
    D = rn(Din)
    h0 = rn(B, Din, N) if with_h0 else None
    args = (x, delta, A, Bm, Cm, D, h0)
    got = ms.mamba_scan(*args)[:2]
    want = ref.mamba_scan_reference(*args)
    torch.cuda.synchronize()
    item = torch.finfo(dt).bits // 8
    # x, B, C read and y written in x's type; delta, A, D, h0 read and hT written in fp32
    nbytes = (item * (2 * B * S * Din + 2 * B * S * N) + 4 * B * S * Din + 4 * Din * (N + 1)
              + 4 * B * Din * N * (2 if with_h0 else 1))
    # per state: dt*A, exp, dt*x*B, a*h + b (2), h*C + acc (2); per channel: dt*x, D*x + acc
    flops = 7.0 * B * S * Din * N + 3.0 * B * S * Din
    # one exponential per (b, t, d, n), on the special-function units
    return _scan_line("mamba_scan", name, dtype,
                      {"B": B, "S": S, "Din": Din, "N": N, "h0": with_h0}, got, want, timer,
                      lambda: ms.mamba_scan(*args), lambda: ref.mamba_scan_reference(*args),
                      nbytes, flops, exps=float(B * S * Din * N))


def _grad_errs(got, want, atol, rtol, relative=True):
    """(each gradient's max abs error, each one's relative to its largest
    entry, whether every entry is within atol (times that entry, if
    `relative`) plus rtol of itself): the backward cases' tolerance."""
    abs_errs, rel_errs, ok = [], [], True
    for g, w in zip(got, want):
        err, wf = (g.float() - w.float()).abs(), w.float().abs()
        scale = float(wf.max())
        abs_errs.append(float(err.max()))
        rel_errs.append(float(err.max()) / max(scale, 1e-30))
        ok = ok and bool((err <= atol * (scale if relative else 1.0) + rtol * wf).all())
    return abs_errs, rel_errs, ok


def flash_bwd_case(torch, timer, name, *, B, Hq, Hkv, S, D, dtype, window=None):
    """The backward kernel against its plain version, both given the same
    q, k, v, dO and the kernel forward's o and lse (causal, Sq == Sk, and
    the local window where one is given)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ref

    route = fb._route(getattr(torch, dtype), D)
    g = torch.Generator(device="cuda").manual_seed(S * 3 + D)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, S, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(dt)
    do = torch.randn((B, Hq, S, D), generator=g, device="cuda").to(dt)
    kw = dict(causal=True, window=window)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    args = (q, k, v, o, lse, do)
    got = fb.flash_attention_backward(*args, **kw)
    again = fb.flash_attention_backward(*args, **kw)
    want = ref.flash_attention_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    # the head_dim 256 cases take atol relative to each gradient's largest
    # entry, as the scans' backward cases; the smaller head dims an absolute atol
    errs, rel, ok = _grad_errs(got, want, TOL[dtype], RTOL, relative=D == 256)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    del again, want

    qpos = np.arange(S)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(S, np.int64)
    pairs = int((qpos + 1 - lo).sum())  # the visible (query, key) pairs
    item = torch.finfo(dt).bits // 8
    # q, o, dO read and dq written; k, v read and dk, dv written; lse read
    nbytes = item * (4 * B * Hq * S * D + 4 * B * Hkv * S * D) + 4 * B * Hq * S
    flops = 2.5 * 4.0 * B * Hq * D * pairs  # dV, dP, dS.K, dS^T.Q against the forward's two
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        if window is None or window >= S:  # exactly causal: SDPA's causal flash backend
            lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                                       enable_gqa=True)
        else:
            qp, kp = torch.arange(S, device="cuda")[:, None], torch.arange(S, device="cuda")
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=(kp <= qp) & (kp > qp - window), enable_gqa=True)
    line = {"phase": "kernel", "kernel": "flash_attention_bwd", "case": name, "dtype": dtype,
            "route": route, "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D},
            "causal": True, "window": window,
            "max_err": max(errs), "max_err_dq_dk_dv": errs, "max_err_rel_to_scale": rel,
            "tol": {"atol_rel_to_scale" if D == 256 else "atol": TOL[dtype], "rtol": RTOL},
            "bitwise_repeat": bitwise,
            "ok": ok and bitwise,
            "kernel_ms": timer(lambda: fb.flash_attention_backward(*args, **kw)),
            "plain_ms": timer(lambda: ref.flash_attention_backward_reference(*args, **kw),
                              iters=3),
            "library_ms": timer(lambda: torch.autograd.grad(lib_out, leaves, do,
                                                            retain_graph=True)),
            "library": "backward of scaled_dot_product_attention, timed alone",
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops}
    if route == "wgmma" and window is None:  # the CUDA-core kernel's bf16 build, causal
        line["earlier_kernel_ms"] = timer(lambda: _cuda_core_bf16_backward(torch, *args))
    if route == "wgmma" and D == 256:  # each launch's time, and the head splits they ran
        line.update(timer.split(lambda: fb.flash_attention_backward(*args, **kw),
                                FLASH_BWD_LAUNCHES))
        line["head_splits"] = fb.last_head_splits
        if (line["reduce_ms"] is None) != (line["head_splits"] == 1):
            raise AssertionError(f"flash_bwd case {name}: head_splits {line['head_splits']} "
                                 f"but reduce_ms {line['reduce_ms']}")
    emit(line)
    del lib_out, leaves
    if not line["ok"]:
        raise AssertionError(f"flash_attention_bwd case {name}: {errs}, bitwise {bitwise}")
    return line


def _scan_bwd_line(kernel, name, dtype, shape, timer, run, plain, nbytes, flops, exps,
                   **extra):
    """The kernel line of a scan's backward case: every gradient against the
    plain backward's (the scans' tolerance, relative to each gradient's
    largest entry), two runs bitwise equal, no library call; `extra` keys
    added to the line."""
    got, again, want = run(), run(), plain()
    errs, rel, ok = _grad_errs(got, want, *SCAN_TOL[dtype])
    bitwise = all(a.equal(b) for a, b in zip(got, again))
    del got, again, want
    bound_ms, bound_by = bound(nbytes, flops, "float32", exps)
    line = {"phase": "kernel", "kernel": kernel, "case": name, "dtype": dtype, "shape": shape,
            "max_err": max(errs), "max_err_each": errs, "max_err_rel_to_scale": rel,
            "tol": dict(zip(("atol_rel_to_scale", "rtol"), SCAN_TOL[dtype])),
            "bitwise_repeat": bitwise, "ok": ok and bitwise, "kernel_ms": timer(run),
            "plain_ms": timer(plain, iters=3), "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops, "exps": exps,
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, **extra}
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"{kernel} case {name}: {errs} (rel {rel}), bitwise {bitwise}")
    return line


def mamba_bwd_case(torch, timer, name, *, B, S, Din, N, dtype):
    """mamba_scan_backward (with h0 and dhT) against the plain reverse scan,
    from the kernel forward's checkpoints."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(S + Din + N + 1)
    dt = getattr(torch, dtype)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    x, delta = rn(B, S, Din).to(dt), torch.nn.functional.softplus(rn(B, S, Din))
    A = -torch.exp(rn(Din, N) * 0.5)
    Bm, Cm, D, h0 = rn(B, S, N).to(dt), rn(B, S, N).to(dt), rn(Din), rn(B, Din, N)
    dy, dhT = rn(B, S, Din).to(dt), rn(B, Din, N)
    args = (x, delta, A, Bm, Cm, D, h0)
    ckpt = ms.mamba_scan(*args, checkpoints=True)[2]
    run = lambda: ms.mamba_scan_backward(*args, dy, dhT, ckpt)  # noqa: E731
    item = torch.finfo(dt).bits // 8
    # x, dy, Bm, Cm read and dx, dBm, dCm written in x's type; delta, the
    # checkpoints, A, D, dhT read and ddelta, dA, dD, dh0 written in fp32
    nbytes = (item * (3 * B * S * Din + 4 * B * S * N) + 4 * (2 * B * S * Din
              + B * -(-S // ms.CHUNK) * Din * N + 2 * (Din * N + Din) + 2 * B * Din * N))
    # per state a step: a_t (exp), g (2), a h (1), the dx, ddelta, dA, dBm,
    # dCm shares (10), a g (1), and h_t again (3)
    flops = 17.0 * B * S * Din * N
    return _scan_bwd_line(
        "mamba_scan_bwd", name, dtype, {"B": B, "S": S, "Din": Din, "N": N, "h0": True,
                                        "dhT": True}, timer, run,
        lambda: ref.mamba_scan_backward_reference(*args, dy, dhT, chunk=ms.CHUNK),
        nbytes, flops, exps=float(B * S * Din * N),  # a_t once per (b, t, d, n) at least
        chunk=ms.bwd_chunk(B, S, Din, torch.cuda.get_device_properties(0).multi_processor_count),
        launch_ms=timer.launches(run), **timer.split(run, MAMBA_BWD_LAUNCHES))


def rglru_bwd_case(torch, timer, name, *, B, S, D, dtype):
    """rglru_scan_backward (with h0 and dhT) against the plain reverse scan,
    from the kernel forward's checkpoints."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rs

    g = torch.Generator(device="cuda").manual_seed(S + D + 1)
    dt = getattr(torch, dtype)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    x, r, i = rn(B, S, D).to(dt), torch.sigmoid(rn(B, S, D)).to(dt), torch.sigmoid(rn(B, S, D)).to(dt)
    log_a, h0 = -torch.exp(rn(D) * 0.3) * 0.1, rn(B, D)
    dy, dhT = rn(B, S, D).to(dt), rn(B, D)
    ckpt = rs.rglru_scan(x, r, i, log_a, h0, checkpoints=True)[2]
    run = lambda: rs.rglru_scan_backward(x, r, i, log_a, h0, dy, dhT, ckpt)  # noqa: E731
    item = torch.finfo(dt).bits // 8
    # x, r, i, dy read and dx, dr, di written; checkpoints, log_a, h0, dhT
    # read and dlog_a, dh0 written in fp32
    nbytes = item * 7 * B * S * D + 4 * (B * -(-S // rs.CHUNK) * D + 2 * D + 3 * B * D)
    flops = 24.0 * B * S * D  # the forward's 12 again for h, and ~12 for the reverse step
    return _scan_bwd_line(
        "rglru_scan_bwd", name, dtype, {"B": B, "S": S, "D": D, "h0": True, "dhT": True}, timer,
        run, lambda: ref.rglru_backward_reference(x, r, i, log_a, h0, dy, dhT), nbytes, flops,
        0.0, chunk=rs.BWD_CHUNK, **timer.split(run, RGLRU_BWD_LAUNCHES))


def topk_input(torch, case, n, k=10):
    """A delta of `n` fp32 elements for the top-k cases, made on the card from
    a seed: "random", normal values of std 1e-3 (every block's magnitudes
    distinct); "lifecycle", a delta commit's as the lifecycle makes them, the
    difference of two bf16 states that differ in ~4 entries a 1024-block
    (most blocks have fewer than k nonzeros); "ties", seven levels
    (0, +-1e-3, +-2e-3, +-3e-3), so tau falls on a long run of ties."""
    g = torch.Generator(device="cuda").manual_seed(k)
    if case == "random":
        return torch.randn(n, generator=g, device="cuda") * 1e-3
    if case == "lifecycle":
        base = torch.randn(n, generator=g, device="cuda").to(torch.bfloat16)
        hit = torch.rand(n, generator=g, device="cuda") < 4 / 1024
        step = torch.randn(n, generator=g, device="cuda") * 0.05 * hit
        return (base.float() + step).to(torch.bfloat16).float() - base.float()
    if case == "ties":
        return torch.randint(-3, 4, (n,), generator=g, device="cuda").float() * 1e-3
    raise ValueError(case)


def topk_case(torch, timer, name, *, n, k, case="random", dtype="float32"):
    """topk_compress on a delta the size of `n` elements (`topk_input`): bit
    for bit against the plain version (a stable sort, ties to the lowest
    index) and against a second run; the share of blocks that took the
    kernel's fallback (the rounds), as a third run records it, held against
    the plain model of that decision (`fallback_blocks`) on the same input."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_compress as tk

    x = topk_input(torch, case, n, k).to(getattr(torch, dtype))
    got = tk.topk_compress(x, k)
    again = tk.topk_compress(x, k)
    *third, path = tk.topk_compress(x, k, paths=True)
    want = ref.topk_compress_reference(x, k)
    torch.cuda.synchronize()

    def bits(t):  # floats as integers, so that -0.0 and +0.0 differ
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    exact = [bool(torch.equal(bits(a), bits(b))) for a, b in zip(got, want)]
    repeat = all(bool(torch.equal(bits(a), bits(b))) for a, b in zip(got, again))
    repeat = repeat and all(bool(torch.equal(bits(a), bits(b))) for a, b in zip(got, third))
    del got, again, third, want
    model_agrees = bool(torch.equal(path, tk.fallback_blocks(x, k)))
    nb = path.numel()
    item = torch.finfo(x.dtype).bits // 8
    nbytes = 2 * item * n + nb * k * 8  # x read, residual written, vals and idx written
    bound_ms, bound_by = bound(nbytes, float(k) * n, "float32")  # a compare per element a round
    mags = x.view(-1, 1024).abs() if n % 1024 == 0 else None
    line = {"phase": "kernel", "kernel": "topk_compress", "case": name, "input": case,
            "dtype": dtype, "n": n, "k": k, "exact_vals_idx_residual": exact,
            "bitwise_repeat": repeat, "fallback_share": float(path.float().mean()),
            "fallback_model_agrees": model_agrees,
            "max_err": 0.0 if all(exact) else None, "ok": all(exact) and repeat and model_agrees,
            "kernel_ms": timer(lambda: tk.topk_compress(x, k)),
            "plain_ms": timer(lambda: ref.topk_compress_reference(x, k), iters=3),
            "library_ms": timer(lambda: torch.topk(mags, k, dim=1)) if mags is not None else None,
            "library": "torch.topk of the [nb, 1024] magnitudes (selection only)",
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": float(k) * n}
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"topk_compress case {name}: exact {exact}, repeat {repeat}, "
                             f"fallback model agrees {model_agrees}")
    return line


def fletcher_case(torch, timer, name, kernel, chunks):
    """The checksum kernel on `chunks` (uint8 tensors on the card) against
    its plain version and the host's fletcher32_padded, all exact.  The
    "fletcher32" kernel is the one-segment call of the same kernel."""
    from repro_torch.kernels import log_checksum as lc
    from repro_torch.kernels import ref
    from repro_torch.statestore import fletcher32_padded

    if kernel == "fletcher32":
        run = lambda: lc.fletcher32(chunks[0])  # noqa: E731
        plain = lambda: ref.fletcher32_reference(chunks[0])  # noqa: E731
    else:
        run = lambda: lc.fletcher32_wave(chunks)  # noqa: E731
        plain = lambda: ref.fletcher32_wave_reference(chunks)  # noqa: E731
    got = [int(c) for c in run().reshape(-1).tolist()]
    want_plain = [int(c) for c in plain().reshape(-1).tolist()]
    t0 = time.perf_counter()
    want_host = [fletcher32_padded(c.cpu().numpy().tobytes()) for c in chunks]
    host_s = time.perf_counter() - t0
    nbytes = sum(c.numel() for c in chunks)
    words = nbytes / 2
    bound_ms, bound_by = bound(nbytes, 3.0 * words, "float32")  # add, multiply-add per word
    line = {"phase": "kernel", "kernel": kernel, "case": name, "segments": len(chunks),
            "bytes": nbytes, "equal_plain": got == want_plain, "equal_host": got == want_host,
            "max_err": 0.0 if got == want_plain == want_host else None,
            "ok": got == want_plain == want_host, "host_checksum_s": host_s,
            "kernel_ms": timer(run), "plain_ms": timer(plain, iters=3), "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"{kernel} case {name}: {got[:4]} plain {want_plain[:4]} "
                             f"host {want_host[:4]}")
    return line


def _lifecycle_model(torch):
    """The lifecycle's model and train config: llama3.2-3b widths cut to
    depth 2, bf16, Adafactor with bf16 momentum."""
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.training import OptConfig, TrainConfig

    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2)
    return DecoderLM(cfg), TrainConfig(opt=OptConfig(kind="adafactor", lr=1e-3,
                                                     momentum_dtype="bfloat16"))


def phase_kernels(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "kernel", "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    timer = Timer(torch)
    lines = {}
    lines["flash"] = flash_case(torch, timer, "llama3.2-3b prefill", Sq=1024, Sk=1024,
                                dtype="bfloat16", device_ms=True, **LLAMA)
    flash_case(torch, timer, "llama3.2-3b prefill fp32", Sq=1024, Sk=1024, dtype="float32",
               **LLAMA)
    flash_case(torch, timer, "window 128", Sq=1024, Sk=1024, dtype="bfloat16", window=128,
               **LLAMA)
    flash_case(torch, timer, "qwen1.5-0.5b prefill (MHA, D=64)", B=4, Hq=16, Hkv=16, Sq=1024,
               Sk=1024, D=64, dtype="bfloat16")
    flash_case(torch, timer, "ragged Sk, q_offset", Sq=200, Sk=1000, dtype="bfloat16", **LLAMA)
    lengths = [1025, 1056, 1040, 1031]
    lines["decode"] = decode_case(torch, timer, "llama3.2-3b decode, cache 32768", S=32768,
                                  dtype="bfloat16", lengths=lengths, **LLAMA)
    decode_case(torch, timer, "llama3.2-3b decode fp32, cache 32768", S=32768,
                dtype="float32", lengths=lengths, **LLAMA)
    flash_case(torch, timer, "recurrentgemma-9b prefill (MQA, D=256)", Sq=3072, Sk=3072,
               dtype="bfloat16", window=2048, **RGEMMA)
    lines["decode_rgemma"] = decode_case(torch, timer, "recurrentgemma-9b decode, ring 2048",
                                         S=2048, dtype="bfloat16", lengths=[2048] * 4, **RGEMMA)
    lines["rglru"] = rglru_case(torch, timer, "recurrentgemma-9b prefill", B=4, S=3072, D=4096,
                                dtype="bfloat16")
    lines["rglru_train"] = rglru_case(torch, timer, "recurrentgemma-9b training",
                                      B=TRAIN_RECURRENT[1][2], S=TRAIN_SEQ, D=4096,
                                      dtype="bfloat16")
    rglru_case(torch, timer, "recurrentgemma-9b prefill fp32", B=4, S=3072, D=4096,
               dtype="float32")
    rglru_case(torch, timer, "ragged S 1000, h0", B=4, S=1000, D=4096, dtype="float32",
               with_h0=True)
    lines["mamba"] = mamba_case(torch, timer, "falcon-mamba-7b prefill", B=4, S=1024, Din=8192,
                                N=16, dtype="bfloat16")
    mamba_case(torch, timer, "falcon-mamba-7b prefill fp32", B=4, S=1024, Din=8192, N=16,
               dtype="float32")
    mamba_case(torch, timer, "ragged S 1000, h0", B=4, S=1000, Din=8192, N=16, dtype="float32",
               with_h0=True)
    lines["flash_bwd"] = flash_bwd_case(torch, timer, "llama3.2-3b training", S=TRAIN_SEQ,
                                        dtype="bfloat16", **LLAMA)
    flash_bwd_case(torch, timer, "llama3.2-3b training fp32", S=TRAIN_SEQ, dtype="float32",
                   **LLAMA)
    rg_train = dict(RGEMMA, B=TRAIN_RECURRENT[1][2], S=TRAIN_SEQ, window=2048)
    lines["flash_bwd_d256"] = flash_bwd_case(torch, timer, "recurrentgemma-9b training",
                                             dtype="bfloat16", **rg_train)
    flash_bwd_case(torch, timer, "recurrentgemma-9b training fp32", dtype="float32", **rg_train)
    flash_bwd_case(torch, timer, "recurrentgemma-9b (MQA, D=256), S 3072, window 2048", S=3072,
                   dtype="bfloat16", window=2048, **RGEMMA)
    torch.cuda.empty_cache()
    # head dims 160 (stablelm-12b) and 112 (kimi-k2), at the shapes their
    # serve, train_stablelm and train_parity runs give the kernels
    for key, name, widths, prompt, lengths in (
            ("d160", "stablelm-12b", STABLELM, 1024, [1025, 1056, 1040, 1031]),
            ("d112", "kimi-k2-1t-a32b", KIMI, 256, [257, 288, 270, 263])):
        d = widths["D"]
        lines[f"flash_{key}"] = flash_case(torch, timer, f"{name} prefill (D={d}), S 1024",
                                           Sq=1024, Sk=1024, dtype="bfloat16", device_ms=True,
                                           **widths)
        flash_case(torch, timer, f"{name} prefill fp32 (D={d}), S 1024", Sq=1024, Sk=1024,
                   dtype="float32", **widths)
        if prompt != 1024:  # the serve phase's own prompt
            lines[f"flash_{key}_serve"] = flash_case(
                torch, timer, f"{name} prefill (D={d}), S {prompt}", Sq=prompt, Sk=prompt,
                dtype="bfloat16", device_ms=True, **widths)
        lines[f"decode_{key}"] = decode_case(torch, timer, f"{name} decode (D={d}), cache 32768",
                                             S=32768, dtype="bfloat16", lengths=lengths, **widths)
        decode_case(torch, timer, f"{name} decode fp32 (D={d}), cache 32768", S=32768,
                    dtype="float32", lengths=lengths, **widths)
        train = dict(widths, B=2, S=TRAIN_SEQ)
        lines[f"flash_bwd_{key}"] = flash_bwd_case(torch, timer, f"{name} training (D={d})",
                                                   dtype="bfloat16", **train)
        flash_bwd_case(torch, timer, f"{name} training fp32 (D={d})", dtype="float32", **train)
        torch.cuda.empty_cache()
    lines["mamba_bwd"] = mamba_bwd_case(torch, timer, "falcon-mamba-7b, h0 and dhT", B=4,
                                        S=1024, Din=8192, N=16, dtype="bfloat16")
    mamba_bwd_case(torch, timer, "falcon-mamba-7b fp32, h0 and dhT", B=4, S=1024, Din=8192,
                   N=16, dtype="float32")
    lines["rglru_bwd"] = rglru_bwd_case(torch, timer, "recurrentgemma-9b, h0 and dhT", B=4,
                                        S=3072, D=4096, dtype="bfloat16")
    rglru_bwd_case(torch, timer, "recurrentgemma-9b fp32, h0 and dhT", B=4, S=3072, D=4096,
                   dtype="float32")
    falcon, rgemma = TRAIN_RECURRENT  # and at the shapes train_recurrent gives them
    lines["mamba_bwd_train"] = mamba_bwd_case(
        torch, timer, "falcon-mamba-7b training, h0 and dhT", B=falcon[2], S=TRAIN_SEQ,
        Din=8192, N=16, dtype="bfloat16")
    mamba_bwd_case(torch, timer, "ragged S 1000, h0 and dhT", B=falcon[2], S=1000, Din=8192,
                   N=16, dtype="float32")
    lines["rglru_bwd_train"] = rglru_bwd_case(
        torch, timer, "recurrentgemma-9b training, h0 and dhT", B=rgemma[2], S=TRAIN_SEQ,
        D=4096, dtype="bfloat16")
    torch.cuda.empty_cache()
    lines["topk"] = topk_case(torch, timer, "llama3.2-3b embedding delta", n=LLAMA_EMBED, k=10)
    torch.cuda.empty_cache()
    lines["topk_lifecycle"] = topk_case(torch, timer, "a lifecycle-like delta (bf16 states, "
                                        "~4 changes a block)", n=LLAMA_EMBED, k=10,
                                        case="lifecycle")
    torch.cuda.empty_cache()
    lines["topk_ties"] = topk_case(torch, timer, "seven levels: ties at tau", n=LLAMA_EMBED,
                                   k=10, case="ties")
    torch.cuda.empty_cache()
    topk_case(torch, timer, "bf16, ragged, k 37 (the rounds)", n=(1 << 24) + 5, k=37,
              dtype="bfloat16")
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(32)
    stream = torch.randint(0, 256, (1 << 30,), dtype=torch.uint8, device="cuda", generator=g)
    lines["fletcher32"] = fletcher_case(torch, timer, "1 GiB stream", "fletcher32", [stream])
    del stream
    from repro_torch.kernels.log_checksum import as_bytes
    from repro_torch.training import init_train_state
    from repro_torch.tree import flatten_named

    model, tcfg = _lifecycle_model(torch)
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(9), tcfg)
    lines["fletcher32_wave"] = fletcher_case(
        torch, timer, "the lifecycle's train state (llama3.2-3b widths, depth 2, Adafactor)",
        "fletcher32_wave", [as_bytes(t.contiguous()) for _, t in flatten_named(state)])
    del state, model
    del timer
    torch.cuda.empty_cache()
    return lines


def _paths(torch, cfg, params, toks, prompt, **over):
    """Logits of prefill over toks[:, :prompt] and of a decode step for each
    token after it, stacked, on the config with `over` applied."""
    from repro_torch.models import DecoderLM

    model = DecoderLM(dataclasses.replace(cfg, **over))
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": toks[:, :prompt]})
        outs = [logits]
        for t in range(prompt, toks.shape[1]):
            logits, cache = model.decode_step(params, cache, toks[:, t])
            outs.append(logits)
        del cache
        return torch.stack(outs).float()


def phase_parity(torch):
    """Kernel path against plain path on the same full-width float32 weights.

    llama3.2-3b holds the bound at depth 2.  Deeper, this randomly
    initialised model is chaotic: the JAX fan-in rule puts the attention
    logits at a std of ~220, so near-ties amplify any change of summation
    order.  Changing only the plain path's block_k moves the depth-28 logits
    as much as the kernels do, and both are reported.  falcon-mamba-7b runs
    two Mamba layers; recurrentgemma-9b one (rglru, rglru, local_attn)
    pattern with a prompt of 2304, past its window of 2048, so the window
    mask and the ring cache act.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    lines = []
    line = {"phase": "parity", "arch": "llama3.2-3b", "dtype": "float32", "batch": 2,
            "prompt": 256, "decode_steps": 4, "tol": 2e-3}
    toks = torch.randint(0, 128256, (2, 260), generator=gen(1), device="cuda")
    for layers in (2, 28):
        cfg = dataclasses.replace(get_config("llama3.2-3b"), dtype="float32", n_layers=layers)
        params = DecoderLM(cfg).init(gen(0))
        got = _paths(torch, cfg, params, toks, 256, attn_impl="cuda")
        want = _paths(torch, cfg, params, toks, 256, attn_impl="torch")
        finite = bool(torch.isfinite(got).all())
        if layers == 2:
            line.update(layers=2, cut="depth 28 -> 2; widths as published",
                        max_abs_logit_err=float((got - want).abs().max()), finite=finite,
                        logit_absmax=float(want.abs().max()))
        else:
            other = _paths(torch, cfg, params, toks, 256, attn_impl="torch", attn_block_k=64)
            line["depth_28"] = {"kernel_vs_plain": float((got - want).abs().max()),
                                "plain_vs_plain_block_k_64": float((other - want).abs().max()),
                                "finite": finite}
            del other
        del params, got, want
        torch.cuda.empty_cache()
    emit(line)
    lines.append(line)
    if not line["depth_28"]["finite"]:
        raise AssertionError(f"parity: {line}")

    for arch, layers, cut, prompt in (
            ("falcon-mamba-7b", 2, "depth 64 -> 2; widths as published", 256),
            ("recurrentgemma-9b", 3, "depth 38 -> 3, one (rglru, rglru, local_attn) pattern; "
             "widths as published", 2304)):
        cfg = dataclasses.replace(get_config(arch), dtype="float32", n_layers=layers)
        params = DecoderLM(cfg).init(gen(0))
        toks = torch.randint(0, cfg.vocab_size, (2, prompt + 4), generator=gen(1), device="cuda")
        got = _paths(torch, cfg, params, toks, prompt, attn_impl="cuda")
        want = _paths(torch, cfg, params, toks, prompt, attn_impl="torch")
        line = {"phase": "parity", "arch": arch, "dtype": "float32", "batch": 2,
                "prompt": prompt, "decode_steps": 4, "tol": 2e-3, "layers": layers, "cut": cut,
                "max_abs_logit_err": float((got - want).abs().max()),
                "finite": bool(torch.isfinite(got).all()),
                "logit_absmax": float(want.abs().max())}
        if cfg.window:  # the same yardstick as llama's depth 28: the plain path against itself
            other = _paths(torch, cfg, params, toks, prompt, attn_impl="torch", attn_block_k=64)
            line["plain_vs_plain_block_k_64"] = float((other - want).abs().max())
            del other
        emit(line)
        lines.append(line)
        del params, got, want
        torch.cuda.empty_cache()
    for line in lines:
        if not (line["max_abs_logit_err"] <= 2e-3 and line["finite"]):
            raise AssertionError(f"parity: {line}")


# the serve phase's models and traffic: (arch, published layers, layers run,
# prompt, launches per request of each kernel: one per layer of its mixer at
# prefill, one per attention layer and decode step).  kimi-k2-1t-a32b runs
# its published widths cut to 2 layers, layer 0 dense and layer 1 MoE with
# all 384 experts: the 61 layers are 1.03 T parameters, and layer 1 alone is
# 17 B (34 GB in bf16)
SERVE = (("llama3.2-3b", 28, 28, 1024, {"flash_attention": 28, "decode_attention": 28 * 32}),
         ("falcon-mamba-7b", 64, 64, 1024, {"mamba_scan": 64}),
         ("recurrentgemma-9b", 38, 38, 3072, {"rglru_scan": 26, "flash_attention": 12,
                                              "decode_attention": 12 * 32}),
         ("stablelm-12b", 40, 40, 1024, {"flash_attention": 40, "decode_attention": 40 * 32}),
         ("kimi-k2-1t-a32b", 61, 2, 256, {"flash_attention": 2, "decode_attention": 2 * 32}))


def _serve_cut(torch, arch, layers, batch, prompt, max_new, requests):
    """serve.main's run at the published `arch` cut to `layers`: the same
    DecoderLM, ServeEngine and request loop, with the seed serve.main uses."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import DecoderLM
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ServeEngine(model, params, ServeConfig(batch_slots=batch, max_new_tokens=max_new),
                      device="cuda")
    del params
    stats = serve.serve_requests(eng, cfg.vocab_size, batch, prompt, requests, seed=0)
    del eng
    return stats


def phase_serve(torch):
    """One serve line per model; returns each kernel's launches summed over
    the phase, and each model's."""
    from repro_torch.kernels import decode_attention, flash_attention, mamba_scan, rglru_scan
    from repro_torch.launch import serve

    mods = {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "rglru_scan": rglru_scan, "mamba_scan": mamba_scan}
    batch, requests, max_new = 4, 3, 32
    total = dict.fromkeys(mods, 0)
    by_arch = {}
    for arch, published, layers, prompt, per_request in SERVE:
        torch.cuda.reset_peak_memory_stats()
        for m in mods.values():
            m.launches = 0
        _zero_routes()
        if layers == published:
            stats = serve.main(["--arch", arch, "--full", "--batch", str(batch), "--prompt-len",
                                str(prompt), "--max-new", str(max_new), "--requests",
                                str(requests)])
        else:
            stats = _serve_cut(torch, arch, layers, batch, prompt, max_new, requests)
        launches = {k: m.launches for k, m in mods.items()}
        steady = slice(1, None)  # the first request also loads the kernels and cuBLAS
        line = {"phase": "serve", "arch": arch, "layers": layers,
                "reduced": None if layers == published else {"n_layers": [published, layers]},
                "dtype": "bfloat16", "batch": batch, "prompt_len": prompt, "max_new": max_new,
                "requests": requests,
                "prefill_ms": [t * 1e3 for t in stats["prefill_s"]],
                "decode_ms_per_step": [t * 1e3 / n for t, n in zip(stats["decode_s"],
                                                                  stats["decode_steps"])],
                "steady_prefill_ms": float(np.median([t * 1e3 for t in
                                                      stats["prefill_s"][steady]])),
                "steady_decode_ms_per_step": float(np.median(
                    [t * 1e3 / n for t, n in zip(stats["decode_s"][steady],
                                                  stats["decode_steps"][steady])])),
                "tokens": stats["tokens"], "seconds": stats["seconds"],
                "tokens_per_s": stats["tokens"] / stats["seconds"],
                "logits_finite": stats["logits_finite"],
                "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches,
                "flash_launches_by_route": dict(flash_attention.launches_by_route),
                "decode_launches_by_route": dict(decode_attention.launches_by_route)}
        emit(line)
        want = {k: per_request.get(k, 0) * requests for k in mods}
        routes = {"wgmma": want["flash_attention"], "cuda_core": 0}
        decode_routes = {"mma": want["decode_attention"], "cuda_core": 0}
        if (launches != want or line["flash_launches_by_route"] != routes
                or line["decode_launches_by_route"] != decode_routes
                or not stats["logits_finite"]):
            raise AssertionError(f"serve {arch}: launches {launches}, want {want}; flash routes "
                                 f"{line['flash_launches_by_route']}, want {routes}; decode "
                                 f"routes {line['decode_launches_by_route']}, want "
                                 f"{decode_routes}; finite {stats['logits_finite']}")
        for k in mods:
            total[k] += launches[k]
        by_arch[arch] = launches
        torch.cuda.empty_cache()
    return total, by_arch


def phase_profile(torch, arch, prompt, layers=None):
    """Where a request's time goes: one prefill and three decode steps of
    the published `arch` (cut to `layers`, as the serve phase runs it) under
    torch.profiler, after a warm-up.  Device time is the sum of kernel times
    (one stream, so they do not overlap); the rest of the wall time the card
    is idle, waiting for the host."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, prompt), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(4))
    line = {"phase": "profile", "arch": arch, "layers": cfg.n_layers, "batch": 4,
            "prompt_len": prompt}
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": toks})
        nxt = logits.argmax(-1)
        for _ in range(3):
            logits, cache = model.decode_step(params, cache, nxt)
            nxt = logits.argmax(-1)
        for name, steps in (("prefill", 1), ("decode_step", 3)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    if name == "prefill":
                        logits, cache = model.prefill(params, {"tokens": toks})
                    else:
                        logits, cache = model.decode_step(params, cache, nxt)
                    nxt = logits.argmax(-1)
                enqueue = time.perf_counter() - t0
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = prof.key_averages()
            dev = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 / steps
                   for e in events if getattr(e, "self_device_time_total", 0.0) > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA}
            launches = sum(e.count for e in events
                           if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
            device_ms = sum(dev.values())
            top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
            line[name] = {"wall_ms": wall * 1e3 / steps, "host_enqueue_ms": enqueue * 1e3 / steps,
                          "device_ms": device_ms,
                          "device_idle_share": max(0.0, 1 - device_ms / (wall * 1e3 / steps)),
                          "kernel_launches": launches / steps,
                          "top_device_ms": [[k[:60], v] for k, v in top]}
        del cache
    emit(line)
    del params
    torch.cuda.empty_cache()


def phase_store(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.statestore import AsymStore, CheckpointManager, FileBlade

    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(2))
    scfg = ServeConfig(batch_slots=2, max_new_tokens=8)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    want, _ = ServeEngine(model, params, scfg).generate(prompts)
    with tempfile.TemporaryDirectory() as tmp:
        primary, mirror = os.path.join(tmp, "primary"), os.path.join(tmp, "mirror")
        t0 = time.perf_counter()
        CheckpointManager(AsymStore(FileBlade(primary, mirrors=[mirror]))).save_full(
            1, {"params": params})
        commit_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in Path(primary, "data").iterdir())
        restore_s, same = {}, {}
        for name, path in (("primary", primary), ("mirror", mirror)):
            t0 = time.perf_counter()
            eng = ServeEngine.load_from_store(model, CheckpointManager(AsymStore(FileBlade(path))),
                                              scfg)
            torch.cuda.synchronize()
            restore_s[name] = time.perf_counter() - t0
            got, stats = eng.generate(prompts)
            same[name] = bool(np.array_equal(got, want)) and stats["version"] == 1
            del eng
    line = {"phase": "store", "arch": "llama3.2-3b", "n_layers": 2,
            "cut": "depth 28 -> 2 layers; widths as published", "dtype": "bfloat16",
            "bytes": nbytes, "commit_s": commit_s, "restore_s": restore_s,
            "same_tokens": same}
    emit(line)
    del params
    torch.cuda.empty_cache()
    if not all(same.values()):
        raise AssertionError(f"store: tokens differ {same}")


def phase_train(torch):
    """The training main path at the published llama3.2-3b: returns the
    flash forward and backward launches of the phase."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.launch import train

    layers = 28
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fb.launches = 0
    _zero_routes()
    out = train.main(["--arch", "llama3.2-3b", "--full", "--steps", str(TRAIN_STEPS),
                      "--global-batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ)])
    launches = {"flash_attention": fa.launches, "flash_attention_bwd": fb.launches}
    routes = {"flash_attention": dict(fa.launches_by_route),
              "flash_attention_bwd": dict(fb.launches_by_route)}
    steady = out["step_s"][1:]  # the first step also loads the kernels and cuBLAS
    step_ms = float(np.median(steady)) * 1e3
    line = {"phase": "train", "arch": "llama3.2-3b", "layers": layers, "dtype": "bfloat16",
            "optimizer": "adamw", "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "step_ms": [t * 1e3 for t in out["step_s"]],
            "median_steady_step_ms": step_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
            "losses": out["losses"], "grad_norms": out["grad_norms"],
            "all_finite": out["all_finite"], "seconds": out["seconds"],
            "max_memory_allocated": out["max_memory_allocated"], "launches": launches,
            "launches_by_route": routes}
    emit(line)
    want = {k: layers * TRAIN_STEPS for k in launches}
    want_routes = {k: {"wgmma": n, "cuda_core": 0} for k, n in want.items()}
    if launches != want or routes != want_routes or not out["all_finite"]:
        raise AssertionError(f"train: launches {launches}, want {want}; routes {routes}; "
                             f"finite {out['all_finite']}")
    torch.cuda.empty_cache()
    _train_grad_norms(torch)
    _train_profile(torch)
    return launches


def _train_batch(torch, vocab, batch=TRAIN_BATCH):
    from repro_torch.data import DataConfig, SyntheticPipeline

    dcfg = DataConfig(vocab_size=vocab, global_batch=batch, seq_len=TRAIN_SEQ)
    return {k: torch.from_numpy(v).cuda() for k, v in SyntheticPipeline(dcfg).batch_at(0).items()}


def _train_grad_norms(torch):
    """The train line's step-0 gradient norm, taken apart: each tensor's
    gradient norm in float64 on the kernel path and on the plain path, from
    the train phase's own weights (seed 0) and first batch."""
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.tree import flatten_named, tree_map_named

    cfg = get_config("llama3.2-3b")
    params = DecoderLM(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    batch = _train_batch(torch, cfg.vocab_size)
    norms = {}
    for impl in ("cuda", "torch"):
        model = DecoderLM(dataclasses.replace(cfg, attn_impl=impl))
        leaves = {n: p.detach().requires_grad_(True) for n, p in flatten_named(params)}
        with torch.enable_grad():
            loss = model.loss(tree_map_named(lambda n, _: leaves[n], params), batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        norms[impl] = {n: float(g.double().norm()) for n, g in zip(leaves, grads)}
        norms[impl + "_loss"] = float(loss.detach())
        del grads, leaves, loss
        torch.cuda.empty_cache()
    top = sorted(norms["cuda"], key=lambda n: -norms["cuda"][n])[:5]
    total = {impl: float(np.sqrt(sum(v * v for v in norms[impl].values())))
             for impl in ("cuda", "torch")}
    emit({"phase": "train", "what": "step-0 gradient norms, float64, kernel and plain paths",
          "loss": {"kernel": norms["cuda_loss"], "plain": norms["torch_loss"]},
          "global_norm": {"kernel": total["cuda"], "plain": total["torch"]},
          "largest": [[n, norms["cuda"][n], norms["torch"][n]] for n in top]})
    del params
    torch.cuda.empty_cache()


def _train_profile(torch, arch="llama3.2-3b", opt=None, batch=TRAIN_BATCH, phase="train",
                   shares=None):
    """Where a training step's time goes: one step of the published `arch`
    (AdamW unless `opt` says otherwise) on `batch` x TRAIN_SEQ tokens under
    torch.profiler, after a warm-up step.  `shares`: {label: substrings of
    kernel names}, each label's share of the step's device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.training import OptConfig, TrainConfig, init_train_state, make_train_step
    from repro_torch.training.trainer import deterministic_cuda

    cfg = get_config(arch)
    model = DecoderLM(cfg)
    tcfg = TrainConfig(opt=opt or OptConfig(lr=1e-3))
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), tcfg)
    batch = _train_batch(torch, cfg.vocab_size, batch)
    step = make_train_step(model, tcfg)
    with deterministic_cuda():  # as the trainer runs its steps
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            enqueue = time.perf_counter() - t0
            float(metrics["loss"])
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 for e in events
           if getattr(e, "self_device_time_total", 0.0) > 0
           and e.device_type == torch.autograd.DeviceType.CUDA}
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    device_ms = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:12]
    line = {"phase": phase, "what": "profile of one step", "arch": arch,
            "optimizer": tcfg.opt.kind, "global_batch": batch["tokens"].shape[0],
            "wall_ms": wall * 1e3, "host_enqueue_ms": enqueue * 1e3, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1 - device_ms / (wall * 1e3)),
            "kernel_launches": launches, "top_device_ms": [[k[:60], v] for k, v in top]}
    for label, subs in (shares or {}).items():
        ms = sum(v for k, v in dev.items() if any(sub in k for sub in subs))
        line[f"{label}_device_ms"], line[f"{label}_share"] = ms, ms / device_ms
    emit(line)
    del state, step, batch
    torch.cuda.empty_cache()


def phase_train_recurrent(torch):
    """The recurrent family's training main path: repro_torch.launch.train.main
    at the published falcon-mamba-7b and recurrentgemma-9b (bf16, Adafactor
    with bf16 momentum) for TRAIN_RECURRENT_STEPS steps, no store, with each
    scan's and attention's forward and backward launches held to their
    exact counts (every flash launch on "wgmma"); then every parameter's
    step-0 gradient, finite and nonzero in every layer.  Returns each
    kernel's launches over the phase."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.launch import train

    counters = _kernel_counters()
    total = dict.fromkeys(counters, 0)
    steps = TRAIN_RECURRENT_STEPS
    for arch, layers, batch, per_step in TRAIN_RECURRENT:
        torch.cuda.reset_peak_memory_stats()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        _zero_routes()
        out = train.main(["--arch", arch, "--full", "--steps", str(steps), "--global-batch",
                          str(batch), "--seq-len", str(TRAIN_SEQ), "--optimizer", "adafactor",
                          "--momentum-dtype", "bfloat16"])
        launches = {k: getattr(m, a) for k, (m, a) in counters.items()}
        routes = {"flash_attention": dict(fa.launches_by_route),
                  "flash_attention_bwd": dict(fb.launches_by_route)}
        want = {k: per_step.get(k.removesuffix("_bwd"), 0) * steps for k in counters}
        want_routes = {k: {"wgmma": want[k], "cuda_core": 0} for k in routes}
        step_ms = float(np.median(out["step_s"][1:])) * 1e3  # the first also loads the kernels
        line = {"phase": "train_recurrent", "arch": arch, "layers": layers, "dtype": "bfloat16",
                "optimizer": "adafactor", "momentum_dtype": "bfloat16", "global_batch": batch,
                "seq_len": TRAIN_SEQ, "steps": steps, "reduced": None,
                "step_ms": [t * 1e3 for t in out["step_s"]], "median_steady_step_ms": step_ms,
                "tokens_per_s": batch * TRAIN_SEQ / (step_ms / 1e3), "losses": out["losses"],
                "grad_norms": out["grad_norms"], "all_finite": out["all_finite"],
                "seconds": out["seconds"], "max_memory_allocated": out["max_memory_allocated"],
                "launches": launches, "launches_by_route": routes}
        emit(line)
        if launches != want or routes != want_routes or not out["all_finite"]:
            raise AssertionError(f"train_recurrent {arch}: launches {launches}, want {want}; "
                                 f"routes {routes}; finite {out['all_finite']}")
        for k in counters:
            total[k] += launches[k]
        del out
        torch.cuda.empty_cache()
        _step0_gradients(torch, arch, batch)
    _remat_steps(torch, TRAIN_RECURRENT[0][0], TRAIN_RECURRENT[0][2])
    # where each model's step goes, and the share of the kernels redesigned
    # for it (falcon-mamba-7b: the Mamba scan and its reverse scan;
    # recurrentgemma-9b: the flash backward's launches, the RG-LRU scan and
    # its reverse scan)
    from repro_torch.training import OptConfig

    opt = OptConfig(kind="adafactor", lr=1e-3, momentum_dtype="bfloat16")
    arch, _, batch, _ = TRAIN_RECURRENT[0]
    _train_profile(torch, arch, opt, batch, "train_recurrent",
                   {"mamba_fwd": ("mamba_scan_kernel",),
                    "mamba_bwd": ("mamba_bwd_pass", "mamba_scan_bwd", "sum_rows")})
    arch, _, batch, _ = TRAIN_RECURRENT[1]
    _train_profile(torch, arch, opt, batch, "train_recurrent",
                   {"flash_bwd": ("bwd_prep", "bwd_dkdv", "bwd_dq", "bwd_reduce"),
                    "flash_bwd_dkdv_dq": ("bwd_dkdv", "bwd_dq"),
                    "rglru_fwd": ("rglru_scan_kernel",),
                    "rglru_bwd": ("rglru_bwd_pass", "sum_rows")})
    return total


REMAT_MODES = ("none", "dots", "full")


def _remat_steps(torch, arch, batch):
    """ModelConfig.remat on the card: two training steps of the published
    `arch` (bf16, Adafactor with bf16 momentum, seed 0, the first batch of
    `batch` x TRAIN_SEQ tokens) under each of REMAT_MODES, set with
    dataclasses.replace, in deterministic mode as the trainer runs its
    steps: peak memory, each step's ms (the first from an empty allocator
    cache), each kernel's launches in the first, its gradients bitwise
    against "none"'s (kept on the host), and both losses equal.  The
    recomputed forwards launch the forward kernels again; the backward
    kernels run once."""
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.training import OptConfig, TrainConfig, apply_opt, init_train_state
    from repro_torch.training.trainer import deterministic_cuda
    from repro_torch.tree import flatten_named, tree_map_named

    counters = _kernel_counters()
    tcfg = TrainConfig(opt=OptConfig(kind="adafactor", lr=1e-3, momentum_dtype="bfloat16"))
    cfg = get_config(arch)
    data = _train_batch(torch, cfg.vocab_size, batch)
    line = {"phase": "train_recurrent", "what": "remat", "arch": arch, "layers": cfg.n_layers,
            "global_batch": batch, "seq_len": TRAIN_SEQ, "modes": {}}
    none_grads = None
    for mode in REMAT_MODES:
        model = DecoderLM(dataclasses.replace(cfg, remat=mode))
        state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), tcfg)
        params = state["params"]
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        step_ms, losses, peak = [], [], 0
        for step in range(2):  # the first from an empty allocator cache, then a second
            torch.cuda.reset_peak_memory_stats()
            with deterministic_cuda(), torch.enable_grad():
                t0 = time.perf_counter()
                live = {n: p.detach().requires_grad_(True) for n, p in flatten_named(params)}
                loss = model.loss(tree_map_named(lambda n, _: live[n], params), data)
                grads = torch.autograd.grad(loss, list(live.values()))
                float(apply_opt(params, list(grads), state["opt"], tcfg.opt, state["step"]))
                step_ms.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated())  # before the check's copies
            losses.append(float(loss.detach()))
            if step == 0:
                launches = {k: getattr(m, a) for k, (m, a) in counters.items() if getattr(m, a)}
                if none_grads is None:
                    none_grads = [g.cpu() for g in grads]
                bitwise = all(torch.equal(g.view(torch.uint8), w.to(g.device).view(torch.uint8))
                              for g, w in zip(grads, none_grads))
            state["step"] += 1
            del live, loss, grads
        line["modes"][mode] = {"max_memory_allocated": peak,
                               "step_ms": step_ms, "losses": losses,
                               "grads_bitwise_none": bitwise, "launches": launches}
        del state, params
        torch.cuda.empty_cache()
    del none_grads
    emit(line)
    per_step = next(n for a, _, _, n in TRAIN_RECURRENT if a == arch)  # forward launches a step
    for mode, got in line["modes"].items():
        again = 2 if mode != "none" else 1  # the forward, and once more in the backward
        want = {k: n * again for k, n in per_step.items()}
        want.update({f"{k}_bwd": n for k, n in per_step.items()})
        if (not got["grads_bitwise_none"] or got["launches"] != want
                or got["losses"] != line["modes"]["none"]["losses"]):
            raise AssertionError(f"remat {arch} {mode}: {got}, launches want {want}")
    if not (line["modes"]["full"]["max_memory_allocated"]
            < line["modes"]["none"]["max_memory_allocated"]):
        raise AssertionError(f"remat {arch}: full does not save memory: {line['modes']}")


def _step0_gradients(torch, arch, batch, layers=None, phase="train_recurrent"):
    """Every parameter's gradient at step 0 of the `phase` run's weights
    (seed 0) and first batch, on the kernel path, at the published `arch`
    (cut to `layers`): finite, and nonzero in every layer of a stacked
    parameter.  A scan or an attention backward that passed no gradient
    would leave every parameter upstream of it at zero."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import DecoderLM
    from repro_torch.tree import flatten_named, tree_map_named

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, global_batch=batch,
                                        seq_len=TRAIN_SEQ)).batch_at(0)
    leaves = {n: p.detach().requires_grad_(True) for n, p in flatten_named(params)}
    with torch.enable_grad():
        loss = model.loss(tree_map_named(lambda n, _: leaves[n], params),
                          {k: torch.from_numpy(v).cuda() for k, v in data.items()})
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    bad, norms = [], {}
    for name, g in grads.items():
        per_layer = g.reshape(g.shape[0], -1) if name.startswith("blocks/") else g.reshape(1, -1)
        if not (bool(torch.isfinite(g).all()) and bool((per_layer.abs().amax(1) > 0).all())):
            bad.append(name)
        norms[name] = float(g.double().norm())
    layer0 = {n.split("/")[-1]: norms[n] for n in norms if n.startswith("blocks/0/l0/mixer/")}
    line = {"phase": phase, "what": "step-0 gradients, kernel path", "arch": arch,
            "layers": cfg.n_layers, "loss": float(loss.detach()), "parameters": len(grads),
            "finite_and_nonzero_in_every_layer": len(grads) - len(bad), "failed": bad,
            "global_norm": float(np.sqrt(sum(v * v for v in norms.values()))),
            "first_mixer_grad_norms": layer0}
    emit(line)
    del grads, leaves, params, loss
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"{phase} {arch}: step-0 gradients zero or not finite: {bad}")


def phase_train_stablelm(torch):
    """stablelm-12b's training path: the Trainer train.main builds, at the
    published widths cut to TRAIN_STABLELM's depth (train.main has no depth
    flag), bf16, Adafactor with bf16 momentum, no store, for
    TRAIN_STABLELM_STEPS steps; flash forward and backward at head_dim 160
    held to their exact counts, all on "wgmma".  The loss rises and the
    gradient norm grows over the steps: the random llama-like init's known
    exploding norm (ROADMAP caveat F3), not a fault.  Then every parameter's
    step-0 gradient, finite and nonzero in every layer.  Returns the flash
    launches of the phase."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.models import DecoderLM
    from repro_torch.training import OptConfig, TrainConfig, Trainer, TrainerConfig

    arch, published, layers, batch = TRAIN_STABLELM
    steps = TRAIN_STABLELM_STEPS
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    tcfg = TrainConfig(opt=OptConfig(kind="adafactor", lr=1e-3, momentum_dtype="bfloat16"))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=batch, seq_len=TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fb.launches = 0
    _zero_routes()
    tr = Trainer(DecoderLM(cfg), tcfg, dcfg, seed=0, device="cuda")
    tr.init()
    t0 = time.monotonic()
    out = tr.run(TrainerConfig(total_steps=steps))
    seconds = time.monotonic() - t0
    del tr
    metrics = out["metrics"]
    launches = {"flash_attention": fa.launches, "flash_attention_bwd": fb.launches}
    routes = {"flash_attention": dict(fa.launches_by_route),
              "flash_attention_bwd": dict(fb.launches_by_route)}
    step_s = [m["seconds"] for m in metrics]
    losses = [m["loss"] for m in metrics]
    step_ms = float(np.median(step_s[1:])) * 1e3  # the first step also loads the kernels
    line = {"phase": "train_stablelm", "arch": arch, "layers": layers,
            "reduced": {"n_layers": [published, layers],
                        "why": "12.14 B parameters x 6 bytes (bf16 weights, gradients, "
                               "Adafactor momentum) = 73 GB before activations"},
            "dtype": "bfloat16", "optimizer": "adafactor", "momentum_dtype": "bfloat16",
            "global_batch": batch, "seq_len": TRAIN_SEQ, "steps": steps,
            "step_ms": [t * 1e3 for t in step_s], "median_steady_step_ms": step_ms,
            "tokens_per_s": batch * TRAIN_SEQ / (step_ms / 1e3), "losses": losses,
            "grad_norms": [m["grad_norm"] for m in metrics],
            "all_finite": bool(np.all(np.isfinite(losses))), "seconds": seconds,
            "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches,
            "launches_by_route": routes}
    emit(line)
    want = {k: layers * steps for k in launches}
    want_routes = {k: {"wgmma": n, "cuda_core": 0} for k, n in want.items()}
    if launches != want or routes != want_routes or not line["all_finite"]:
        raise AssertionError(f"train_stablelm: launches {launches}, want {want}; routes "
                             f"{routes}; finite {line['all_finite']}")
    del out
    torch.cuda.empty_cache()
    _step0_gradients(torch, arch, batch, layers=layers, phase="train_stablelm")
    return launches


# train_parity's tolerances: (each gradient's max error relative to its
# largest entry, loss abs error).  float32 runs the CUDA-core kernels in full
# fp32.  bf16 runs the wgmma kernels: they round P and dS to bf16 where the
# plain path keeps fp32, and both paths round every layer's output to bf16
# (unit roundoff 2^-8 = 3.9e-3), so the paths part by a few such units,
# carried through two layers: 2e-2, the bf16 kernel tolerance of
# tests/test_kernels.py:19-20, about five units, for the gradients and for
# the loss (an fp32 mean of bf16 logits).
TRAIN_PARITY_TOL = {"float32": (2e-3, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _standard_fan_in(torch, params):
    """wq and wk scaled from the JAX rule's fan-in (shape[-2]: the head
    count, ROADMAP queue 3) to the standard one (d_model, shape[-3]).  Under
    the JAX rule the random llama's attention logits have a std of ~220: its
    softmax is one-hot, dS = P (dP - D) cancels to rounding noise, and in
    bf16 two right implementations give gradients that differ at their
    largest entries.  At the standard fan-in the logits are of order one."""
    from repro_torch.tree import flatten_named

    for name, p in flatten_named(params):
        if name.endswith(("/wq", "/wk")):
            p.mul_((p.shape[-2] / p.shape[-3]) ** 0.5)
    return params


# train_parity's models: (arch, layers, cut, each kernel's launches on one
# kernel path's loss and gradients, forward and backward alike, and the MoE
# config's cut).  kimi-k2's layer 1 keeps 8 of its 384 experts, top-2: 384
# experts' weights and gradients (one MoE layer is 34 GB of bf16 weights)
# do not fit beside the two paths' fp32 gradients.  In bf16 its top-2
# comparison is reported and the bound is held at top-8 (phase_train_parity)
TRAIN_PARITY = (
    ("llama3.2-3b", 2, "depth 28 -> 2; widths as published", {"flash_attention": 2}, None),
    ("falcon-mamba-7b", 2, "depth 64 -> 2; widths as published", {"mamba_scan": 2}, None),
    ("recurrentgemma-9b", 3, "depth 38 -> 3, one (rglru, rglru, local_attn) pattern; widths "
     "as published", {"rglru_scan": 2, "flash_attention": 1}, None),
    ("stablelm-12b", 2, "depth 40 -> 2; widths as published (head_dim 160)",
     {"flash_attention": 2}, None),
    ("kimi-k2-1t-a32b", 2, "depth 61 -> 2 (layer 0 dense, layer 1 MoE); widths as published "
     "(head_dim 112, d_expert 2048, 1 shared expert); experts 384 -> 8, top-8 -> top-2",
     {"flash_attention": 2}, {"num_experts": 8, "top_k": 2}))


def _kernel_counters():
    """{kernel: (module, attribute)} of the launch counts of every kernel a
    training step runs, forward and backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rglru_scan as rs

    return {"mamba_scan": (ms, "launches"), "mamba_scan_bwd": (ms, "bwd_launches"),
            "rglru_scan": (rs, "launches"), "rglru_scan_bwd": (rs, "bwd_launches"),
            "flash_attention": (fa, "launches"), "flash_attention_bwd": (fb, "launches")}


def phase_train_parity(torch):
    """Loss and gradients on the kernel path against the plain path, from
    the same weights and batch, at the widths of llama3.2-3b, falcon-mamba-7b
    and stablelm-12b (depth 2), recurrentgemma-9b (one pattern) and kimi-k2
    (depth 2, 8 experts): in float32 (the CUDA-core attention kernels) at
    the JAX init, and in bf16 (the wgmma ones), where the archs with
    attention take wq and wk at the standard fan-in, beside the plain path
    against itself at block_k 64 (bf16's noise floor); their bf16 kernel
    path at the JAX init is reported too, not held to a bound.  Returns each
    arch's kernel launches on its kernel paths, both dtypes summed."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.models import DecoderLM
    from repro_torch.tree import flatten_named, tree_map_named

    def loss_and_grads(cfg, params, batch, impl, **over):
        model = DecoderLM(dataclasses.replace(cfg, attn_impl=impl, **over))
        leaves = {n: p.detach().requires_grad_(True) for n, p in flatten_named(params)}
        with torch.enable_grad():
            loss = model.loss(tree_map_named(lambda n, _: leaves[n], params), batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), {n: g.float() for n, g in zip(leaves, grads)}

    def rel(a, b):  # each gradient's max error relative to its largest entry
        return {n: float((a[n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                for n, g in b.items()}

    counters = _kernel_counters()
    failed, ran = [], {}
    for arch, layers, cut, per_path, moe_cut in TRAIN_PARITY:
        attention = "flash_attention" in per_path
        for dtype, (tol, loss_tol) in TRAIN_PARITY_TOL.items():
            cfg = dataclasses.replace(get_config(arch), dtype=dtype, n_layers=layers)
            if moe_cut:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_cut))
            params = DecoderLM(cfg).init(torch.Generator(device="cuda").manual_seed(0))
            batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticPipeline(DataConfig(
                vocab_size=cfg.vocab_size, global_batch=2, seq_len=256)).batch_at(0).items()}
            route = fa._route(getattr(torch, dtype), cfg.head_dim) if attention else None
            line = {"phase": "train_parity", "arch": arch, "layers": layers, "dtype": dtype,
                    "route": route, "head_dim": cfg.hd if attention else None, "cut": cut,
                    "batch": 2, "seq_len": 256}
            if dtype == "bfloat16" and attention:
                loss_k, grads_k = loss_and_grads(cfg, params, batch, "cuda")
                loss_p, grads_p = loss_and_grads(cfg, params, batch, "torch")
                err = rel(grads_k, grads_p)
                line["jax_init_not_bounded"] = {
                    "loss_abs_err": abs(loss_k - loss_p), "max_grad_err_rel_to_scale": max(
                        err.values()), "worst_grad": max(err, key=err.get)}
                line["init"] = "wq, wk at the standard fan-in (d_model)"
                params = _standard_fan_in(torch, params)
                del grads_k, grads_p
            if dtype == "bfloat16" and moe_cut:
                # a top-k router's choice jumps where two experts' scores
                # cross: bf16's noise moves a few of 512 tokens to other
                # experts between any two right paths (the plain path
                # against itself at block_k 64 too), and their experts'
                # gradients with them.  Reported, not bounded; the bound
                # holds at top-E, where every token takes every expert
                loss_k, grads_k = loss_and_grads(cfg, params, batch, "cuda")
                loss_p, grads_p = loss_and_grads(cfg, params, batch, "torch")
                err = rel(grads_k, grads_p)
                floor = rel(loss_and_grads(cfg, params, batch, "torch", attn_block_k=64)[1],
                            grads_p)
                line["top_k_not_bounded"] = {
                    "top_k": cfg.moe.top_k, "loss_abs_err": abs(loss_k - loss_p),
                    "max_grad_err_rel_to_scale": max(err.values()),
                    "worst_grad": max(err, key=err.get),
                    "plain_vs_plain_block_k_64_max_rel": max(floor.values()),
                    "plain_vs_plain_worst_grad": max(floor, key=floor.get)}
                del grads_k, grads_p
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, top_k=cfg.moe.num_experts))
                line["moe_top_k"] = cfg.moe.top_k
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            _zero_routes()
            loss_k, grads_k = loss_and_grads(cfg, params, batch, "cuda")
            launches = {k: getattr(m, a) for k, (m, a) in counters.items()}
            ran[arch] = {k: ran.get(arch, {}).get(k, 0) + n for k, n in launches.items()}
            routes = {"flash_attention": dict(fa.launches_by_route),
                      "flash_attention_bwd": dict(fb.launches_by_route)}
            loss_p, grads_p = loss_and_grads(cfg, params, batch, "torch")
            err = rel(grads_k, grads_p)
            worst = max(err, key=err.get)
            if dtype == "bfloat16" and attention:
                floor = rel(loss_and_grads(cfg, params, batch, "torch", attn_block_k=64)[1],
                            grads_p)
                line["plain_vs_plain_block_k_64_max_rel"] = max(floor.values())
            finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
            line.update({"loss_kernel": loss_k, "loss_plain": loss_p,
                         "loss_abs_err": abs(loss_k - loss_p), "loss_tol": loss_tol,
                         "max_grad_err_rel_to_scale": err[worst], "worst_grad": worst,
                         "grad_err_rel_to_scale": err, "tol_rel_to_scale": tol,
                         "finite": finite, "launches_kernel_path": launches,
                         "launches_by_route": routes})
            emit(line)
            del params, grads_k, grads_p
            torch.cuda.empty_cache()
            want = {k: per_path.get(k.removesuffix("_bwd"), 0) for k in counters}
            want_routes = {k: {r: want[k] if r == route else 0 for r in fa.ROUTES}
                           for k in routes}
            if not (err[worst] <= tol and abs(loss_k - loss_p) <= loss_tol and finite
                    and launches == want and routes == want_routes):
                failed.append(line)
    if failed:
        raise AssertionError(f"train_parity: {failed}")
    return ran


def _delta_topk_ms(torch, state, view, k):
    """(ms, launches traced, traces taken): the device time of the delta
    commit's top-k launches, replayed after it on the same inputs (each
    floating leaf of `state` less `view`, the store's view of it, the state
    at the full commit), under torch.profiler.  A trace that lost a launch
    is taken again, up to ten times; ms is None if none was whole.  The
    commit itself runs untraced, so its compress_s is the store's own."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import topk_compress as tk
    from repro_torch.tree import flatten_named

    deltas = [t.float().reshape(-1) - view[n].float().reshape(-1)
              for n, t in flatten_named(state) if t.is_floating_point()]
    torch.cuda.synchronize()
    for tries in range(1, 11):
        before = tk.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for d in deltas:
                tk.topk_compress(d, k)
            torch.cuda.synchronize()
        topk = [(e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if "topk_kernel" in e.key]
        traced = sum(c for _, c in topk)
        if traced == tk.launches - before == len(deltas):
            return sum(t for t, _ in topk), traced, tries
    return None, traced, tries


def phase_lifecycle(torch):
    """tests/test_system.py::test_full_lifecycle on the card; returns the
    launches of topk_compress and of the checksum kernel over the phase."""
    from repro_torch.data import DataConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import log_checksum as lc
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.statestore import AsymStore, CheckpointManager, FileBlade
    from repro_torch.statestore.checkpoint import DELTA_BLOCK
    from repro_torch.training import Trainer, TrainerConfig
    from repro_torch.tree import flatten_named, tree_map_named

    model, tcfg = _lifecycle_model(torch)
    cfg = model.cfg
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=256)
    scfg = ServeConfig(batch_slots=2, max_new_tokens=8)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    line = {"phase": "lifecycle", "arch": "llama3.2-3b", "layers": 2, "dtype": "bfloat16",
            "cut": "depth 28 -> 2; widths as published", "optimizer": "adafactor",
            "momentum_dtype": "bfloat16", "global_batch": 2, "seq_len": 256,
            "full_every": 2, "delta_every": 3}
    with tempfile.TemporaryDirectory() as tmp:
        primary, mirror = os.path.join(tmp, "primary"), os.path.join(tmp, "mirror")
        ckpt = CheckpointManager(AsymStore(FileBlade(primary, mirrors=[mirror])), full_every=2,
                                 delta_every=3, keep=3)
        tk.launches = lc.launches = 0
        _zero_routes()
        tr = Trainer(model, tcfg, dcfg, ckpt=ckpt, seed=9)
        tr.init()
        tr.run(TrainerConfig(total_steps=2))
        at_v2 = {n: t.clone() for n, t in flatten_named(tr.state["params"])}
        view = {n: t.clone() for n, t in flatten_named(tr.state) if t.is_floating_point()}
        tr.run(TrainerConfig(total_steps=3))
        torch.cuda.synchronize()
        line["compress_s"] = [c["compress_s"] for c in ckpt.commits if "compress_s" in c]
        launches = {"topk_compress": tk.launches, "fletcher32_wave": lc.launches}
        line["topk_ms"], line["topk_launches_traced"], line["topk_traces"] = _delta_topk_ms(
            torch, tr.state, view, max(1, int(DELTA_BLOCK * ckpt.delta_topk_frac)))
        del view
        want = {n: t.clone() for n, t in flatten_named(tr.state)}
        line["losses"] = [m["loss"] for m in tr.metrics_log]
        line["commits"] = ckpt.commits
        line["floating_leaves"] = sum(t.is_floating_point() for t in want.values())
        del tr, ckpt  # the crash

        served = {}
        for v in (2, 3):
            eng = ServeEngine.load_from_store(
                model, CheckpointManager(AsymStore(FileBlade(primary))), scfg, version=v)
            toks, stats = eng.generate(prompts)
            served[v] = {"version": stats["version"], "logits_finite": stats["logits_finite"],
                         "tokens": toks}
            del eng
        params_v2 = tree_map_named(lambda n, _: at_v2[n], model.abstract())
        held = ServeEngine(model, params_v2, scfg).generate(prompts)[0]
        line["serve_v2_same_tokens_as_memory"] = bool(np.array_equal(served[2]["tokens"], held))
        line["serve_v3_finite"] = served[3]["logits_finite"]
        line["serve_versions"] = [served[2]["version"], served[3]["version"]]
        del at_v2, params_v2

        resumed = {}
        for name, path in (("primary", primary), ("mirror", mirror)):
            t0 = time.perf_counter()
            tr = Trainer(model, tcfg, dcfg, seed=9,
                         ckpt=CheckpointManager(AsymStore(FileBlade(path)), full_every=0))
            start = tr.resume()
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            tr.run(TrainerConfig(total_steps=3), start_step=start)
            got = dict(flatten_named(tr.state))
            resumed[name] = {"start": start, "restore_s": restore_s,
                             "bitwise": sorted(got) == sorted(want)
                             and all(torch.equal(got[n], want[n]) for n in want)}
            del tr, got
        line["resume"] = resumed
    line["launches"] = launches
    line["flash_launches_by_route"] = {"flash_attention": dict(fa.launches_by_route),
                                       "flash_attention_bwd": dict(fb.launches_by_route)}
    emit(line)
    del want
    torch.cuda.empty_cache()
    ok = (line["serve_v2_same_tokens_as_memory"] and line["serve_v3_finite"]
          and line["serve_versions"] == [2, 3]
          and all(r["bitwise"] and r["start"] == 2 for r in resumed.values())
          and [c["kind"] for c in line["commits"]] == ["full", "delta"]
          and launches == {"topk_compress": line["floating_leaves"], "fletcher32_wave": 2}
          and all(r["cuda_core"] == 0 and r["wgmma"] > 0
                  for r in line["flash_launches_by_route"].values()))
    if not ok:
        raise AssertionError(f"lifecycle: {line}")
    return launches


MESH_TRAIN_STEPS = 3
MESH_SERVE = dict(batch=4, prompt=1024, max_new=32)
MESH_MOE = dict(num_experts=8, top_k=2, capacity_factor=8.0)
MOE_TOL = dict(atol=2e-4, rtol=1e-3)                        # tests/test_torch_moe.py


def _mesh_world(torch, tmp):
    """A one-rank NCCL process group over a file:// store in `tmp`, and the
    1 x 1 ("data", "model") mesh on the card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"))


def _mesh_train(torch, mesh):
    """llama3.2-3b at full width, 3 AdamW steps of 4 x 1024 tokens through
    the mesh-less Trainer, then through a Trainer on the 1 x 1 mesh (fsdp
    rules): losses, grad norms and every updated parameter bitwise, the flash
    launches equal."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import DecoderLM
    from repro_torch.training import OptConfig, TrainConfig, Trainer, TrainerConfig
    from repro_torch.tree import flatten_named

    cfg = get_config("llama3.2-3b", fsdp=True)
    model = DecoderLM(cfg)
    tcfg = TrainConfig(opt=OptConfig(kind="adamw"))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    rules = rules_for(cfg, mesh, kind="train")
    runs = {}
    for path in ("plain", "mesh"):
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fb.launches = 0
        tr = (Trainer(model, tcfg, dcfg, seed=0, device="cuda") if path == "plain" else
              Trainer(model, tcfg, dcfg, rules=rules, mesh=mesh, seed=0))
        tr.init()
        out = tr.run(TrainerConfig(total_steps=MESH_TRAIN_STEPS))
        torch.cuda.synchronize()
        params = {n: (t.to_local() if hasattr(t, "to_local") else t).to("cpu", copy=True)
                  for n, t in flatten_named(tr.state["params"])}
        runs[path] = {"losses": [m["loss"] for m in out["metrics"]],
                      "grad_norms": [m["grad_norm"] for m in out["metrics"]],
                      "step_ms": [m["seconds"] * 1e3 for m in out["metrics"]],
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "launches": {"flash_attention": fa.launches,
                                   "flash_attention_bwd": fb.launches}, "params": params}
        del tr, out
        torch.cuda.empty_cache()
    a, b = runs["plain"], runs["mesh"]
    same_params = sorted(a["params"]) == sorted(b["params"]) and all(
        torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
    line = {"arch": "llama3.2-3b", "layers": cfg.n_layers, "dtype": "bfloat16",
            "optimizer": "adamw", "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
            "steps": MESH_TRAIN_STEPS, "rules": "rules_for(fsdp=True, kind='train')",
            "bitwise": {"losses": a["losses"] == b["losses"],
                        "grad_norms": a["grad_norms"] == b["grad_norms"],
                        "params": same_params}}
    for path, r in runs.items():
        line[path] = {k: r[k] for k in ("losses", "grad_norms", "step_ms",
                                        "max_memory_allocated", "launches")}
        line[path]["median_steady_step_ms"] = float(np.median(r["step_ms"][1:]))
    ok = all(line["bitwise"].values()) and a["launches"] == b["launches"] and \
        a["launches"]["flash_attention"] == cfg.n_layers * MESH_TRAIN_STEPS
    return line, ok, b["launches"]


def _serve_logits(torch, eng, prompts, steps):
    """The greedy loop of ServeEngine.generate on the engine's own params,
    rules and mesh, keeping every step's logits (on the card)."""
    from repro_torch.serving.engine import _whole

    model = eng.model
    with torch.inference_mode():
        toks = torch.as_tensor(prompts.astype(np.int64), device="cuda")
        logits, cache = model.prefill(eng.params, {"tokens": eng._tokens(toks)}, eng.rules,
                                      eng.mesh)
        logits = _whole(logits)
        out = [logits.clone()]
        for _ in range(steps):
            nxt = torch.argmax(logits, dim=-1)
            logits, cache = model.decode_step(eng.params, cache, eng._tokens(nxt), eng.rules,
                                              eng.mesh)
            logits = _whole(logits)
            out.append(logits.clone())
    return out


def _decode_trace(torch, eng, prompts, steps=3):
    """Three decode steps of `eng` after a prefill: wall ms a step, device ms
    a step (torch.profiler's kernel times) and the card's idle share; and the
    host functions that take the most time (cProfile over the same steps
    again, self ms a step: cProfile's own cost inflates every one)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import _whole

    model = eng.model
    with torch.inference_mode():
        toks = torch.as_tensor(prompts.astype(np.int64), device="cuda")
        logits, cache = model.prefill(eng.params, {"tokens": eng._tokens(toks)}, eng.rules,
                                      eng.mesh)

        def run():
            nonlocal logits, cache
            for _ in range(steps):
                nxt = torch.argmax(_whole(logits), dim=-1)
                logits, cache = model.decode_step(eng.params, cache, eng._tokens(nxt),
                                                  eng.rules, eng.mesh)
            torch.cuda.synchronize()

        run()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        device = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / steps
        prof_c = cProfile.Profile()
        prof_c.enable()
        run()
        prof_c.disable()
    stats = pstats.Stats(prof_c).stats
    top = sorted(((f"{f[0].rsplit('/', 2)[-2:][-1]}:{f[1]}:{f[2]}", v[2] * 1e3 / steps)
                  for f, v in stats.items()), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall, "device_ms": device,
            "device_idle_share": max(0.0, 1 - device / wall),
            "host_top_self_ms": [[k, v] for k, v in top]}


def _mesh_serve(torch, mesh):
    """llama3.2-3b at full width, batch 4, prompt 1024, 32 new tokens: the
    mesh-less ServeEngine and one on the 1 x 1 mesh (decode rules), from the
    same weights; prefill and every decode step's logits bitwise, the
    kernels' launches equal; each path's prefill ms and decode ms a step
    (ServeEngine.generate after the checked run)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import DecoderLM
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = get_config("llama3.2-3b")
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    b, s, n = MESH_SERVE["batch"], MESH_SERVE["prompt"], MESH_SERVE["max_new"]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    scfg = ServeConfig(batch_slots=b, max_new_tokens=n)
    rules = rules_for(cfg, mesh, kind="decode")
    runs = {}
    for path in ("plain", "mesh"):
        eng = (ServeEngine(model, params, scfg, device="cuda") if path == "plain" else
               ServeEngine(model, params, scfg, rules, mesh))
        fa.launches = da.launches = 0
        logits = _serve_logits(torch, eng, prompts, n - 1)
        launches = {"flash_attention": fa.launches, "decode_attention": da.launches}
        tokens, stats = eng.generate(prompts)
        runs[path] = {"logits": logits, "launches": launches, "tokens": tokens,
                      "prefill_ms": stats["prefill_s"] * 1e3,
                      "decode_ms_per_step": stats["decode_s"] * 1e3 / stats["decode_steps"],
                      "decode_trace": _decode_trace(torch, eng, prompts)}
        del eng
    del params
    torch.cuda.empty_cache()
    a, m = runs["plain"], runs["mesh"]
    bitwise = [bool(torch.equal(x, y)) for x, y in zip(a["logits"], m["logits"])]
    line = {"arch": "llama3.2-3b", "layers": cfg.n_layers, "dtype": "bfloat16", "batch": b,
            "prompt_len": s, "max_new": n, "rules": "rules_for(kind='decode')",
            "prefill_logits_bitwise": bitwise[0], "decode_logits_bitwise": bitwise[1:],
            "same_tokens": bool(np.array_equal(a["tokens"], m["tokens"]))}
    for path, r in runs.items():
        line[path] = {k: r[k] for k in ("launches", "prefill_ms", "decode_ms_per_step",
                                        "decode_trace")}
    line["mesh_minus_plain_decode_ms_per_step"] = (m["decode_ms_per_step"]
                                                   - a["decode_ms_per_step"])
    ok = all(bitwise) and line["same_tokens"] and a["launches"] == m["launches"] and \
        a["launches"]["decode_attention"] == cfg.n_layers * (n - 1)
    return line, ok, m["launches"]


def _mesh_moe(torch, mesh):
    """kimi-k2's MoE block (layer 1 of the 2-layer cut) at its published
    widths, experts cut to 8 (top-2), fp32, capacity factor 8: ep_a2a on the
    one-rank model axis against dense, within tests/test_torch_moe.py's
    bound; both times (CUDA events, medians of 5), a report."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import moe
    from repro_torch.models.params import (init_params, make_shardings, place, placements_of,
                                           shard)

    base = get_config("kimi-k2-1t-a32b", dtype="float32", n_layers=2)
    m = dataclasses.replace(base.moe, **MESH_MOE)
    cfg_a2a = dataclasses.replace(base, moe=dataclasses.replace(m, impl="ep_a2a"))
    cfg_dense = dataclasses.replace(base, moe=dataclasses.replace(m, impl="dense"))
    specs = moe.moe_specs(cfg_dense)
    p = init_params(specs, torch.Generator(device="cuda").manual_seed(1))
    x = torch.randn((4, 256, base.d_model), generator=torch.Generator(device="cuda")
                    .manual_seed(2), device="cuda")
    rules = rules_for(cfg_a2a, mesh, kind="train")
    pm = place(p, make_shardings(specs, mesh, rules), mesh)
    xm = shard(x, placements_of(x.shape, ("act_batch",), mesh, rules), mesh)
    with torch.no_grad():
        dense = lambda: moe.moe_apply(p, x, cfg_dense)  # noqa: E731
        a2a = lambda: moe.moe_apply(pm, xm, cfg_a2a, rules, mesh)  # noqa: E731
        want, got = dense(), a2a().to_local()
        times = {}
        for name, fn in (("dense", dense), ("ep_a2a", a2a)):
            ts = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end))
            times[name] = float(np.median(ts))
    err = float((got - want).abs().max())
    close = bool(torch.allclose(got, want, **MOE_TOL))
    line = {"arch": "kimi-k2-1t-a32b", "block": "MoE (layer 1 of 2)", "dtype": "float32",
            "cut": "experts 384 -> 8, top-8 -> top-2; widths as published",
            "tokens": 4 * 256, "impl": moe._impl(cfg_a2a, mesh), "max_abs_err": err,
            "tol": MOE_TOL, "close": close, "dense_ms": times["dense"],
            "ep_a2a_ms": times["ep_a2a"]}
    del p, pm, x, xm
    torch.cuda.empty_cache()
    return line, close and line["impl"] == "ep_a2a"


def _mesh_pipeline(torch):
    """pipeline_apply at one stage ("stage" mesh of 1), 4 microbatches over
    llama3.2-3b's 28 blocks (bf16, no grad), against the blocks applied to
    the whole batch: within train_parity's bf16 bound of the scale."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import DecoderLM
    from repro_torch.training.pipeline import pipeline_apply
    from repro_torch.tree import tree_map

    cfg = get_config("llama3.2-3b")
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    smesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    x = (torch.randn((4, 1024, cfg.d_model), generator=torch.Generator(device="cuda")
                     .manual_seed(3), device="cuda") * 0.02).to(cfg.torch_dtype)
    stage = tree_map(lambda t: t[None], {"blocks": params["blocks"]})

    def stage_fn(p, h):
        return model._run_blocks(p, h, "train", None, None)

    with torch.no_grad():
        want = stage_fn({"blocks": params["blocks"]}, x)
        fa.launches = 0
        got = pipeline_apply(stage_fn, stage, x, smesh, axis="stage", n_micro=4)
        launches = fa.launches
    atol, rtol = TRAIN_PARITY_TOL["bfloat16"]
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    line = {"arch": "llama3.2-3b", "layers": cfg.n_layers, "dtype": "bfloat16", "stages": 1,
            "n_micro": 4, "batch": 4, "seq_len": 1024, "max_abs_err": err, "scale": scale,
            "tol": atol * scale, "flash_launches": launches}
    del params, stage, x
    torch.cuda.empty_cache()
    return line, err <= atol * scale and launches == 4 * cfg.n_layers


def _mesh_store(torch, mesh, tmp):
    """The mesh trainer's commits: llama3.2-3b widths at depth 2 (the
    lifecycle's model), a full commit at step 2 and a delta at step 3 from
    the 1 x 1 mesh (rank 0 writes the gathered tensors), restored in a
    mesh-less Trainer: the state at step 2 bitwise."""
    from repro_torch.data import DataConfig
    from repro_torch.kernels import log_checksum as lc
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.launch.mesh import rules_for
    from repro_torch.statestore import AsymStore, CheckpointManager, FileBlade
    from repro_torch.training import Trainer, TrainerConfig
    from repro_torch.tree import flatten_named

    model, tcfg = _lifecycle_model(torch)
    cfg = model.cfg
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=256)
    blade = os.path.join(tmp, "blade")
    rules = rules_for(cfg, mesh, kind="train")
    tk.launches = lc.launches = 0
    ckpt = CheckpointManager(AsymStore(FileBlade(blade)), full_every=2, delta_every=3)
    tr = Trainer(model, tcfg, dcfg, ckpt=ckpt, rules=rules, mesh=mesh, seed=9)
    tr.init()
    tr.run(TrainerConfig(total_steps=2))
    at2 = {n: t.to_local().clone() for n, t in flatten_named(tr.state)}
    tr.run(TrainerConfig(total_steps=3))
    launches = {"topk_compress": tk.launches, "fletcher32_wave": lc.launches}
    kinds = [c["kind"] for c in ckpt.commits]
    del tr, ckpt
    back = Trainer(model, tcfg, dcfg, seed=9,
                   ckpt=CheckpointManager(AsymStore(FileBlade(blade)), full_every=0))
    start = back.resume()
    got = dict(flatten_named(back.state))
    bitwise = sorted(got) == sorted(at2) and all(torch.equal(got[n], at2[n]) for n in at2)
    del back, got, at2
    torch.cuda.empty_cache()
    line = {"arch": "llama3.2-3b", "layers": 2, "commits": kinds, "resume_step": start,
            "restored_bitwise": bitwise, "launches": launches}
    return line, bitwise and start == 2 and kinds == ["full", "delta"] and all(
        v > 0 for v in launches.values())


def _mesh_kernel_checks(torch):
    """The kernels as the mesh path calls them beyond a 1 x 1 mesh: decode
    with its log-sum-exp (a length-sharded cache merges by it) against the
    plain version's, and the flash forward on two halves of the query rows
    at their q_offset (sequence-parallel) against one call over all rows."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((4, 24, 128), generator=g, device="cuda").to(dtype)
        k = torch.randn((4, 8, 2048, 128), generator=g, device="cuda").to(dtype)
        v = torch.randn((4, 8, 2048, 128), generator=g, device="cuda").to(dtype)
        length = torch.tensor([2048, 1500, 1, 0], dtype=torch.int32, device="cuda")
        o, lse = ops.decode_attention(q, k, v, length=length, return_lse=True)
        _, want = ref.decode_attention_reference(q, k, v, length=length, return_lse=True)
        live = length > 0
        err = float((lse[live] - want[live]).abs().max())
        out[f"decode_lse_{str(dtype)[6:]}"] = {"max_abs_err": err,
                                               "empty_row_neg_inf": bool(torch.isinf(
                                                   lse[~live]).all())}
        qf = torch.randn((2, 24, 1024, 128), generator=g, device="cuda").to(dtype)
        kf = torch.randn((2, 8, 1024, 128), generator=g, device="cuda").to(dtype)
        vf = torch.randn((2, 8, 1024, 128), generator=g, device="cuda").to(dtype)
        whole = ops.flash_attention(qf, kf, vf, causal=True)
        halves = torch.cat([ops.flash_attention(qf[:, :, i:i + 512].contiguous(), kf, vf,
                                                causal=True, q_offset=i) for i in (0, 512)], 2)
        out[f"flash_q_offset_{str(dtype)[6:]}"] = {
            "max_abs_err": float((halves.float() - whole.float()).abs().max())}
    tol = {"bfloat16": TOL["bfloat16"], "float32": TOL["float32"]}
    ok = all(v["max_abs_err"] <= 1e-3 and v["empty_row_neg_inf"]
             for k, v in out.items() if k.startswith("decode")) and all(
        v["max_abs_err"] <= tol[k.rsplit("_", 1)[1]] for k, v in out.items()
        if k.startswith("flash"))
    return out, ok


def phase_mesh(torch):
    """The distribution layer on the card: a one-rank NCCL process group and
    a 1 x 1 mesh, held against the mesh-less path in the same process.
    Returns each kernel's launches on the phase's mesh paths."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = _mesh_world(torch, tmp)
        try:
            checks, ok_checks = _mesh_kernel_checks(torch)
            train, ok_train, train_launches = _mesh_train(torch, mesh)
            serve, ok_serve, serve_launches = _mesh_serve(torch, mesh)
            moe_line, ok_moe = _mesh_moe(torch, mesh)
            pipe, ok_pipe = _mesh_pipeline(torch)
            store, ok_store = _mesh_store(torch, mesh, tmp)
        finally:
            dist.destroy_process_group()
    line = {"phase": "mesh", "mesh": {"shape": [1, 1], "axes": ["data", "model"],
                                      "backend": "nccl"},
            "kernel_checks": checks, "train": train, "serve": serve, "moe": moe_line,
            "pipeline": pipe, "store": store, "seconds": time.perf_counter() - t0}
    emit(line)
    oks = {"kernel_checks": ok_checks, "train": ok_train, "serve": ok_serve, "moe": ok_moe,
           "pipeline": ok_pipe, "store": ok_store}
    if not all(oks.values()):
        raise AssertionError(f"mesh: {oks}")
    return {"flash_attention": train_launches["flash_attention"]
            + serve_launches["flash_attention"],
            "flash_attention_bwd": train_launches["flash_attention_bwd"],
            "decode_attention": serve_launches["decode_attention"],
            **store["launches"]}


# ----------------------------------------------------------- the simulator
# Table 3 (benchmarks/table3_throughput.py): the eight structures under the six
# front-end variants, less the cells the paper leaves empty
NVM_STRUCTURES = ("queue", "stack", "hashtable", "skiplist", "bst", "bptree", "mv_bst", "mv_bpt")
NVM_VARIANTS = ("sym", "symb", "naive", "r", "rc", "rcb")
NVM_SKIP = {("hashtable", "symb"), ("hashtable", "rcb"), ("queue", "rc"), ("stack", "rc")}
NVM_CLASSES = {"stack": "RemoteStack", "queue": "RemoteQueue", "hashtable": "RemoteHashTable",
               "skiplist": "RemoteSkipList", "bst": "RemoteBST", "bptree": "RemoteBPTree",
               "mv_bst": "RemoteMVBST", "mv_bpt": "RemoteMVBPTree"}
NVM_TABLE3 = (30000, 3000)   # Table 3's preload and ops a cell
NVM_CUT = (2000, 200)        # the 44 cells here: a fifteenth of each
NVM_FULL = (("bptree", "rcb"), ("hashtable", "r"))  # also at Table 3's full size
NVM_BLADE = 1 << 26          # NVMBackend's default 64 MB arena, as Table 3's blades
NVM_DESIGN = {
    "fletcher64_segments": "a warp a segment (a block a segment above 16 KB); words assembled "
                           "from the two aligned words around them by a funnel shift, bytes "
                           "past the segment masked; each lane's sums folded mod 2^32-1, then "
                           "the warp's (and the block's) reduced sums added",
    "apply_runs": "the host merges the runs' intervals; a run alone in its interval copies "
                  "its bytes as they are, the bytes of shared intervals are numbered "
                  "compactly: pass 1 an atomicMax of the run index into an int32 owner a "
                  "byte, pass 2 copies each byte from its owner to the arena and every "
                  "mirror; a warp a run"}


def _nvm_fe(core, variant, cache_bytes):
    """benchmarks/common.py's VARIANTS."""
    F = core.FEConfig
    return {"sym": lambda: F(symmetric=True),
            "symb": lambda: F(symmetric=True, sym_batch=True, batch_ops=1024),
            "naive": F.naive, "r": F.r, "rc": lambda: F.rc(cache_bytes=cache_bytes),
            "rcb": lambda: F.rcb(batch_ops=1024, cache_bytes=cache_bytes)}[variant]()


def _nvm_cell(device, structure, variant, preload, n_ops):
    """One Table 3 cell as benchmarks/common.py's build_structure and
    run_write_workload drive it, on a blade on `device`: (blade, front end,
    structure, virtual ns of the ops)."""
    import random

    from repro_torch import core
    from repro_torch.core import structures

    node = {"bst": 32, "bptree": 256, "skiplist": 136, "mv_bst": 32, "mv_bpt": 256,
            "hashtable": 32}.get(structure, 64)
    be = core.NVMBackend(capacity=NVM_BLADE, device=device)
    fe = core.FrontEnd(be, _nvm_fe(core, variant, max(4096, int(preload * node * 0.10))))
    cls = getattr(structures, NVM_CLASSES[structure])
    keys = random.Random(0).sample(range(preload * 8), preload)
    if structure in ("stack", "queue"):
        obj = cls(fe, structure)
        push = obj.push if structure == "stack" else obj.enqueue
        for i in range(preload):
            push(i)
    elif structure == "hashtable":
        obj = cls(fe, structure, n_buckets=max(1024, preload // 4))
        for k in keys:
            obj.put(k, k)
    elif structure == "skiplist":
        obj = cls(fe, structure)
        for k in sorted(keys):
            obj.insert(k, k)
    elif structure in ("bst", "bptree"):
        obj = cls(fe, structure)
        for k in keys:
            obj.insert(k, k)
    else:
        obj = cls(fe, structure)
        obj.build_from_sorted(sorted((k, k) for k in keys))
    fe.drain(obj.h)
    rng = random.Random(1)
    t0 = fe.clock.now
    if structure in ("stack", "queue"):
        push = obj.push if structure == "stack" else obj.enqueue
        for i in range(n_ops):
            push(i)
    else:
        write = obj.insert if hasattr(obj, "insert") else obj.put
        for _ in range(n_ops):
            k = rng.randrange(1 << 30)
            rng.random()  # the write share's draw: every op writes
            write(k, k)
    fe.drain(obj.h)
    return be, fe, obj, fe.clock.now - t0


def _nvm_state(be, fe=None) -> dict:
    """What must agree between the card's run and the CPU's: sha256 of the
    arena and each mirror's, the clocks and the Stats."""
    import hashlib

    out = {"digests": [hashlib.sha256(a.cpu().numpy()).hexdigest()
                       for a in (be.arena, *(m.arena for m in be.mirrors))],
           "blade_clock": be.clock.now, "blade_stats": dataclasses.asdict(be.stats),
           "alive": be.alive}
    if fe is not None:
        out.update(fe_clock=fe.clock.now, fe_stats=dataclasses.asdict(fe.stats),
                   cache=[fe.cache.hits, fe.cache.misses])
    return out


def _nvm_pair(torch, scenario):
    """Runs `scenario(device)` on the card, then on the CPU; each returns
    ([(step, state)], extra).  Returns (card steps, cpu steps, card extra,
    card s, cpu s, the first step that differs or None)."""
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        steps, extra = scenario(dev)
        torch.cuda.synchronize()
        runs[dev] = (steps, extra, time.perf_counter() - t0)
    card, cpu = runs["cuda"], runs["cpu"]
    differ = next((name for (name, a), (_, b) in zip(card[0], cpu[0]) if a != b), None)
    if len(card[0]) != len(cpu[0]):
        differ = "step count"
    return card[0], cpu[0], card[1], card[2], cpu[2], differ


def _nvm_quickstart(dev):
    """examples/quickstart.py part 1 on a 16 MB blade with one mirror."""
    from repro_torch.core import FEConfig, FrontEnd, NVMBackend
    from repro_torch.core.structures import RemoteBPTree

    blade = NVMBackend(capacity=1 << 24, num_mirrors=1, device=dev)
    fe = FrontEnd(blade, FEConfig.rcb(batch_ops=256))
    tree = RemoteBPTree(fe, "accounts")
    for k in range(1000):
        tree.insert(k, k * k)
    fe.drain(tree.h)
    steps = [("inserts", _nvm_state(blade, fe))]
    blade.crash()
    blade.reboot()
    steps.append(("reboot", _nvm_state(blade)))
    fe2 = FrontEnd(blade, FEConfig.rcb(), fe_id=1)
    tree2 = RemoteBPTree.recover(fe2, "accounts")
    found = tree2.find(77)
    steps.append(("recover", _nvm_state(blade, fe2)))
    return steps, {"find_77": found, "virtual_ms": fe.clock.now / 1e6}


def _nvm_recovery_cases():
    """{name: scenario(device)}: tears, a long log without the memo, mirror
    promotion and a lagging mirror (tests/test_torch_nvm_recovery.py's
    scenarios on 64 MB blades)."""
    import random

    import torch

    from repro_torch.core import CrashError, FEConfig, FrontEnd, NVMBackend, oplog
    from repro_torch.core.structures import RemoteBPTree, RemoteHashTable, RemoteQueue, RemoteStack

    def watermark(keep):
        def run(dev):
            be = NVMBackend(capacity=NVM_BLADE, device=dev)
            fe = FrontEnd(be, FEConfig.rc(cache_bytes=4096, oplog_pipeline=1))
            ht = RemoteHashTable(fe, "h", n_buckets=64)
            for k in range(10):
                ht.put(k, k)
            fe.drain(ht.h)
            be.schedule_torn_write(keep, at_name="h.seq")
            try:
                ht.put(99, 99)
            except CrashError:
                pass
            steps = [("tear", _nvm_state(be, fe))]
            be.reboot()
            fe2 = FrontEnd(be, FEConfig.rc(cache_bytes=4096, oplog_pipeline=1))
            ht2 = RemoteHashTable.recover(fe2, "h")
            got = [ht2.get(k) for k in (*range(10), 99)]
            steps.append(("recover", _nvm_state(be, fe2)))
            return steps, {"ok": got == [*range(10), 99 if keep >= 8 else None]}
        return run

    def flush_tear(dev):
        be = NVMBackend(capacity=NVM_BLADE, device=dev)
        fe = FrontEnd(be, FEConfig.rcb(batch_ops=64, oplog_group=16))
        s = RemoteStack(fe, "s")
        for i in range(200):
            s.push(i)
        fe.drain(s.h)
        for i in range(200, 230):
            s.push(i)
        be.schedule_torn_write(20)
        torn = False
        try:
            fe.drain(s.h)
            fe.drain(s.h)
        except CrashError:
            torn = True
        torn = torn and not be.alive  # the tear fired inside the drains
        steps = [("tear", _nvm_state(be, fe))]
        be.reboot()
        fe3 = FrontEnd(be, FEConfig.rcb(batch_ops=64, oplog_group=16), fe_id=2)
        s3 = RemoteStack.recover(fe3, "s")
        vals = []
        while (v := s3.pop()) is not None:
            vals.append(v)
        steps.append(("recover", _nvm_state(be, fe3)))
        return steps, {"ok": torn and len(vals) >= 200 and vals == sorted(vals, reverse=True)}

    def long_log(dev):
        be = NVMBackend(capacity=NVM_BLADE, num_mirrors=1, device=dev)
        area = be.create_log_area("x.txlog", 2048)
        data = be.alloc_blocks(256)
        rng = random.Random(7)
        for _ in range(400):
            entries = [oplog.MemLog(data + 8 * rng.randrange(8000), rng.randbytes(
                rng.choice([8, 24, 64, 256]))) for _ in range(rng.randrange(1, 9))]
            be.tx_append(area, oplog.encode_tx(entries))
        oplog._CSUM_CACHE.clear()  # every body is verified by the blade
        be.crash()
        steps = [("appended", _nvm_state(be))]
        be.reboot()
        steps.append(("reboot", _nvm_state(be)))
        return steps, {"ok": be.stats.tx_commits == 400}

    def promotion(dev):
        be = NVMBackend(capacity=NVM_BLADE, num_mirrors=2, device=dev)
        fe = FrontEnd(be, FEConfig.rcb(batch_ops=32, oplog_group=8))
        q = RemoteQueue(fe, "q")
        for i in range(150):
            q.enqueue(i)
        fe.drain(q.h)
        be.fail_permanently()
        promoted = be.promote_mirror(1)
        steps = [("promote", _nvm_state(promoted))]
        fe2 = FrontEnd(promoted, FEConfig.rcb(), fe_id=3)
        q2 = RemoteQueue.recover(fe2, "q")
        got = [q2.dequeue() for _ in range(150)]
        steps.append(("recover", _nvm_state(promoted, fe2)))
        return steps, {"ok": got == list(range(150))}

    def lagging(dev):
        be = NVMBackend(capacity=NVM_BLADE, num_mirrors=1, device=dev)
        be.mirrors[0].set_lag(4)
        fe = FrontEnd(be, FEConfig.rcb(batch_ops=32, oplog_group=8))
        t = RemoteBPTree(fe, "t")
        for k in random.Random(3).sample(range(10 ** 6), 300):
            t.insert(k, k)
        fe.drain(t.h)
        pending = be.mirrors[0]._n_pending
        steps = [("lagging", _nvm_state(be, fe))]
        # a stack pushed and popped empty: the blocks it hands back clear
        # their bitmap bits while the mirror lags
        s = RemoteStack(fe, "s")
        for i in range(600):
            s.push(i)
        popped = [s.pop() for _ in range(600)]
        fe.drain(s.h)
        released = fe.allocator.release_empty()
        steps.append(("frees", _nvm_state(be, fe)))
        be.mirrors[0].sync()
        steps.append(("synced", _nvm_state(be, fe)))
        synced = torch.equal(be.mirrors[0].arena, be.arena)
        return steps, {"ok": pending > 0 and released > 0 and synced
                       and popped == list(range(599, -1, -1))}

    return {"tear {s}.seq keep 0": watermark(0), "tear {s}.seq keep 8": watermark(8),
            "tear mid-flush": flush_tear, "400-tx log, memo cleared": long_log,
            "fail_permanently + promote_mirror": promotion, "lagging mirror (set_lag(4))": lagging}


def _nvm_table3_cell(torch, structure, variant, preload, n_ops):
    """One cell on the card and on the CPU: its line, and whether they agree."""
    from repro_torch.obs import profile as obs_profile

    line = {"structure": structure, "variant": variant, "preload": preload, "ops": n_ops}
    states = {}
    for dev in ("cuda", "cpu"):
        obs_profile.reset()
        obs_profile.enable()
        try:
            t0 = time.perf_counter()
            be, fe, obj, ns = _nvm_cell(dev, structure, variant, preload, n_ops)
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            obs_profile.disable()
        states[dev] = _nvm_state(be, fe)
        copies = (be.d2h + sum(m.d2h for m in be.mirrors), be.h2d + sum(m.h2d for m in be.mirrors))
        key = "card" if dev == "cuda" else "cpu"
        line[f"{key}_s"] = wall
        line[f"{key}_ms_per_op"] = wall * 1e3 / (preload + n_ops)
        if dev == "cuda":
            line.update(kops=n_ops / ns * 1e6, d2h=copies[0], h2d=copies[1],
                        host_s={k: v["seconds"] for k, v in obs_profile.snapshot().items()})
        del be, fe, obj
    line["equal"] = states["cuda"] == states["cpu"]
    emit({"phase": "nvm", "step": "table3", **line})
    return line


def _nvm_kernel_cases(torch):
    """K1 and K2 on the card against their plain versions, bitwise, and a
    second run against the first; their times beside their bounds."""
    from repro_torch.kernels import nvm_log, ref

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(64)
    rng = np.random.default_rng(64)
    lines = {}
    # K1: a 64 MB span, 1e5 segments of 0-4096 bytes at odd offsets; the
    # first megabyte all 0xFF, 1000 segments inside it
    arena = torch.randint(0, 256, (NVM_BLADE,), dtype=torch.uint8, device="cuda", generator=gen)
    arena[: 1 << 20] = 0xFF
    n = 100_000
    lens = rng.integers(0, 4097, n)
    starts = 2 * rng.integers(0, (NVM_BLADE - 4200) // 2, n) + 1
    starts[:1000] = 2 * rng.integers(0, ((1 << 20) - 4200) // 2, 1000) + 1
    run = lambda: nvm_log.fletcher64_segments(arena, starts, lens)  # noqa: E731
    s_d, l_d = (torch.from_numpy(x).cuda() for x in (starts, lens))
    plain = lambda: ref.fletcher64_segments_reference(arena, s_d, l_d)  # noqa: E731
    got, again, want = run(), run(), plain()
    launch = nvm_log._fletcher64_launcher(arena, starts, lens, torch.empty_like(got))
    nbytes = int(lens.sum()) + 24 * n  # the bodies, the table in, the sums out
    bound_ms, bound_by = bound(nbytes, 4.0 * nbytes / 4, "float32")
    lines["fletcher64_segments"] = {
        "case": "64 MB span, 1e5 segments of 0-4096 bytes at odd offsets, 1000 all 0xFF",
        "segments": n, "bytes": int(lens.sum()), "equal_plain": torch.equal(got, want),
        "bitwise_repeat": torch.equal(got, again), "kernel_ms": timer(run),
        "launch_ms": timer(launch), "plain_ms": timer(plain, iters=3), "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by}
    del arena, s_d, l_d, got, again, want, launch
    # K2: a 64 MB arena with one mirror; 1e5 runs into its first 48 MB from a
    # 16 MB span of its last, a third of them over earlier runs' bytes
    n = 100_000
    span = 16 << 20
    lo = NVM_BLADE - span
    lens = rng.integers(1, 513, n)
    addrs = rng.integers(0, lo - 1024, n)
    third = n // 3
    pick = rng.integers(0, n - third, third)
    addrs[n - third:] = addrs[pick] + rng.integers(-64, 65, third).clip(0)  # overlaps
    offs = rng.integers(0, span - 1024, n)
    base = torch.randint(0, 256, (NVM_BLADE,), dtype=torch.uint8, device="cuda", generator=gen)
    dsts = [base.clone(), base.clone()]
    plain_dsts = [base.clone(), base.clone()]
    run = lambda: nvm_log.apply_runs(dsts, dsts[0][lo:], addrs, offs, lens)  # noqa: E731
    a_d, o_d, n_d = (torch.from_numpy(x).cuda() for x in (addrs, offs, lens))
    plain = lambda: ref.apply_runs_reference(plain_dsts, plain_dsts[0][lo:], a_d, o_d, n_d)  # noqa: E731
    run()
    launch = nvm_log._apply_launcher(dsts, dsts[0][lo:], addrs, offs, lens)
    first = [d.clone() for d in dsts]
    run()
    plain()
    equal = all(torch.equal(d, p) for d, p in zip(dsts, plain_dsts))
    repeat = all(torch.equal(d, f) for d, f in zip(dsts, first))
    order = np.argsort(addrs, kind="stable")
    a, e = addrs[order], addrs[order] + lens[order]
    reach = np.maximum.accumulate(e)
    heads = np.flatnonzero(np.r_[True, a[1:] >= reach[:-1]])
    written = int((np.maximum.reduceat(e, heads) - a[heads]).sum())  # distinct bytes
    nbytes = written * (1 + len(dsts)) + 32 * n  # read once, written to arena and mirror
    bound_ms, bound_by = bound(nbytes, 0.0, "float32")
    lines["apply_runs"] = {
        "case": "64 MB arena and one mirror, 1e5 runs of 1-512 bytes, a third over earlier "
                "runs", "runs": n, "distinct_bytes": written, "equal_plain": equal,
        "bitwise_repeat": repeat, "kernel_ms": timer(run), "launch_ms": timer(launch),
        "plain_ms": timer(plain, iters=3), "library_ms": None, "bound_ms": bound_ms,
        "bound_by": bound_by}
    del dsts, plain_dsts, first, base, timer, launch
    torch.cuda.empty_cache()
    return lines


def phase_nvm(torch):
    """The single-blade AsymNVM machine on the card, each step against the
    same step on a CPU blade: the quickstart, Table 3's 44 cells (cut) and
    two at full size, recovery; then K1 and K2 against their plain versions.
    Returns each kernel's line with its launches over the main path."""
    from repro_torch.kernels import nvm_log

    t0 = time.perf_counter()
    nvm_log.fletcher64_launches = nvm_log.apply_launches = 0
    failed = []
    steps, cpu_steps, extra, card_s, cpu_s, differ = _nvm_pair(torch, _nvm_quickstart)
    emit({"phase": "nvm", "step": "quickstart", "blade_mb": 16, "find_77": extra["find_77"],
          "virtual_ms": extra["virtual_ms"], "card_s": card_s, "cpu_s": cpu_s,
          "equal": differ is None, "steps": [s for s, _ in steps]})
    if differ is not None or extra["find_77"] != 77 * 77:
        failed.append(f"quickstart: {differ} find(77) {extra['find_77']}")
    cells = []
    for structure in NVM_STRUCTURES:
        for variant in NVM_VARIANTS:
            if (structure, variant) not in NVM_SKIP:
                cells.append(_nvm_table3_cell(torch, structure, variant, *NVM_CUT))
    for structure, variant in NVM_FULL:
        cells.append(_nvm_table3_cell(torch, structure, variant, *NVM_TABLE3))
    failed += [f"table3 {c['structure']} x {c['variant']} ({c['preload']})" for c in cells
               if not c["equal"]]
    for name, scenario in _nvm_recovery_cases().items():
        steps, _, extra, card_s, cpu_s, differ = _nvm_pair(torch, scenario)
        emit({"phase": "nvm", "step": "recovery", "case": name, "card_s": card_s,
              "cpu_s": cpu_s, "equal": differ is None, "ok": extra["ok"],
              "steps": [s for s, _ in steps]})
        if differ is not None or not extra["ok"]:
            failed.append(f"recovery {name}: {differ} ok {extra['ok']}")
    launches = {"fletcher64_segments": nvm_log.fletcher64_launches,
                "apply_runs": nvm_log.apply_launches}
    main_s = time.perf_counter() - t0
    by_variant = {}
    for v in NVM_VARIANTS:
        cut = [c for c in cells if c["variant"] == v and c["preload"] == NVM_CUT[0]]
        ops = sum(c["preload"] + c["ops"] for c in cut)
        by_variant[v] = {"cells": len(cut), "card_ms_per_op": sum(c["card_s"] for c in cut)
                         * 1e3 / ops, "cpu_ms_per_op": sum(c["cpu_s"] for c in cut) * 1e3 / ops}
    trace = _nvm_trace(torch)
    emit({"phase": "nvm", "step": "trace", **trace})
    for variant in NVM_VARIANTS:  # every variant runs on the B+Tree
        emit({"phase": "nvm", "step": "verbs", "structure": "bptree", "variant": variant,
              "preload": NVM_CUT[0], "ops": NVM_CUT[1], "verbs": _nvm_verbs(torch, "bptree",
                                                                            variant)})
    kernels = _nvm_kernel_cases(torch)
    for name, k in kernels.items():
        k["launches"] = launches[name]
        if not (k["equal_plain"] and k["bitwise_repeat"]):
            failed.append(f"kernel {name}: plain {k['equal_plain']} "
                          f"repeat {k['bitwise_repeat']}")
    emit({"phase": "nvm", "main_path_s": main_s, "seconds": time.perf_counter() - t0,
          "cut": {"preload": [NVM_TABLE3[0], NVM_CUT[0]], "ops": [NVM_TABLE3[1], NVM_CUT[1]]},
          "launches": launches, "ms_per_op_by_variant": by_variant, "kernels": kernels,
          "ok": not failed, "failed": failed})
    if failed:
        raise AssertionError(f"nvm: {failed}")
    return kernels


NVM_VERBS = ("read", "write", "atomic_read", "atomic_add", "atomic_cas", "get_name",
             "set_name", "name_slot_addr", "has_name", "alloc_blocks", "free_blocks",
             "tx_append", "tx_apply", "gather", "reboot")


def _nvm_verbs(torch, structure, variant):
    """One cut cell on the card with the blade's verbs counted: for each verb
    its calls an op, the copies to and from the host a call (its mirrors'
    included; a verb's nested verbs count in it) and its host ms a call."""
    from repro_torch.core import backend

    cls = backend.NVMBackend
    own = {v: v in cls.__dict__ for v in NVM_VERBS}
    saved = {v: getattr(cls, v) for v in NVM_VERBS}
    acc, depth = {}, [0]

    def copies(be):
        return (be.d2h + sum(m.d2h for m in be.mirrors),
                be.h2d + sum(m.h2d for m in be.mirrors))

    def wrap(name, fn):
        def counted(self, *args, **kwargs):
            if depth[0]:
                return fn(self, *args, **kwargs)
            depth[0] += 1
            (d0, h0), t0 = copies(self), time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                depth[0] -= 1
                d1, h1 = copies(self)
                a = acc.setdefault(name, [0, 0, 0, 0.0])
                a[0] += 1
                a[1] += d1 - d0
                a[2] += h1 - h0
                a[3] += time.perf_counter() - t0
        return counted

    for v, fn in saved.items():
        setattr(cls, v, wrap(v, fn))
    try:
        _nvm_cell("cuda", structure, variant, *NVM_CUT)
    finally:
        for v, fn in saved.items():
            if own[v]:
                setattr(cls, v, fn)
            else:
                delattr(cls, v)
    ops = sum(NVM_CUT)
    return {v: {"per_op": n / ops, "d2h_per_call": d / n, "h2d_per_call": h / n,
                "host_ms_per_call": t * 1e3 / n} for v, (n, d, h, t) in sorted(acc.items())}


def _nvm_trace(torch):
    """torch.profiler over one cut hashtable x r cell on the card (every op
    flushes, so every op replays its log on the blade): device ms by
    kernel and copy, wall, and the card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        be, fe, obj, ns = _nvm_cell("cuda", "hashtable", "r", *NVM_CUT)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name = {e.key: [e.self_device_time_total / 1e3, e.count] for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0.0) > 0}
    device = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"cell": "hashtable x r", "preload": NVM_CUT[0], "ops": NVM_CUT[1],
            "wall_ms": wall * 1e3, "device_ms": device,
            "idle_share": 1.0 - device / (wall * 1e3) if wall > 0 else None,
            "tx_applies": be.stats.tx_commits,
            "top": [[k, t, c] for k, (t, c) in top]}


def _fail(reason: str) -> int:
    """An early exit: its reason on stderr and as one line on stdout, no result."""
    print(f"chip_smoke: {reason}", file=sys.stderr, flush=True)
    emit({"phase": "exit", "ok": False, "reason": reason})
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated phases of {PHASES}; all by default")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(PHASES):
        ap.error(f"--only takes phases of {PHASES}")

    t_start = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail("src/repro_torch not found beside this script")
    # cuBLAS reads this when it starts; the trainer's deterministic steps
    # need it (repro_torch/training/trainer.py)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": "device", **device, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    build_s = _build.build()
    regs = {}
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            regs[name] = [ln.strip() for ln in log.read_text().splitlines()
                          if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "ptxas": regs})

    cases = phase_kernels(torch) if "kernel" in only else None
    if "parity" in only:
        phase_parity(torch)
    served = phase_serve(torch) if "serve" in only else None
    if "profile" in only:
        phase_profile(torch, "llama3.2-3b", 1024)
        phase_profile(torch, "recurrentgemma-9b", 3072)
        phase_profile(torch, "falcon-mamba-7b", 1024)
        phase_profile(torch, "stablelm-12b", 1024)
        phase_profile(torch, "kimi-k2-1t-a32b", 256, layers=2)
    if "store" in only:
        phase_store(torch)
    train = phase_train(torch) if "train" in only else None
    recurrent = phase_train_recurrent(torch) if "train_recurrent" in only else None
    stablelm = phase_train_stablelm(torch) if "train_stablelm" in only else None
    parity = phase_train_parity(torch) if "train_parity" in only else None
    lifecycle = phase_lifecycle(torch) if "lifecycle" in only else None
    mesh = phase_mesh(torch) if "mesh" in only else None
    nvm = phase_nvm(torch) if "nvm" in only else None
    emit({"phase": "time", "seconds": time.perf_counter() - t_start})
    if None in (cases, served, train, recurrent, stablelm, parity, lifecycle, mesh, nvm):
        return 0  # a partial run checks what it ran and claims nothing more

    # each kernel's launches over the phase of the main path that runs it:
    # serving (the attention forward, decode, the scans; by head dim, each
    # model's), training (the attention backward at llama's head_dim 128),
    # the recurrent family's training (the scans' backward, the attention
    # backward at head_dim 256), stablelm-12b's training (the attention
    # backward at head_dim 160) and the lifecycle's commits (top-k,
    # checksums).  kimi-k2 trains on no main path (one of its MoE layers is
    # 34 GB of bf16 weights): the backward at head_dim 112 runs in
    # train_parity, and its entry says so.  One CUDA kernel replaces both
    # Pallas checksums: the main path calls it as a wave, and its
    # one-segment call (fletcher32) rides in that entry
    launches, by_arch = served
    ran = dict(launches, flash_attention_bwd=train["flash_attention_bwd"],
               flash_attention_bwd_d256=recurrent["flash_attention_bwd"],
               flash_attention_bwd_d160=stablelm["flash_attention_bwd"],
               flash_attention_bwd_d112=parity["kimi-k2-1t-a32b"]["flash_attention_bwd"],
               flash_attention_d160=by_arch["stablelm-12b"]["flash_attention"],
               flash_attention_d112=by_arch["kimi-k2-1t-a32b"]["flash_attention"],
               decode_attention_d160=by_arch["stablelm-12b"]["decode_attention"],
               decode_attention_d112=by_arch["kimi-k2-1t-a32b"]["decode_attention"],
               mamba_scan_bwd=recurrent["mamba_scan_bwd"],
               rglru_scan_bwd=recurrent["rglru_scan_bwd"],
               topk_compress=lifecycle["topk_compress"],
               fletcher32_wave=lifecycle["fletcher32_wave"])
    from_phase = dict.fromkeys(("flash_attention", "decode_attention", "rglru_scan",
                                "mamba_scan", "flash_attention_d160", "flash_attention_d112",
                                "decode_attention_d160", "decode_attention_d112"), "serve")
    from_phase.update(flash_attention_bwd="train", flash_attention_bwd_d256="train_recurrent",
                      mamba_scan_bwd="train_recurrent", rglru_scan_bwd="train_recurrent",
                      flash_attention_bwd_d160="train_stablelm",
                      flash_attention_bwd_d112="train_parity", topk_compress="lifecycle",
                      fletcher32_wave="lifecycle")
    bwd_grad = ("src/repro/kernels/flash_attention.py:91 (its gradient{}; JAX differentiates "
                "src/repro/kernels/ref.py:flash_attention_reference)")
    kernels = []
    for key, name, source, replaces in (
            ("flash", "flash_attention", "flash_attention_sm90",
             "src/repro/kernels/flash_attention.py:91"),
            ("flash_bwd", "flash_attention_bwd", "flash_attention_bwd_sm90", bwd_grad.format("")),
            ("decode", "decode_attention", "decode_attention_sm90",
             "src/repro/kernels/decode_attention.py:70"),
            ("rglru", "rglru_scan", "rglru_scan", "src/repro/kernels/rglru_scan.py:57"),
            ("mamba", "mamba_scan", "mamba_scan", "src/repro/kernels/mamba_scan.py:68"),
            ("flash_bwd_d256", "flash_attention_bwd_d256", "flash_attention_bwd_sm90",
             bwd_grad.format(" at head_dim 256")),
            ("flash_d160", "flash_attention_d160", "flash_attention_sm90",
             "src/repro/kernels/flash_attention.py:91 (at head_dim 160)"),
            ("flash_d112", "flash_attention_d112", "flash_attention_sm90",
             "src/repro/kernels/flash_attention.py:91 (at head_dim 112)"),
            ("flash_bwd_d160", "flash_attention_bwd_d160", "flash_attention_bwd_sm90",
             bwd_grad.format(" at head_dim 160")),
            ("flash_bwd_d112", "flash_attention_bwd_d112", "flash_attention_bwd_sm90",
             bwd_grad.format(" at head_dim 112")),
            ("decode_d160", "decode_attention_d160", "decode_attention_sm90",
             "src/repro/kernels/decode_attention.py:70 (at head_dim 160)"),
            ("decode_d112", "decode_attention_d112", "decode_attention_sm90",
             "src/repro/kernels/decode_attention.py:70 (at head_dim 112)"),
            ("mamba_bwd", "mamba_scan_bwd", "mamba_scan",
             "src/repro/kernels/mamba_scan.py:68 (its gradient; JAX differentiates "
             "src/repro/kernels/ref.py:mamba_scan_reference)"),
            ("rglru_bwd", "rglru_scan_bwd", "rglru_scan",
             "src/repro/kernels/rglru_scan.py:57 (its gradient; JAX differentiates "
             "src/repro/kernels/ref.py:rglru_reference)"),
            ("topk", "topk_compress", "topk_compress", "src/repro/kernels/topk_compress.py:42"),
            ("fletcher32_wave", "fletcher32_wave", "log_checksum",
             "src/repro/kernels/log_checksum.py:133, and :65 (fletcher32, its one-segment "
             "form)")):
        c = cases[key]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}.cu",
                        "replaces": replaces, "launches": ran[name] + mesh.get(name, 0),
                        "launches_from": from_phase[name] + ("+mesh" if name in mesh else ""),
                        "launches_by_phase": {from_phase[name]: ran[name],
                                              **({"mesh": mesh[name]} if name in mesh else {})},
                        "case": c["case"],
                        "max_abs_err": c["max_err"], "ms": c["kernel_ms"],
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                        "checked": True})
        if key.startswith(("flash", "decode")):  # the bf16 kernel's
            design = (DECODE_DESIGN if key.startswith("decode") else FLASH_DESIGN
                      if key.startswith("flash_bwd") else FLASH_FWD_DESIGN)
            kernels[-1].update(design=design,
                               fp32_source=f"src/repro_torch/kernels/csrc/{source[:-5]}.cu")
        if "kernel_device_ms" in c:  # the same calls' time on the card alone
            kernels[-1].update(device_ms=c["kernel_device_ms"],
                               library_device_ms=c["library_device_ms"])
        if key in ("flash", "decode"):  # every head dim's launches in the serve phase
            kernels[-1]["launches_by_head_dim"] = {
                str(get_config(arch).hd): n[name] for arch, n in by_arch.items() if n[name]}
        if key == "flash_bwd_d256":  # redesigned: its head splits and each launch's time
            kernels[-1].update(design=FLASH_BWD_D256_DESIGN, head_splits=c["head_splits"],
                               **{k: c[k] for k in FLASH_BWD_LAUNCHES})
        if key == "flash_bwd_d112":
            kernels[-1]["note"] = ("kimi-k2 trains on no main path: its launches are "
                                   "train_parity's, at its widths with 8 experts")
        if key in ("flash_d112",):  # at the serve phase's own prompt too
            sv = cases["flash_d112_serve"]
            kernels[-1]["at_serve_shape"] = {
                k: sv[k] for k in ("case", "max_err", "kernel_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "kernel_device_ms",
                                   "library_device_ms")}
        if key == "decode":  # at recurrentgemma-9b's shape too, and SDPA over the live keys
            rg = cases["decode_rgemma"]
            kernels[-1].update(library_live_ms=c["library_live_ms"], at_d256={
                k: rg[k] for k in ("case", "max_err", "kernel_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "library_live_ms")})
        if key == "mamba":
            kernels[-1]["design"] = MAMBA_DESIGN
        if key == "topk":  # redesigned: the other inputs and the share of the rounds
            kernels[-1].update(design=TOPK_DESIGN, fallback_share=c["fallback_share"],
                               bitwise_repeat=c["bitwise_repeat"], at_inputs={
                cases[f"topk_{i}"]["input"]: {
                    k: cases[f"topk_{i}"][k] for k in ("case", "max_err", "bitwise_repeat",
                                                       "fallback_share", "kernel_ms",
                                                       "plain_ms", "bound_ms", "library_ms")}
                for i in ("lifecycle", "ties")})
        if key == "rglru":  # redesigned: also at train_recurrent's own shape
            tr = cases["rglru_train"]
            kernels[-1].update(design=RGLRU_DESIGN, at_train_shape={
                k: tr[k] for k in ("case", "shape", "max_err", "kernel_ms", "plain_ms",
                                   "bound_ms", "bound_by", "bitwise_repeat")})
        if key in SCAN_BWD_DESIGN:  # also checked at train_recurrent's own shape
            tr = cases[f"{key}_train"]
            split = (("chunk", *RGLRU_BWD_LAUNCHES) if key == "rglru_bwd" else
                     ("chunk", "launch_ms", *MAMBA_BWD_LAUNCHES))
            kernels[-1].update(design=SCAN_BWD_DESIGN[key], **{k: c[k] for k in split},
                               at_train_shape={
                k: tr[k] for k in ("case", "shape", "max_err", "max_err_rel_to_scale",
                                   "bitwise_repeat", "kernel_ms", "plain_ms", "bound_ms",
                                   "bound_by", *split)})
    one = cases["fletcher32"]  # checked in its kernel case; the main path never makes the call
    kernels[-1]["one_segment"] = {"name": "fletcher32", "case": one["case"],
                                  "max_abs_err": one["max_err"], "ms": one["kernel_ms"],
                                  "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
                                  "bound_by": one["bound_by"], "library_ms": one["library_ms"]}
    for name, replaces in (
            ("fletcher64_segments", "none: no TPU kernel; the blade's arena is on the card, so "
             "its checksum verify runs there (the host's is src/repro/core/oplog.py:83, "
             "fletcher64_segments)"),
            ("apply_runs", "none: no TPU kernel; the blade's arena is on the card, so its log "
             "replay runs there (the host's is src/repro/core/backend.py:613, tx_apply)")):
        c = nvm[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/nvm_log.cu",
                        "replaces": replaces, "launches": c["launches"],
                        "launches_from": "nvm", "launches_by_phase": {"nvm": c["launches"]},
                        "case": c["case"],
                        "max_abs_err": 0.0 if c["equal_plain"] else None, "ms": c["kernel_ms"],
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                        "checked": True, "design": NVM_DESIGN[name],
                        "bitwise_repeat": c["bitwise_repeat"], "launch_ms": c["launch_ms"]})
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel of the main path never launched: {kernels}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())

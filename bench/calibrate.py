"""Readings that set a cell's limits, on the card at the cell's own size, in
one process:

    python3 bench/calibrate.py --workload <cell> --seeds 12 --controls 3 \
        [--first <seed> | --seed <n> ...] [--seconds 4] [--out <file.jsonl>]

For each of `--seeds` seeds (or each `--seed`), the program's reading: a
run of the cell (a short window) and its check's numbers.  For the first
`--controls` of them, the control's: the reference again in fp8
(``reference/common.py``); for a training cell also the planted fault of
half of each batch left out.  Each is judged as the program is, by the
cell's own limits (``core.judge``), and its line carries ``correct`` and
``check``; a training cell's lines also name the tensors that read the
largest gaps.  Each reading is one JSON line, on standard output and in
`--out`.  A state left unchanged reads 1 on change1_gap and change_gap by
their definition and needs no run.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from bench import run as bench_run  # noqa: E402  (sets the caches' paths and sys.path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--seed", type=int, action="append", default=[],
                    help="read these seeds (each once) in place of --seeds from --first")
    args = ap.parse_args(argv)

    import torch

    from bench import core

    if not torch.cuda.is_available():
        return bench_run.fail("no CUDA device is available")
    manifest = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    files = core.cell_files(args.workload, manifest)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = args.seed or [args.first + 7919 * j for j in range(args.seeds)]
    readings(args.workload, files, manifest, seeds, args.controls, args.seconds, dev, emit)
    return 0


def readings(name, files, manifest, seeds, controls, seconds, dev, emit) -> None:
    """The program's reading on each of `seeds`, and the control's (and a
    training cell's half-batch fault's) on the first `controls` of them."""
    from bench import core
    from bench.entries import serve, train

    cfg, tr, cell = files["config"], files["traffic"], files["cell"]

    def judged(kind, seed, gaps, t0, **more):
        """A control's or a fault's line: its gaps, judged by the cell's limits."""
        check = {k: {"value": gaps[k], "limit": limit} for k, limit in cell["limits"].items()}
        return {"kind": kind, "seed": seed, "correct": core.judge(check), "check": check,
                "gaps": gaps, **more, "seconds": time.time() - t0}

    for j, seed in enumerate(seeds):
        t0 = time.time()
        ctx = core.Context(name=name, seed=seed, seconds=seconds, trace=False,
                           device=dev, files=files, t_start=t0)
        rec, _, run = bench_run.execute(ctx, manifest)
        line = {"kind": "program", "seed": seed, "check": rec["check"],
                "correct": rec["correct"], "attempted": rec["attempted"],
                "seconds": time.time() - t0}
        if tr["entry"] == "train":  # the tensors that read the largest gaps
            prog, exact = run.numbers["program"], run.numbers["reference"]
            line.update(gaps=train.compare(prog, exact),
                        worst={k: train.worst(prog, exact, k) for k in ("change1", "change")})
        emit(line)
        if j >= controls:
            continue
        t0 = time.time()
        if tr["entry"] == "train":
            steps = cell["check"]["steps"]
            exact = run.numbers["reference"]
            low = train.reference_numbers(cfg, tr, steps, seed, dev, precision="float8")
            emit(judged("control", seed, train.compare(low, exact), t0,
                        worst={k: train.worst(low, exact, k) for k in ("change1", "change")}))
            t0 = time.time()
            half = train.reference_numbers(cfg, tr, steps, seed, dev, rows=tr["batch"] // 2)
            emit(judged("fault_half_batch", seed, train.compare(half, exact), t0))
        else:
            # the same requests as the program's run of this seed
            gaps = serve.reference_gaps(cfg, tr, seed, dev, run.sample, ["float32", "float8"])
            emit(judged("control", seed, {"logit_gap": max(gaps["float8"])}, t0,
                        program_gaps={"logit_gap": max(gaps["float32"])}))


if __name__ == "__main__":
    sys.exit(main())

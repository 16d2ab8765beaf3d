"""Runs one cell of the benchmark once and prints its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the program (``src/repro_torch``).  It loads the cell's files by name,
builds and warms the program on weights and inputs made from the seed,
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints, as the last line of its standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics (``--trace 1``, with the
profiled sub-window's ``breakdown``), ``device``, ``setup`` (the seconds of
``setup_s`` that the program spent building its kernels, which only a
checkout's first run does, and the libraries it built), and last
``check``: each number compared beside its limit, which also ends its
standard error.

It exits with another code than 0 and prints no result where the card is
missing, where it has fewer cards than the cell asks for, where the
program is missing, or where a JAX module (or the JAX package ``repro``)
was loaded in this process.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program and its libraries at a fixed path in the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def fail(msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    return 1


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(ctx, manifest):
    """Runs the cell's entry; returns (result line, the lines of the check,
    the run's record)."""
    import importlib

    from bench import core

    entry = importlib.import_module(f"bench.entries.{ctx.files['traffic']['entry']}")
    core.watch_builds()
    core.BUILDS.update(s=0.0, calls=0)
    had = set(core.libraries())
    run = entry.run(ctx)
    run.build_s, run.built = core.BUILDS["s"], sorted(set(core.libraries()) - had)
    metrics = core.read_metrics(run, core.metrics_of(manifest, ctx.name, ctx.trace))
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": "", "count": ctx.files["entry"]["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    if ctx.trace and run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    lines = [f"bench: setup_s {run.setup_s!r} (of it build_s {run.build_s!r}, "
             f"{len(run.built)} libraries built) window_s {run.window_s!r} check_s {run.check_s!r}",
             f"bench: readings {json.dumps(run.readings)}"]
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in run.check.items()]
    return core.result(run, metrics, device, ctx.trace), lines, run


def main(argv=None) -> int:
    args = parse(argv)
    manifest_path = ROOT / "BENCHMARK.json"
    if not manifest_path.is_file():
        return fail(f"{manifest_path} not found")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("the program (src/repro_torch) is not in this checkout")
    manifest = json.loads(manifest_path.read_text())
    from bench import core

    try:
        files = core.cell_files(args.workload, manifest)
    except KeyError as e:
        return fail(str(e))
    import torch

    chips = files["entry"]["chips"]
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")
    ctx = core.Context(name=args.workload, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device=torch.device("cuda", 0), files=files,
                       t_start=T_START)
    result, lines, _ = execute(ctx, manifest)
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    bad = core.loaded_forbidden()
    if bad:
        return fail(f"modules the benchmark must not load were loaded: {bad}")
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

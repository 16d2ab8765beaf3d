"""What every cell shares: finding a cell's files by name, building the
program's model configuration, the run's context and record, the check
that no JAX module was loaded, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files:
``workloads/<cell>.json`` (its check: steps or sampled requests, and the
limits), ``configs/<config>.json`` (the sizes, as run), ``traffic/<traffic>.json``
(the mix, which names the entry: ``entries/<entry>.py``), and one
``metrics/<metric>.py`` a metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Set

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")  # top-level module names


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def config(name: str) -> Dict:
    return load_json(HERE / "configs" / f"{name}.json")


def cell_files(name: str, manifest: Dict) -> Dict[str, Any]:
    """The cell's manifest entry, its own file, its configuration and its
    traffic."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    from . import traffic
    return {"entry": entry, "cell": load_json(HERE / "workloads" / f"{name}.json"),
            "config": config(entry["config"]), "traffic": traffic.load(entry["traffic"])}


def reference(cfg: Dict):
    """The configuration's plain reference module (``reference/<family>.py``)."""
    return importlib.import_module(f"bench.reference.{cfg['reference']}")


def model_config(mc: Dict):
    """The program's ModelConfig from the configuration's ``model_config``."""
    from repro_torch.models.config import ModelConfig, SSMConfig

    kw = dict(mc)
    if kw.get("ssm") is not None:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    if "block_pattern" in kw:
        kw["block_pattern"] = tuple(tuple(p) for p in kw["block_pattern"])
    return ModelConfig(**kw)


def program_specs(specs, prefix: str = "") -> Dict[str, Any]:
    """{name: (shape, dtype name)} of the program's parameter specs."""
    if isinstance(specs, dict):
        out = {}
        for k in sorted(specs):
            out.update(program_specs(specs[k], f"{prefix}{k}/"))
        return out
    if isinstance(specs, (list, tuple)):
        out = {}
        for i, s in enumerate(specs):
            out.update(program_specs(s, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: (tuple(specs.shape), str(specs.dtype).replace("torch.", ""))}


@dataclasses.dataclass
class Context:
    name: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    files: Dict[str, Any]
    t_start: float                 # time.time() when the process started
    faults: Set[str] = dataclasses.field(default_factory=set)  # tests break the path


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take it."""
    entry: str
    config: Dict
    traffic: Dict
    setup_s: float = 0.0
    build_s: float = 0.0           # of setup_s, the program's kernel builds (a first run's)
    built: List[str] = dataclasses.field(default_factory=list)  # the libraries built
    check_s: float = 0.0           # the reference's check, after the window
    window_s: float = 0.0
    tokens: int = 0
    attempted: int = 0
    failed: int = 0
    model_flops: float = 0.0
    step_s: List[float] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    prefill_s: List[float] = dataclasses.field(default_factory=list)
    window_peak_bytes: int = 0
    memory_peak_bytes: int = 0
    trace: Any = None              # trace.Trace of the profiled sub-window
    profiled: Dict = dataclasses.field(default_factory=dict)  # its steps or lengths
    sample: List = dataclasses.field(default_factory=list)  # the requests checked
    numbers: Dict = dataclasses.field(default_factory=dict)  # what the check compared
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)  # every gap read
    check: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    correct: bool = False


BUILDS: Dict[str, Any] = {"s": 0.0, "calls": 0}  # this process's kernel builds


def watch_builds() -> None:
    """Times every kernel build the program makes in this process, into
    BUILDS: a checkout's first run builds the program's CUDA libraries
    (``repro_torch.kernels._build.build``), later runs load them.  The
    program's own function runs unchanged inside; where it has no such
    function nothing is timed."""
    try:
        from repro_torch.kernels import _build
        inner = _build.build
    except (ImportError, AttributeError):
        return
    if getattr(inner, "bench_timed", False):
        return

    def build(*args, **kwargs):
        t = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            BUILDS["s"] += time.perf_counter() - t
            BUILDS["calls"] += 1

    build.bench_timed = True
    _build.build = build


def libraries() -> List[str]:
    """The program's built CUDA libraries in this checkout, by file name."""
    lib_dir = ROOT / "build" / "repro_torch_kernels"
    return sorted(p.name for p in lib_dir.glob("*.so")) if lib_dir.is_dir() else []


def loaded_forbidden() -> List[str]:
    """Modules of sys.modules whose top-level name is one of FORBIDDEN,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def metrics_of(manifest: Dict, cell: str, trace: bool) -> List[Dict]:
    """The manifest's metrics this cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(run: Run, wanted: List[Dict]) -> Dict[str, Dict[str, Any]]:
    """{name: {"value", "unit"}} from each metric's reader
    (``metrics/<name>.py``); a reader that finds nothing is left out."""
    out = {}
    for m in wanted:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run: Run, metrics: Dict, device: Dict, trace: bool) -> Dict:
    out: Dict[str, Any] = {"correct": run.correct, "attempted": run.attempted,
                           "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["setup"] = {"build_s": run.build_s, "built": run.built}  # a first run's builds, apart
    out["check"] = run.check  # last: each number compared beside its limit
    return out


def judge(check: Dict[str, Dict[str, float]]) -> bool:
    """Every number compared is a number and within its limit."""
    return bool(check) and all(c["value"] == c["value"] and c["value"] <= c["limit"]
                               for c in check.values())

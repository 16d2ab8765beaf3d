"""CPU tests of the benchmark's harness (``bench/``), at tiny sizes.

    python -m pytest -q bench/tests

The cells run here on the program's CPU path (its kernels' plain
versions), through the same entries, checks and readers as on the card.
"""

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core, traffic, weights, yardstick  # noqa: E402
from bench import run as bench_run  # noqa: E402
from bench.entries import serve, train  # noqa: E402
from bench.reference import common, dense, mamba  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def tiny(cell: str, dtype: str = "float32"):
    """The cell's files with its widths, depth, vocabulary and traffic cut
    to a size the CPU runs in a second."""
    files = core.cell_files(cell, MANIFEST)
    mc = files["config"]["model_config"]
    if mc.get("ssm"):
        mc.update(n_layers=2, d_model=32, vocab_size=64,
                  ssm={"d_state": 4, "d_conv": 4, "expand": 2, "dt_rank": 4})
    else:
        mc.update(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=48,
                  vocab_size=64, max_cache_len=64)
    mc["dtype"] = dtype
    if files["traffic"]["entry"] == "serve":
        files["traffic"].update(batch=2, deck=4,
                                lengths={"dist": "loguniform", "min": 8, "max": 32, "step": 8})
        files["cell"]["check"]["requests"] = 3
    else:
        files["traffic"].update(batch=2, seq=16)
    return files


def run_tiny(cell: str, faults=(), seed: int = 3_000_000_017, dtype: str = "float32",
             trace: bool = False, seconds: float = 0.2):
    ctx = core.Context(name=cell, seed=seed, seconds=seconds, trace=trace,
                       device=torch.device("cpu"), files=tiny(cell, dtype), t_start=time.time(),
                       faults=set(faults))
    return bench_run.execute(ctx, MANIFEST)


# ------------------------------------------------------------------ discovery
def test_manifest_names_and_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench"]
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    for m in metrics:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
        moved = next(e for e in MANIFEST["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    files = core.cell_files(cell, MANIFEST)
    assert (ROOT / "bench" / "entries" / f"{files['traffic']['entry']}.py").is_file()
    assert core.reference(files["config"]).layout(files["config"]["model_config"])
    for kind in (False, True):
        wanted = core.metrics_of(MANIFEST, cell, kind)
        assert wanted, (cell, kind)
        for m in wanted:
            assert hasattr(core.reader(m["name"]), "read")


def test_configs_state_what_runs():
    """Each configuration's published keys agree with the program's
    ModelConfig it builds, but for the keys it lists as reduced."""
    for c in MANIFEST["configs"]:
        cfg = core.config(c["name"])
        mc = cfg["model_config"]
        assert cfg["hidden_size"] == mc["d_model"]
        assert cfg["num_hidden_layers"] == mc["n_layers"]
        assert cfg["vocab_size"] == mc["vocab_size"]
        if "num_attention_heads" in cfg:
            assert cfg["num_attention_heads"] == mc["n_heads"]
            assert cfg["num_key_value_heads"] == mc["n_kv_heads"]
            assert cfg["intermediate_size"] == mc["d_ff"]
            assert mc["head_dim"] == cfg["hidden_size"] // cfg["num_attention_heads"]
        else:
            assert cfg["intermediate_size"] == mc["ssm"]["expand"] * mc["d_model"]
            assert cfg["state_size"] == mc["ssm"]["d_state"]
            assert cfg["conv_kernel"] == mc["ssm"]["d_conv"]
            assert cfg["time_step_rank"] == mc["ssm"]["dt_rank"]
        assert len(c["source"]) <= 200 and cfg["assumed"]
        core.model_config(mc)  # the program takes it


@pytest.mark.parametrize("cfg", [c["name"] for c in MANIFEST["configs"]])
def test_weight_layout_is_the_programs(cfg):
    from repro_torch.models.model import DecoderLM

    c = core.config(cfg)
    model = DecoderLM(core.model_config(c["model_config"]))
    weights.check_layout(core.reference(c).layout(c["model_config"]),
                         core.program_specs(model.param_specs()))


# ------------------------------------------------------------------ the run
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    result, lines, run = run_tiny(cell)
    assert list(result)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    wanted = {m["name"] for m in core.metrics_of(MANIFEST, cell, False)}
    assert set(result["metrics"]) == wanted - {"train_peak_gib"}  # the card's memory only
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["setup"] == {"build_s": 0.0, "built": []}  # the CPU builds no kernel
    assert len(lines) == 2 + len(result["check"]) and lines[-1].startswith("check ")
    for v in result["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    """A traced run reports the cell's per-layer metrics that the CPU can
    read (the card's are left out: no kernel ran on a card), the profiled
    work's untraced seconds and the breakdown's two lists."""
    result, _, run = run_tiny(cell, trace=True, seconds=1.0)  # the window sees every length
    assert result["correct"] is True and list(result)[-1] == "check"
    names = {m["name"] for m in core.metrics_of(MANIFEST, cell, True)}
    assert set(result["metrics"]) == names & {"step_ms_p50.train", "prefill_ms_p50.serve",
                                              "train_mfu", "prefill_mfu"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert run.profiled["untraced_s"] > 0 and "busy_s" in result["device"]


def test_traffic_is_the_same_work_for_every_seed():
    tr = traffic.load("prefill_loguniform_512_3840")
    deck = traffic.deck(tr)
    assert len(deck) == tr["deck"] and min(deck) == 512 and max(deck) == 3840
    assert all(x % 256 == 0 for x in deck)
    assert sorted(traffic.lengths(tr, len(deck))) == deck
    assert traffic.lengths(tr, 3 * len(deck)) == 3 * traffic.lengths(tr, len(deck))
    assert sorted(traffic.order(13)) == list(range(13))
    # every stretch of the deal spreads over the deck: a window that ends
    # a few batches early or late holds nearly the same lengths
    o = traffic.order(len(deck))
    for n in (4, 8, 16):
        assert max(o[:n]) >= len(deck) * (n - 1) // n - 2 and min(o[:n]) == 0
        assert all(abs(sum(x < len(deck) // 2 for x in o[k:k + n]) - n / 2) <= 1
                   for k in range(0, len(deck) - n, n))
    p = traffic.prompts(tr, 100352, 3_000_000_017, 4, 768)
    assert p.shape == (8, 768) and (p == traffic.prompts(tr, 100352, 3_000_000_017, 4, 768)).all()
    t1 = traffic.train_batch({"batch": 2, "seq": 8}, 50, 2 ** 33, 3, "cpu")
    t2 = traffic.train_batch({"batch": 2, "seq": 8}, 50, 2 ** 33, 3, "cpu")
    assert torch.equal(t1["tokens"], t2["tokens"]) and torch.equal(t1["labels"][:, :-1],
                                                                     t1["tokens"][:, 1:])


def test_weights_redraw_alone():
    layout = dense.layout(tiny("stablelm-12b.prefill")["config"]["model_config"])
    W = weights.make(layout, 2 ** 35 + 1, "cpu")
    for leaf in layout:
        assert torch.equal(weights.draw(leaf, 2 ** 35 + 1, "cpu"), W[leaf[0]])
    nested = weights.nest(W)
    assert nested["blocks"][0]["l0"]["mixer"]["wq"] is W["blocks/0/l0/mixer/wq"]


# ------------------------------------------------------------------ the trace
def _event(kind, start, end, name, annotation=False):
    from types import SimpleNamespace

    return SimpleNamespace(device_type=f"DeviceType.{kind}", name=name, is_async=False,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_trace_reduces_busy_span_and_gaps():
    from bench.trace import Trace, _split, name_gaps

    events = [
        _event("CPU", 0, 100, "bench.train_step", annotation=True),
        _event("CUDA", 0, 100, "bench.train_step", annotation=True),  # the card's mirror
        _event("CPU", 5, 30, "aten::mm"),
        _event("CPU", 40, 60, "aten::add"),
        _event("CUDA", 10, 20, "gemm"), _event("CUDA", 15, 25, "gemm"),
        _event("CUDA", 30, 50, "add"), _event("CUDA", 70, 80, "gemm"),
    ]
    device, host = _split(events)
    t = Trace()
    t.reduce(device)
    assert t.busy_s == pytest.approx(45e-6) and t.window_s == pytest.approx(70e-6)
    assert t.kernel_s == pytest.approx({"gemm": 30e-6, "add": 20e-6})
    assert t.seconds_of(("gem",)) == pytest.approx(30e-6)
    # gaps 25-30 (mid 27.5: inside aten::mm) and 50-70 (mid 60: aten::add's end)
    gaps = dict(name_gaps(device, host))
    assert gaps == pytest.approx({"aten::mm": 5e-6, "aten::add": 20e-6})


# --------------------------------------------------------------- the counts
def test_counts_against_hand_worked_shapes():
    # stablelm-12b: a layer's products 5120 x (32 + 32 + 8 + 8) x 160 + 3 x 5120 x 13824
    mc = core.config("stablelm-12b")["model_config"]
    mp = yardstick.matrix_params(mc)
    assert mp["blocks"] == 40 * (5120 * 80 * 160 + 3 * 5120 * 13824) == 11_114_905_600
    assert mp["head"] == 5120 * 100352
    # falcon-mamba-7b: w_in 4096 x 16384, x_proj 8192 x 288, dt 256 x 8192, out 8192 x 4096
    fm = core.config("falcon-mamba-7b")["model_config"]
    assert yardstick.matrix_params(fm)["blocks"] == 64 * (4096 * 16384 + 8192 * 288
                                                           + 256 * 8192 + 8192 * 4096)
    # causal attention, 1 x 1 head x 4 positions x D 2: 10 pairs, 2 products of 2 x D a pair
    assert yardstick.flash_forward(1, 1, 1, 4, 2)["flops"] == 4 * 2 * 10
    assert yardstick.flash_forward(1, 1, 1, 4, 2)["bytes"] == 2 * (2 * 8 + 2 * 8)
    assert yardstick.flash_backward(1, 1, 1, 4, 2)["flops"] == 10 * 2 * 10
    assert yardstick.flash_backward(1, 1, 1, 4, 2)["bytes"] == 2 * (24 + 16) + 16 + 2 * (8 + 16)
    w = yardstick.mamba_scan_backward(1, 16, 4, 2)
    assert w["exps"] == 16 * 4 * 2
    # x, dy, B, C bf16 and delta, A, D fp32 in; dx, dB, dC bf16 and ddelta, dA, dD fp32 out
    assert w["bytes"] == (2 * (2 * 64 + 2 * 32) + 4 * (64 + 8 + 4)
                          + 2 * (64 + 2 * 32) + 4 * (64 + 8 + 4))
    assert yardstick.train_step_flops(mc, 2, 1024) == pytest.approx(
        6 * (mp["blocks"] + mp["head"]) * 2048 + 3 * 40 * 4 * 2 * 32 * 160 * 1024 * 1025 / 2)
    assert yardstick.prefill_flops(mc, 8, 512) == pytest.approx(
        2 * mp["blocks"] * 8 * 512 + 40 * 4 * 8 * 32 * 160 * 512 * 513 / 2 + 2 * mp["head"] * 8)
    assert yardstick.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 989e12) == pytest.approx(1.0)


# ------------------------------------------------------------ no JAX loaded
def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_in_the_sources():
    for path in (ROOT / "bench").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".", 1)[0] not in core.FORBIDDEN, (path, mod)
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".", 1)[0] != "repro_torch", (path, mod)


def test_no_jax_or_repro_loaded_by_a_run():
    """A whole tiny run of each entry in a fresh process: no module whose
    top-level name is jax, jaxlib, flax, repro or benchmarks is loaded,
    compared whole (repro_torch is not repro)."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}]\n"
        "from bench.tests import test_bench_harness as t\n"
        "for cell in ('falcon-mamba-7b.train', 'stablelm-12b.prefill'):\n"
        "    t.run_tiny(cell)\n"
        "from bench import core\n"
        "print(json.dumps({'bad': core.loaded_forbidden(),\n"
        "                  'port': 'repro_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "port": True}


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("repro_torch_fake_for_test", type(sys)("repro_torch_fake_for_test"))
    assert "repro_torch_fake_for_test" not in core.loaded_forbidden()
    sys.modules["jax_fake_for_test"] = type(sys)("jax_fake_for_test")
    try:
        assert "jax_fake_for_test" not in core.loaded_forbidden()
        sys.modules["jax.fake_for_test"] = type(sys)("jax.fake_for_test")
        assert "jax.fake_for_test" in core.loaded_forbidden()
    finally:
        for k in ("repro_torch_fake_for_test", "jax_fake_for_test", "jax.fake_for_test"):
            sys.modules.pop(k, None)


# ---------------------------------------------- the reference and the port
@pytest.mark.parametrize("cell", ["falcon-mamba-7b.train", "stablelm-12b.train"])
def test_reference_trains_as_the_port(cell):
    """In float32 on the CPU the port and the reference agree to rounding
    on every number the check compares."""
    result = run_tiny(cell)[0]
    for k, v in result["check"].items():
        assert v["value"] < 1e-4, (k, v)


def test_reference_serves_as_the_port():
    """The reference's last-position logits equal the port's prefill
    logits to rounding in float32."""
    from repro_torch.models.model import DecoderLM

    files = tiny("stablelm-12b.prefill")
    mc = files["config"]["model_config"]
    W = weights.make(dense.layout(mc), 7, "cpu")
    model = DecoderLM(core.model_config(mc))
    toks = torch.as_tensor(traffic.prompts(files["traffic"], mc["vocab_size"], 7, 0, 24))
    with torch.no_grad():
        port, _ = model.prefill(weights.nest(W), {"tokens": toks})
    common.set_float32_exact()
    ref = common.last_logits(dense.layer, W, toks, mc, common.Products("float32"))
    torch.testing.assert_close(port.float(), ref, rtol=1e-4, atol=1e-4)


def test_linear_scan_gradient():
    a = torch.rand(6, 2, 3, dtype=torch.float64, requires_grad=True)
    b = torch.randn(6, 2, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(mamba.LinearScan.apply, (a, b))


# --------------------------------------------------- the control and faults
@pytest.mark.parametrize("cell", ["falcon-mamba-7b.train", "stablelm-12b.train"])
def test_control_reads_far_above_the_program(cell):
    """The fp8 control, at a tiny size: each number it gives against the
    float32 reference, beside the program's (float32 here)."""
    files = tiny(cell)
    cfg, tr = files["config"], files["traffic"]
    exact = train.reference_numbers(cfg, tr, 3, 11, "cpu")
    low = train.reference_numbers(cfg, tr, 3, 11, "cpu", precision="float8")
    gaps = train.compare(low, exact)
    program = run_tiny(cell, seed=11)[0]["check"]
    assert max(gaps.values()) > 100 * max(v["value"] for v in program.values())


@pytest.mark.parametrize("cell", CELLS)
def test_calibration_readings(cell):
    """bench/calibrate.py's readings at a tiny size: the program's on two
    seeds, the control's (and a training cell's half-batch fault's) on one."""
    from bench import calibrate

    lines = []
    calibrate.readings(cell, tiny(cell), MANIFEST, [5, 6], 1, 0.2, torch.device("cpu"),
                       lines.append)
    kinds = [x["kind"] for x in lines]
    train_cell = tiny(cell)["traffic"]["entry"] == "train"
    assert kinds == (["program", "control", "fault_half_batch", "program"] if train_cell
                     else ["program", "control", "program"])
    limits = tiny(cell)["cell"]["limits"]
    for x in lines:
        json.dumps(x)
        assert set(x["check"]) == set(limits) and isinstance(x["correct"], bool)
        assert x["correct"] == core.judge(x["check"])
        if x["kind"] == "program":
            assert x["correct"]
        if x["kind"] == "fault_half_batch":
            assert not x["correct"], x["check"]
    if train_cell:
        assert len(lines[0]["worst"]["change1"]) == 5 and len(lines[1]["worst"]["change"]) == 5


def test_sample_checks_every_slot():
    """The serving check's sample: as many requests from each slot of the
    batch, drawn from the seed, the longest prompt among them."""
    import numpy as np

    served = [(b, 64 + 8 * (b % 5), np.full((8, 1), b)) for b in range(40)]
    for seed in (1, 2, 3_000_000_017):
        sample = serve.sample_requests(served, 8, seed, 16)
        assert len(sample) == len(set(sample)) == 16
        assert sorted(r for _, r, _, _ in sample) == sorted(list(range(8)) * 2)
        assert max(length for _, _, length, _ in sample) == 96
    assert serve.sample_requests(served, 8, 5, 16) == serve.sample_requests(served, 8, 5, 16)
    assert serve.sample_requests(served, 8, 5, 16) != serve.sample_requests(served, 8, 6, 16)


def test_builds_are_timed_apart():
    """A run's kernel builds are timed through the program's own build
    function, which still runs (here on an empty list: nothing to build)."""
    from repro_torch.kernels import _build

    core.watch_builds()
    core.watch_builds()  # once only
    core.BUILDS.update(s=0.0, calls=0)
    assert _build.build([]) >= 0.0
    assert core.BUILDS["calls"] == 1 and core.BUILDS["s"] >= 0.0


def test_serve_control_reads_a_gap():
    files = tiny("stablelm-12b.prefill")
    cfg, tr = files["config"], files["traffic"]
    sample = [(b, r, 32, 0) for b in range(30) for r in range(2)]
    gaps = serve.reference_gaps(cfg, tr, 13, "cpu", sample, ["float8"])["float8"]
    assert len(gaps) == 60 and max(gaps) > 1e-3


@pytest.mark.parametrize("cell,fault", [
    ("falcon-mamba-7b.train", "frozen_state"), ("falcon-mamba-7b.train", "half_batch"),
    ("stablelm-12b.train", "frozen_state"), ("stablelm-12b.train", "half_batch"),
    ("stablelm-12b.prefill", "altered_token"),
])
def test_a_broken_path_is_not_correct(cell, fault):
    """The rest of a run, with the timed path broken underneath: `correct`
    comes out false under the cell's own limits."""
    result = run_tiny(cell, faults=[fault])[0]
    assert result["correct"] is False, result["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    """On the card at the cell's size: the control (and a training cell's
    half-batch fault) against the program on one seed (bench/calibrate.py
    reads a dozen)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "calibrate.py"), "--workload",
                          cell, "--seeds", "1", "--controls", "1"], capture_output=True,
                         text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    limits = core.cell_files(cell, MANIFEST)["cell"]["limits"]
    program = next(x for x in lines if x["kind"] == "program")
    assert program["correct"]
    others = [x for x in lines if x["kind"] != "program"]
    assert others
    for x in others:  # judged by the cell's own limits, and not correct
        assert set(x["check"]) == set(limits) and x["correct"] is False, x
        assert any(x["gaps"][k] > limit for k, limit in limits.items()), x

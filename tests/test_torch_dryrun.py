"""The port's dry run (repro_torch.launch.dryrun, launch.analysis) on the
meta device over a fake process group, in a subprocess so the fake world
never reaches other tests: every cell placed on the production mesh, the
L1/L2 block difference exact, and llama3.2-3b x train_4k analysed."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from _torch_ranks import REPO

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import combine_linear, cost_of, diff_cost
    from repro_torch.launch.mesh import make_production_mesh, rules_for
    from repro_torch.models import DecoderLM
    from repro_torch.training.train_step import TrainConfig, make_train_step
    out = {}
    out["compile_only"] = dryrun.main(["--all", "--compile-only"])
    mesh = make_production_mesh(device="meta")
    rec = dryrun.analyze_cell("llama3.2-3b", "train_4k", mesh)
    out["analyze"] = {k: rec[k] for k in ("per_device", "roofline", "useful_flops_fraction",
                                          "memory_analysis", "params_billion")}
    # L1 / L2 / full depth of a smoke config on a 2 x 4 mesh of the fake world
    small = DeviceMesh("cpu", torch.arange(8).view(2, 4), mesh_dim_names=("data", "model"))

    def trace(depth, kind):
        cfg = get_smoke_config("llama3.2-3b", n_layers=depth, fsdp=True, remat="dots")
        model = DecoderLM(cfg)
        rules = rules_for(cfg, small, kind=kind)
        if kind == "train":
            tcfg = TrainConfig()
            from repro_torch.training.optimizer import init_opt_state
            ab = {"params": model.abstract(), "opt": init_opt_state(model.abstract(), tcfg.opt),
                  "step": torch.zeros((), dtype=torch.int32, device="meta")}
            from repro_torch.training.train_step import state_shardings
            state = dryrun._abstract(ab, state_shardings(model, tcfg, rules, small), small)
            batch = dryrun._batch(cfg, 8, 64, small, rules)
            return cost_of(lambda: make_train_step(model, tcfg, rules, small)(state, batch))
        from repro_torch.models.params import make_shardings
        params = dryrun._abstract(model.abstract(), make_shardings(model.param_specs(), small,
                                                                   rules), small)
        batch = dryrun._batch(cfg, 8, 64, small, rules, labels=False)
        with torch.no_grad():
            return cost_of(lambda: model.prefill(params, batch, rules, small))

    trace(1, "train")  # once first: a process copies RoPE's frequency table to a device once
    for kind in ("train", "prefill"):
        c1, c2, full = trace(1, kind), trace(2, kind), trace(5, kind)
        block = diff_cost(c1, c2)
        total = combine_linear(diff_cost(block, c1), block, 5)
        out[f"linear_{kind}"] = {"total": [total.flops, total.hbm_bytes, total.wire_bytes,
                                           {k: v["count"] for k, v in total.collectives.items()}],
                                 "full": [full.flops, full.hbm_bytes, full.wire_bytes,
                                          {k: v["count"] for k, v in full.collectives.items()}]}
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    path = tmp_path_factory.mktemp("dry") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-c", SCRIPT, str(path)], capture_output=True,
                         text=True, env=env, timeout=400)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.load(open(path)), run.stdout


def test_every_cell_is_placed_on_the_production_mesh(dry):
    out, stdout = dry
    assert out["compile_only"] == 0
    assert "[dryrun] 32/32 cells ok" in stdout


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_block_difference_is_exact(dry, kind):
    """base + block * n from depths 1 and 2 equals a depth-5 trace: FLOPs,
    op bytes, wire bytes and the collectives' counts, in training too (a
    stacked group's gradient is written a layer's slot at a time, once)."""
    out, _ = dry
    rec = out[f"linear_{kind}"]
    for i in (0, 1, 2, 3):
        assert rec["total"][i] == rec["full"][i], i
    assert rec["full"][0] > 0 and rec["full"][1] > 0


def test_llama_train_4k_analysis(dry):
    out, _ = dry
    rec = out["analyze"]
    pd = rec["per_device"]
    assert pd["flops"] > 0 and pd["hbm_bytes"] > 0 and pd["wire_bytes"] > 0
    colls = pd["collectives"]
    assert colls["all-gather"]["count"] > 0  # FSDP gathers the weights
    assert colls.get("reduce-scatter", {"count": 0})["count"] + \
        colls.get("all-reduce", {"count": 0})["count"] > 0
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s", "bottleneck",
                                    "bound_s"}
    assert 0 < rec["useful_flops_fraction"] <= 1.0
    assert abs(rec["params_billion"] - 3.6) / 3.6 < 0.06
    mem = rec["memory_analysis"]
    assert mem["argument_bytes_per_device"] == (mem["params_bytes"] + mem["opt_bytes"]
                                                + mem["batch_bytes"])

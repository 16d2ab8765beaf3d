"""One CPU rank of the port's mesh tests (run by tests/_torch_ranks.py):

    python tests/_torch_mesh_worker.py <scenario> <rank> <world> <dir>

Joins a gloo process group over a file:// store in <dir>, reads the
scenario's inputs from <dir>/<scenario>.in.npz (numpy arrays written by the
test), runs it and, on rank 0, writes <dir>/<scenario>.out.pt: a dict of
numpy arrays and numbers.
"""

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch.analysis import parse_collectives  # noqa: E402
from repro_torch.launch.mesh import make_mesh, rules_for  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import place, placements_of, shard  # noqa: E402
from repro_torch.statestore import AsymStore, CheckpointManager  # noqa: E402
from repro_torch.statestore.blade import FileBlade  # noqa: E402
from repro_torch.training import (OptConfig, TrainConfig, Trainer, TrainerConfig,  # noqa: E402
                                  make_train_step)
from repro_torch.training.optimizer import init_opt_state  # noqa: E402
from repro_torch.training.train_step import state_shardings  # noqa: E402
from repro_torch.tree import flatten_named  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

SEQ_CFG = dict(n_heads=3, n_kv_heads=3, head_dim=32, d_model=96, d_ff=128, dtype="float32")


def _np(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().numpy() if t.is_floating_point() else t.detach().numpy()


def _params(inp, prefix, model):
    named = {k[len(prefix):]: v.copy() for k, v in inp.items() if k.startswith(prefix)}
    return params_from_numpy(named, model, "cpu")


def _batch_on(mesh, rules, arrays):
    return {k: shard(torch.from_numpy(v), placements_of(v.shape, ("act_batch",), mesh, rules),
                     mesh) for k, v in arrays.items()}


def _train(mesh, inp, out, opt="adamw"):
    """One train step of the llama smoke config (fsdp) on the mesh."""
    cfg = get_smoke_config("llama3.2-3b", dtype="float32", fsdp=True)
    model = DecoderLM(cfg)
    rules = rules_for(cfg, mesh, kind="train")
    tcfg = TrainConfig(opt=OptConfig(kind=opt, lr=1e-3))
    params = _params(inp, "train/p/", model)
    state = {"params": params, "opt": init_opt_state(params, tcfg.opt),
             "step": torch.zeros((), dtype=torch.int32)}
    state = place(state, state_shardings(model, tcfg, rules, mesh), mesh)
    batch = _batch_on(mesh, rules, {"tokens": inp["train/tokens"], "labels": inp["train/labels"]})
    step = make_train_step(model, tcfg, rules, mesh)
    res = {}
    colls = parse_collectives(lambda: res.update(zip(("state", "met"), step(state, batch))))
    out[f"train_{opt}/colls"] = {k: v["count"] for k, v in colls.items()}
    out[f"train_{opt}/loss"] = float(res["met"]["loss"])
    out[f"train_{opt}/grad_norm"] = float(res["met"]["grad_norm"])
    for name, t in flatten_named(res["state"]):
        out[f"train_{opt}/state/{name}"] = _np(t)


def _seq_parallel(mesh, inp, out):
    """The 3-head config: sequence-parallel loss; prefill and a decode step
    with the cache sharded on its length."""
    cfg = get_smoke_config("llama3.2-3b", **SEQ_CFG)
    model = DecoderLM(cfg)
    rules = rules_for(cfg, mesh, kind="train")
    assert rules["act_heads"] is None and rules["act_seq"] == "model"
    params = place(_params(inp, "seq/p/", model), _shardings(model, mesh, rules), mesh)
    toks = inp["seq/tokens"]
    batch = _batch_on(mesh, rules, {"tokens": toks, "labels": inp["seq/labels"]})
    with torch.no_grad():
        out["seq/loss"] = float(model.loss(params, batch, rules, mesh).full_tensor())
    drules = rules_for(cfg, mesh, kind="decode")
    assert drules["act_cache_len"] == "model"
    dparams = place(_params(inp, "seq/p/", model), _shardings(model, mesh, drules), mesh)
    with torch.inference_mode():
        pre = _batch_on(mesh, drules, {"tokens": toks[:, :16]})
        logits, cache = model.prefill(dparams, pre, drules, mesh)
        out["seq/prefill"] = _np(logits)
        k0 = cache["groups"][0]["l0"]["mixer"]["k"]
        out["seq/cache_len_sharded"] = any(getattr(p, "dim", None) == 3 for p in k0.placements)
        tok = _batch_on(mesh, drules, {"t": toks[:, 16]})["t"]
        l2, cache = model.decode_step(dparams, cache, tok, drules, mesh)
        out["seq/decode"] = _np(l2)


def _shardings(model, mesh, rules):
    from repro_torch.models.params import make_shardings
    return make_shardings(model.param_specs(), mesh, rules)


def _moe(mesh, inp, out, arch, impl, tag, **moe_over):
    cfg = get_smoke_config(arch, dtype="float32")
    m = dataclasses.replace(cfg.moe, capacity_factor=8.0, **moe_over)
    cfg_impl = dataclasses.replace(cfg, moe=dataclasses.replace(m, impl=impl))
    cfg_dense = dataclasses.replace(cfg, moe=dataclasses.replace(m, impl="dense"))
    named = {k[len(f"{tag}/p/"):]: torch.from_numpy(v) for k, v in inp.items()
             if k.startswith(f"{tag}/p/")}
    specs = moe.moe_specs(cfg_impl)
    rules = rules_for(cfg_impl, mesh, kind="train")
    p = {n: shard(t, placements_of(t.shape, specs[n].logical_axes, mesh, rules), mesh)
         for n, t in named.items()}
    x = _batch_on(mesh, rules, {"x": inp[f"{tag}/x"]})["x"]
    with torch.no_grad():
        colls = parse_collectives(lambda: out.__setitem__(
            f"{tag}/y", _np(moe.moe_apply(p, x, cfg_impl, rules, mesh))))
        out[f"{tag}/y_dense"] = _np(moe.moe_apply(p, x, cfg_dense, rules, mesh))
    out[f"{tag}/impl"] = moe._impl(cfg_impl, mesh)
    out[f"{tag}/colls"] = {k: v["count"] for k, v in colls.items()}


def _store(mesh, inp, out, directory):
    """A 2 x 4 trainer with full commits every 2 steps and delta commits
    every 3: 3 steps; rank 0's whole state after step 2 goes out."""
    cfg = get_smoke_config("llama3.2-3b", fsdp=True)
    model = DecoderLM(cfg)
    rules = rules_for(cfg, mesh, kind="train")
    ckpt = CheckpointManager(AsymStore(FileBlade(f"{directory}/blade")), full_every=2,
                             delta_every=3)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=16, seed=5)
    tr = Trainer(model, TrainConfig(opt=OptConfig(lr=1e-3)), dcfg, ckpt=ckpt, rules=rules,
                 mesh=mesh, seed=3, device="cpu")
    tr.init()
    tr.run(TrainerConfig(total_steps=2))
    for name, t in flatten_named(tr.state):
        out[f"store/at2/{name}"] = t.full_tensor().numpy() if t.dtype != torch.bfloat16 else \
            t.full_tensor().view(torch.int16).numpy()
    tr.run(TrainerConfig(total_steps=3))
    out["store/losses"] = [m["loss"] for m in tr.metrics_log]
    out["store/host"] = (tr.pipeline.cfg.n_hosts, tr.pipeline.cfg.host_id)


def _recurrent(mesh, inp, out):
    """falcon-mamba-7b and recurrentgemma-9b (smoke, float32): a train step
    and greedy serving on the mesh, against the port without one."""
    from repro_torch.serving.engine import ServeConfig, ServeEngine
    from repro_torch.training import init_train_state

    for arch in ("falcon-mamba-7b", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch, dtype="float32")
        model = DecoderLM(cfg)
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3))
        rules = rules_for(cfg, mesh, kind="train")
        batch = model.sample_inputs(4, 32)
        s0 = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
        s1 = place(init_train_state(model, torch.Generator().manual_seed(0), tcfg),
                   state_shardings(model, tcfg, rules, mesh), mesh)
        _, m0 = make_train_step(model, tcfg)(s0, batch)
        _, m1 = make_train_step(model, tcfg, rules, mesh)(
            s1, _batch_on(mesh, rules, {k: v.numpy() for k, v in batch.items()}))
        out[f"rec/{arch}/train"] = [float(m0["loss"]), float(m1["loss"]),
                                    float(m0["grad_norm"]), float(m1["grad_norm"])]
        params = model.init(torch.Generator().manual_seed(1))
        prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
        scfg = ServeConfig(batch_slots=4, max_new_tokens=5)
        want, _ = ServeEngine(model, params, scfg, device="cpu").generate(prompts)
        got, _ = ServeEngine(model, params, scfg, rules_for(cfg, mesh, kind="decode"),
                             mesh).generate(prompts)
        out[f"rec/{arch}/serve"] = bool(np.array_equal(want, got))


def _bitwise_one_rank(mesh, inp, out):
    """On a 1 x 1 mesh: train steps and serving, against the mesh-less path."""
    from repro_torch.serving.engine import ServeConfig, ServeEngine
    from repro_torch.training import init_train_state

    cfg = get_smoke_config("llama3.2-3b", fsdp=True)
    model = DecoderLM(cfg)
    for opt in ("adamw", "adafactor"):
        tcfg = TrainConfig(opt=OptConfig(kind=opt, lr=1e-3))
        rules = rules_for(cfg, mesh, kind="train")
        s0 = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
        s1 = place(init_train_state(model, torch.Generator().manual_seed(0), tcfg),
                   state_shardings(model, tcfg, rules, mesh), mesh)
        batch = model.sample_inputs(4, 32)
        f0, f1 = make_train_step(model, tcfg), make_train_step(model, tcfg, rules, mesh)
        same = True
        for _ in range(2):
            s0, m0 = f0(s0, batch)
            s1, m1 = f1(s1, _batch_on(mesh, rules, {k: v.numpy() for k, v in batch.items()}))
            same &= all(torch.equal(m0[k], m1[k]) for k in m0)
        a, b = dict(flatten_named(s0)), dict(flatten_named(s1))
        same &= all(torch.equal(a[n], b[n].to_local() if isinstance(b[n], DTensor) else b[n])
                    for n in a)
        out[f"one/train_{opt}"] = bool(same)
    params = model.init(torch.Generator().manual_seed(1))
    drules = rules_for(cfg, mesh, kind="decode")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    scfg = ServeConfig(batch_slots=2, max_new_tokens=5)
    want, _ = ServeEngine(model, params, scfg, device="cpu").generate(prompts)
    got, _ = ServeEngine(model, params, scfg, drules, mesh).generate(prompts)
    out["one/serve"] = bool(np.array_equal(want, got))


def _pipeline(mesh, inp, out):
    from repro_torch.training.pipeline import pipeline_apply

    w, x = torch.from_numpy(inp["w"]), torch.from_numpy(inp["x"])
    out["y"] = pipeline_apply(lambda p, h: torch.tanh(h @ p), w, x, mesh, axis="stage",
                              n_micro=4).numpy()
    # the stage weights as a DTensor sharded on the stage axis: the same
    from torch.distributed.tensor import Shard
    wd = shard(w, [Shard(0)], mesh)
    out["y_dtensor"] = pipeline_apply(lambda p, h: torch.tanh(h @ p), wd, x, mesh,
                                      axis="stage", n_micro=4).numpy()


def main(scenario, rank, world, directory):
    dist.init_process_group("gloo", init_method=f"file://{directory}/{scenario}.store",
                            rank=rank, world_size=world)
    try:
        inp = dict(np.load(f"{directory}/{scenario}.in.npz")) if scenario != "mesh1" else {}
        out = {}
        if scenario == "mesh1":
            _bitwise_one_rank(make_mesh((1, 1), ("data", "model"), "cpu"), inp, out)
        elif scenario == "mesh8":
            mesh = make_mesh((2, 4), ("data", "model"), "cpu")
            _train(mesh, inp, out, "adamw")
            _train(mesh, inp, out, "adafactor")
            _seq_parallel(mesh, inp, out)
            _moe(mesh, inp, out, "kimi-k2-1t-a32b", "ep_a2a", "ep")
            _store(mesh, inp, out, directory)
            _recurrent(mesh, inp, out)
        elif scenario == "pipe4":
            _pipeline(make_mesh((4,), ("stage",), "cpu"), inp, out)
        elif scenario == "mesh6":
            mesh = make_mesh((2, 3), ("data", "model"), "cpu")
            _moe(mesh, inp, out, "grok-1-314b", "tp_sort", "tp", d_expert=96)
        else:
            raise ValueError(scenario)
        if rank == 0:
            torch.save(out, f"{directory}/{scenario}.out.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

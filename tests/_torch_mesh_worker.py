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
# falcon-mamba-7b's smoke config at d_model 90 (with the test's ssm expand of 3:
# 270 channels, which a model dim of 4 does not divide)
ODD_FM = dict(d_model=90)


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


def _bitwise_one_rank_recurrent(mesh, out):
    """On a 1 x 1 mesh, the recurrent mixers' channel route: the step-0
    gradients, two Adafactor steps and greedy serving of falcon-mamba-7b and
    recurrentgemma-9b (smoke, bf16) against the mesh-less path."""
    from repro_torch.serving.engine import ServeConfig, ServeEngine
    from repro_torch.training import init_train_state

    for arch in ("falcon-mamba-7b", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch)
        model = DecoderLM(cfg)
        tcfg = TrainConfig(opt=OptConfig(kind="adafactor", lr=1e-3, momentum_dtype="bfloat16"))
        rules = rules_for(cfg, mesh, kind="train")
        batch = model.sample_inputs(2, 32)
        s0 = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
        s1 = place(init_train_state(model, torch.Generator().manual_seed(0), tcfg),
                   state_shardings(model, tcfg, rules, mesh), mesh)
        b1 = _batch_on(mesh, rules, {k: v.numpy() for k, v in batch.items()})
        rec = _Recorder()
        try:
            _, g0 = _loss_and_grads(model, s0["params"], batch)
            _, g1 = _loss_and_grads(model, s1["params"], b1, rules, mesh)
            same = sorted(g0) == sorted(g1) and all(np.array_equal(g0[n], g1[n]) for n in g0)
            f0, f1 = make_train_step(model, tcfg), make_train_step(model, tcfg, rules, mesh)
            for _ in range(2):
                s0, m0 = f0(s0, batch)
                s1, m1 = f1(s1, b1)
                same &= all(torch.equal(m0[k], m1[k]) for k in m0)
            a, b = dict(flatten_named(s0)), dict(flatten_named(s1))
            same &= all(torch.equal(a[n], b[n].to_local() if isinstance(b[n], DTensor) else b[n])
                        for n in a)
            params = model.init(torch.Generator().manual_seed(1))
            prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
            scfg = ServeConfig(batch_slots=2, max_new_tokens=9)
            want, _ = ServeEngine(model, params, scfg, device="cpu").generate(prompts)
            got, _ = ServeEngine(model, params, scfg, rules_for(cfg, mesh, kind="decode"),
                                 mesh).generate(prompts)
            same &= bool(np.array_equal(want, got))
        finally:
            rec.close()
        out[f"one_rec/{arch}"] = bool(same) and rec.rows == 0


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



# ------------------------------------------------- gradients on the 2 x 4 world
def _loss_and_grads(model, params, batch, rules=None, mesh=None):
    """The loss and every parameter's gradient (whole tensors), as
    train_step's value_and_grad takes them."""
    leaves = dict(flatten_named(params))
    live = {n: p.detach().requires_grad_(True) for n, p in leaves.items()}
    from repro_torch.tree import tree_map_named

    loss = model.loss(tree_map_named(lambda n, _: live[n], params), batch, rules, mesh)
    grads = torch.autograd.grad(loss, list(live.values()))
    return float(_np(loss)), {n: _np(g) for n, g in zip(live, grads)}


class _Recorder:
    """What reached the scans (their first input's shape and the final
    state's, once a scan) and how many mixers took the data-parallel route
    (``layers._mixer_rows``), while it is open."""

    def __init__(self):
        from repro_torch.models import layers

        self.layers, self.seen, self.rows = layers, {}, 0
        self.saved = {n: getattr(layers.ops, n) for n in ("mamba_scan", "rglru_scan")}
        self.saved_rows = layers._mixer_rows
        for name, fn in self.saved.items():
            setattr(layers.ops, name, self._scan(name, fn))
        layers._mixer_rows = self._rows

    def _scan(self, name, fn):
        def run(*args, **kwargs):
            y, hT = fn(*args, **kwargs)
            self.seen.setdefault(name, [list(args[0].shape), list(hT.shape)])
            return y, hT

        return run

    def _rows(self, *args, **kwargs):
        self.rows += 1
        return self.saved_rows(*args, **kwargs)

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.layers.ops, name, fn)
        self.layers._mixer_rows = self.saved_rows


def _mixer_flops(cfg, mesh, rules):
    """A mixer's FLOPs (CostMode) for a forward and backward of layer 0 on
    this rank, with and without the mesh, on the same seeded input."""
    from repro_torch.launch.analysis import CostMode
    from repro_torch.models import layers
    from repro_torch.models.params import init_params, make_shardings

    kind = cfg.block_pattern[0][0]
    specs = layers.mamba_specs(cfg) if kind == "mamba" else layers.rglru_specs(cfg)
    apply = layers.mamba_apply if kind == "mamba" else layers.rglru_apply
    p = init_params(specs, torch.Generator().manual_seed(4))
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(5))
    flops = []
    for on_mesh in (False, True):
        pp = place(p, make_shardings(specs, mesh, rules), mesh) if on_mesh else p
        xx = _batch_on(mesh, rules, {"x": x.numpy()})["x"] if on_mesh else x
        live = {k: v.detach().requires_grad_(True) for k, v in pp.items()}
        xx = xx.detach().requires_grad_(True)
        with CostMode() as mode:
            y, _ = apply(live, xx, cfg, "train")
            y = y.to_local() if on_mesh else y  # each rank's rows
            torch.autograd.grad(y.sum(), [xx] + list(live.values()))
        flops.append(mode.flops)
    return flops


def _route_b(mesh, inp, out, tag, arch, over):
    """A recurrent model (2 layers) on the 2 x 4 mesh: the loss and every
    gradient, the local shapes of the weights, the scans' inputs and the
    caches, the routes the mixers took, the mixer's FLOPs and greedy
    serving, beside the port without a mesh."""
    from repro_torch.models.params import make_shardings
    from repro_torch.serving.engine import ServeConfig, ServeEngine

    cfg = get_smoke_config(arch, dtype="float32", n_layers=2, **over)
    if f"{tag}/ssm_expand" in inp:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, expand=int(inp[f"{tag}/ssm_expand"])))
    model = DecoderLM(cfg)
    rules = rules_for(cfg, mesh, kind="train")
    batch = {"tokens": inp[f"{tag}/tokens"], "labels": inp[f"{tag}/labels"]}
    loss0, g0 = _loss_and_grads(model, _params(inp, f"{tag}/p/", model),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    placed = place(_params(inp, f"{tag}/p/", model), _shardings(model, mesh, rules), mesh)
    rec = _Recorder()
    try:
        loss1, g1 = _loss_and_grads(model, placed, _batch_on(mesh, rules, batch), rules, mesh)
        out[f"{tag}/train_seen"], out[f"{tag}/train_rows"] = dict(rec.seen), rec.rows
        rec.seen, rec.rows = {}, 0
        drules = rules_for(cfg, mesh, kind="decode")
        params = _params(inp, f"{tag}/p/", model)
        prompts = inp[f"{tag}/tokens"][:, :12]
        scfg = ServeConfig(batch_slots=4, max_new_tokens=9)
        want, _ = ServeEngine(model, params, scfg, device="cpu").generate(prompts)
        rec.seen = {}
        eng = ServeEngine(model, params, scfg, drules, mesh)
        got, _ = eng.generate(prompts)
        out[f"{tag}/serve_seen"], out[f"{tag}/serve_rows"] = dict(rec.seen), rec.rows
        with torch.inference_mode():
            logits, cache = model.prefill(eng.params, {"tokens": eng._tokens(
                torch.from_numpy(prompts.astype(np.int64)))}, drules, mesh)
        out[f"{tag}/prefill"] = _np(logits)
        out[f"{tag}/cache_local"] = {n: list(t.to_local().shape)
                                     for n, t in flatten_named(cache["groups"])}
    finally:
        rec.close()
    out[f"{tag}/loss"] = [loss0, loss1]
    out[f"{tag}/grads0"], out[f"{tag}/grads"] = g0, g1
    out[f"{tag}/local"] = {n: list(t.to_local().shape) for n, t in flatten_named(placed)}
    out[f"{tag}/tokens"] = [want, got]
    out[f"{tag}/flops"] = _mixer_flops(cfg, mesh, rules)


def _ep_grads(mesh, inp, out):
    """ep_a2a's gradient with 3 local tokens over a model dim of 4 (the
    replicated routing), and dense's without a mesh, of sum(y * r)."""
    from torch.distributed.tensor import DTensor as DT

    cfg = get_smoke_config("kimi-k2-1t-a32b", dtype="float32")
    m = dataclasses.replace(cfg.moe, capacity_factor=8.0)
    cfg_a2a = dataclasses.replace(cfg, moe=dataclasses.replace(m, impl="ep_a2a"))
    cfg_dense = dataclasses.replace(cfg, moe=dataclasses.replace(m, impl="dense"))
    named = {k[len("epg/p/"):]: torch.from_numpy(v) for k, v in inp.items()
             if k.startswith("epg/p/")}
    specs = moe.moe_specs(cfg_a2a)
    rules = rules_for(cfg_a2a, mesh, kind="train")
    x, r = torch.from_numpy(inp["epg/x"]), torch.from_numpy(inp["epg/r"])
    for path in ("dense", "ep_a2a"):
        if path == "dense":
            p = {n: t.clone().requires_grad_(True) for n, t in named.items()}
            xx = x.clone().requires_grad_(True)
            loss = (moe.moe_apply(p, xx, cfg_dense) * r).sum()
        else:
            p = {n: shard(t, placements_of(t.shape, specs[n].logical_axes, mesh, rules),
                          mesh).requires_grad_(True) for n, t in named.items()}
            on = _batch_on(mesh, rules, {"x": inp["epg/x"], "r": inp["epg/r"]})
            xx = on["x"].requires_grad_(True)
            out["epg/impl"] = moe._impl(cfg_a2a, mesh)
            out["epg/local_tokens"] = xx.to_local().shape[0] * xx.shape[1]
            loss = (moe.moe_apply(p, xx, cfg_a2a, rules, mesh) * on["r"]).sum()
            loss = loss.full_tensor() if isinstance(loss, DT) else loss
        grads = torch.autograd.grad(loss, [xx] + list(p.values()))
        out[f"epg/{path}"] = {n: _np(g) for n, g in zip(["x"] + list(p), grads)}


def _pipeline_grads(mesh, inp, out):
    """pipeline_apply over the 4 stages of a ("data", "stage") mesh: the
    output and the gradients of sum(y * r) for the stage weights (plain and
    as a DTensor sharded on the stage axis) and for x."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.training.pipeline import pipeline_apply

    w, x, r = (torch.from_numpy(inp[f"pipe/{k}"]) for k in ("w", "x", "r"))
    for form in ("plain", "dtensor"):
        wp = (w.clone() if form == "plain" else
              shard(w, [Replicate(), Shard(0)], mesh)).requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        y = pipeline_apply(lambda p, h: torch.tanh(h @ p), wp, xx, mesh, axis="stage", n_micro=4)
        gw, gx = torch.autograd.grad((y * r).sum(), [wp, xx])
        if form == "plain":  # each rank's gradient holds its own stage's slice
            mine = gw[mesh.get_coordinate()[1]].contiguous()
            parts = [torch.empty_like(mine) for _ in range(4)]
            dist.all_gather(parts, mine, group=mesh.get_group(1))
            gw = torch.stack(parts)
        out[f"pipe/{form}"] = {"y": _np(y), "w": _np(gw), "x": _np(gx)}


def _grads8(inp, out):
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    _route_b(mesh, inp, out, "fm", "falcon-mamba-7b", {})
    _route_b(mesh, inp, out, "rg", "recurrentgemma-9b", {})
    _route_b(mesh, inp, out, "fm_odd", "falcon-mamba-7b", ODD_FM)
    _ep_grads(mesh, inp, out)
    _pipeline_grads(make_mesh((2, 4), ("data", "stage"), "cpu"), inp, out)


def main(scenario, rank, world, directory):
    dist.init_process_group("gloo", init_method=f"file://{directory}/{scenario}.store",
                            rank=rank, world_size=world)
    try:
        inp = dict(np.load(f"{directory}/{scenario}.in.npz")) if scenario not in (
            "mesh1", "mesh1rec") else {}
        out = {}
        if scenario == "mesh1":
            _bitwise_one_rank(make_mesh((1, 1), ("data", "model"), "cpu"), inp, out)
        elif scenario == "mesh1rec":
            _bitwise_one_rank_recurrent(make_mesh((1, 1), ("data", "model"), "cpu"), out)
        elif scenario == "mesh8":
            mesh = make_mesh((2, 4), ("data", "model"), "cpu")
            _train(mesh, inp, out, "adamw")
            _train(mesh, inp, out, "adafactor")
            _seq_parallel(mesh, inp, out)
            _moe(mesh, inp, out, "kimi-k2-1t-a32b", "ep_a2a", "ep")
            _store(mesh, inp, out, directory)
            _recurrent(mesh, inp, out)
        elif scenario == "grads8":
            _grads8(inp, out)
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

"""A stacked group's gradient in training (``models.model._layers``): each
layer's slice is taken once a forward, and the backward writes the layer's
gradient into its slot of one buffer, where indexing the stack (``t[r]``)
wrote a zero tensor of the whole stack's size for every layer and summed
them.  Held bit for bit to that route, built here by putting ``_index``
back in ``_layers``' place: the gradients in fp32 and bf16 with a -0.0
planted in one slice's gradient (the old sum made it +0.0), under remat
"none", "dots" and "full", and one AdamW train step; and, under
torch.profiler, the backward writes no whole-stack tensor per layer."""

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import DecoderLM
from repro_torch.models import model as model_mod
from repro_torch.training import OptConfig, TrainConfig, init_train_state, make_train_step
from repro_torch.tree import flatten_named, tree_map_named

DEPTH = 4
PLANT = ("l0", "ffn", "w_up")   # layer 1's slice of this leaf gets a -0.0 at [0, 0]


def _old_route(monkeypatch):
    """Indexing the stack once a layer, the route before ``_layers``."""
    monkeypatch.setattr(model_mod, "_layers",
                        lambda tree, n: [model_mod._index(tree, r) for r in range(n)])


class _NegZero(torch.autograd.Function):
    """The identity; its backward sets the gradient's [0, 0] to -0.0."""

    @staticmethod
    def forward(ctx, w):
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g[0, 0] = -0.0
        return g


def _plant(monkeypatch):
    """Every call of a superblock that gets layer 1's slice of PLANT (told by
    its offset in the stack's storage) runs it through _NegZero."""
    run = DecoderLM._superblock

    def superblock(self, pattern, p, *args, **kwargs):
        a, b, c = PLANT
        w = p[a][b][c]
        if w.dim() == 2 and w.storage_offset() == w.numel():
            p = {**p, a: {**p[a], b: {**p[a][b], c: _NegZero.apply(w)}}}
        return run(self, pattern, p, *args, **kwargs)

    monkeypatch.setattr(DecoderLM, "_superblock", superblock)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _grads(cfg, params, batch):
    model = DecoderLM(cfg)
    leaves = {n: p.detach().requires_grad_(True) for n, p in flatten_named(params)}
    loss = model.loss(tree_map_named(lambda n, _: leaves[n], params), batch)
    return loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_gradients_are_the_indexed_routes_bits(monkeypatch, dtype, remat):
    cfg = get_smoke_config("llama3.2-3b", n_layers=DEPTH, dtype=dtype, remat=remat)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = model.sample_inputs(2, 16, torch.Generator().manual_seed(1))
    _plant(monkeypatch)
    loss, new = _grads(cfg, params, batch)
    _old_route(monkeypatch)
    loss_old, old = _grads(cfg, params, batch)
    assert torch.equal(loss, loss_old)
    assert sorted(new) == sorted(old)
    for name in old:
        assert torch.equal(_bits(new[name]), _bits(old[name])), name
    planted = new["blocks/0/" + "/".join(PLANT)][1, 0, 0]
    assert _bits(planted) == 0  # +0.0, as the old sum left it


WRITES = ("aten::fill_", "aten::zero_", "aten::zeros", "aten::add_", "aten::add",
          "aten::copy_", "aten::stack", "aten::cat", "aten::index_put_", "aten::slice_scatter",
          "aten::select_scatter")


def _stack_writes(cfg, params, batch):
    """The backward's ops (of WRITES) that take a tensor of a stacked leaf's
    whole shape, by name, from torch.profiler's recorded shapes."""
    from torch.profiler import ProfilerActivity, profile

    model = DecoderLM(cfg)
    leaves = {n: p.detach().requires_grad_(True) for n, p in flatten_named(params)}
    stacked = [tuple(t.shape) for t in leaves.values() if t.dim() >= 2 and t.shape[0] == DEPTH]
    stacks = set(stacked)
    loss = model.loss(tree_map_named(lambda n, _: leaves[n], params), batch)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        torch.autograd.grad(loss, list(leaves.values()))
    counts = {}
    for e in prof.events():
        if e.name in WRITES and any(tuple(s) in stacks for s in e.input_shapes if s):
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts, len(stacked)


def test_backward_writes_no_whole_stack_per_layer(monkeypatch):
    """At most one whole-stack write per stacked leaf (none: each slot is
    written by the layer's own op), and no fill, zero or add of the whole
    stack; the old route makes one zero fill and one add of it per layer."""
    cfg = get_smoke_config("llama3.2-3b", n_layers=DEPTH, dtype="float32")
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = model.sample_inputs(2, 16, torch.Generator().manual_seed(1))
    counts, n_stacked = _stack_writes(cfg, params, batch)
    assert n_stacked == 9  # two norms, four attention and three FFN weights
    assert sum(counts.values()) <= n_stacked, counts
    assert not {"aten::fill_", "aten::zero_", "aten::zeros", "aten::add_"} & set(counts), counts
    _old_route(monkeypatch)
    old, _ = _stack_writes(cfg, params, batch)
    assert sum(old.values()) >= (DEPTH - 1) * n_stacked, old


def test_one_train_step_is_the_indexed_routes_bits(monkeypatch):
    cfg = get_smoke_config("llama3.2-3b", n_layers=3)
    model = DecoderLM(cfg)
    tcfg = TrainConfig(opt=OptConfig(kind="adamw", lr=1e-3))
    batch = model.sample_inputs(2, 16, torch.Generator().manual_seed(2))
    runs = []
    for old in (False, True):
        if old:
            _old_route(monkeypatch)
        state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
        _, grads = _grads(cfg, state["params"], batch)
        state, metrics = make_train_step(model, tcfg)(state, batch)
        runs.append((metrics, grads, dict(flatten_named(state))))
    (m0, g0, s0), (m1, g1, s1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert sorted(g0) == sorted(g1) and sorted(s0) == sorted(s1)
    assert all(torch.equal(_bits(g0[n]), _bits(g1[n])) for n in g0)
    assert all(torch.equal(s0[n], s1[n]) for n in s0)

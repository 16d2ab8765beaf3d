"""``ModelConfig.remat`` in the port's training forward (``models/remat.py``)
against the JAX package's ``_remat``, on the CPU, at the smoke widths of a
dense arch (llama3.2-3b), falcon-mamba-7b, recurrentgemma-9b and kimi-k2
(MoE), from the same JAX-initialised weights and batch:

  * every mode gives the loss and every gradient of "none", bit for bit;
  * at each mode the loss and gradients match ``jax.value_and_grad`` of the
    reference at the same mode, within test_torch_training's tolerances
    (``GRAD_TOL``);
  * under "dots" the products the port saves are the residuals the
    reference saves beyond "full" (``print_saved_residuals``),
    compared by count and size: the port's products are flattened to 2-D or
    run over experts, so each is compared by its dtype and element count;
  * an unknown mode recomputes everything, as "full" and JAX's fallthrough.
"""

import collections
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import print_saved_residuals
import numpy as np
import pytest
import torch

from repro.statestore.checkpoint import flatten_named as j_flatten_named
from repro_torch.models import DecoderLM, layers, remat
from repro_torch.tree import flatten_named, tree_map_named
from test_torch_training import GRAD_TOL, _batch, _grad_close, _models

ARCHS = ("llama3.2-3b", "falcon-mamba-7b", "recurrentgemma-9b", "kimi-k2-1t-a32b")
UNKNOWN = "every_layer"  # a mode the reference does not name: full recompute


def _port_loss_and_grads(model, params, batch):
    leaves = {n: p.clone().requires_grad_(True) for n, p in flatten_named(params)}
    loss = model.loss(tree_map_named(lambda n, _: leaves[n], params),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in leaves.items()}


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("mode", ["dots", "save_dots", "full", UNKNOWN])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_mode_is_bitwise_none(arch, mode):
    _, _, model, params = _models(arch)
    batch = _batch(model.cfg.vocab_size)
    loss0, grads0 = _port_loss_and_grads(model, params, batch)
    loss, grads = _port_loss_and_grads(DecoderLM(dataclasses.replace(model.cfg, remat=mode)),
                                       params, batch)
    assert torch.equal(_bits(loss), _bits(loss0))
    assert sorted(grads) == sorted(grads0)
    for name, g in grads.items():
        assert torch.equal(_bits(g), _bits(grads0[name])), name


@pytest.mark.parametrize("mode", ["dots", "save_dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_mode_matches_jax_at_the_same_mode(arch, mode):
    jm, jp, model, params = _models(arch, remat=mode)
    assert jm.cfg.remat == model.cfg.remat == mode
    batch = _batch(model.cfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_loss_and_grads(model, params, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    want = dict(j_flatten_named(jgrads))
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        _grad_close(g, want[name], GRAD_TOL.get(arch, 1e-3))


def _jax_residuals(arch, mode, batch):
    """{(dtype, elements): count} of what the reference saves for the
    backward of its loss at `mode` (print_saved_residuals)."""
    jm, jp, _, _ = _models(arch, remat=mode, scan_layers=False)  # a residual a superblock
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(lambda p: jm.loss(p, jb), jp)
    found = collections.Counter()
    for line in out.getvalue().splitlines():
        m = re.match(r"\s*(\w+)\[([\d,]*)\]", line)
        if m:
            dtype = {"f32": "float32", "bf16": "bfloat16"}.get(m.group(1), m.group(1))
            found[dtype, int(np.prod([int(d) for d in m.group(2).split(",") if d]))] += 1
    return found


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_saves_the_reference_residuals(arch, monkeypatch):
    """Under "dots" the reference keeps, beyond what "full" keeps (the
    parameters and each superblock's input), the outputs of the dots with no
    batch dimension that its backward reads: every such projection but the
    one closing a superblock's last branch (and silu(gate) in place of the
    gate product, of the same size).  The port keeps the same after the
    forward, and the recomputation takes back every output it kept."""
    _, _, model, params = _models(arch, remat="dots")
    batch = _batch(model.cfg.vocab_size)
    kept, calls = [], collections.Counter()
    contexts = remat._contexts
    monkeypatch.setattr(remat, "_contexts", lambda saved, *a: (kept.append(saved),
                                                                contexts(saved, *a))[1])
    run = remat.run
    monkeypatch.setattr(remat, "run", lambda *a: (calls.update([a[0]]), run(*a))[1])
    leaves = {n: p.clone().requires_grad_(True) for n, p in flatten_named(params)}
    loss = model.loss(tree_map_named(lambda n, _: leaves[n], params),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    saved = collections.Counter((str(t.dtype).removeprefix("torch."), t.numel())
                                for outs in kept for t in outs if t is not None)
    superblocks = sum(g.repeats for g in model.groups)
    assert calls == {"dots": superblocks} and len(kept) == superblocks
    want = _jax_residuals(arch, "dots", batch) - _jax_residuals(arch, "full", batch)
    assert saved == want
    loss.backward()
    assert all(t is None for outs in kept for t in outs)


@pytest.mark.parametrize("mode", ["full", UNKNOWN])
def test_an_unknown_mode_recomputes_everything_as_full(mode, monkeypatch):
    """Each layer's forward runs twice under "full" and an unknown mode (once
    more in the backward), and no product is saved."""
    _, _, model, params = _models("llama3.2-3b", remat=mode)
    batch = _batch(model.cfg.vocab_size)
    runs, saves = [], []
    ffn = layers.ffn_apply
    monkeypatch.setattr(layers, "ffn_apply", lambda *a: (runs.append(1), ffn(*a))[1])
    contexts = remat._contexts
    monkeypatch.setattr(remat, "_contexts", lambda *a: saves.append(1) or contexts(*a))
    _port_loss_and_grads(model, params, batch)
    assert len(runs) == 2 * model.cfg.n_layers and not saves

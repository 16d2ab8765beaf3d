"""The port's training path against the JAX package, on the CPU: the data
pipeline, the loss and its gradients, the plain attention backward (the
formulas the CUDA backward kernel implements), the optimizers and the train
step.

JAX-initialised weights are carried across (``models.convert``), so both
packages run the same numbers in float32; they differ by summation order.
Tolerances, each relative to the scale of what it compares:

  * loss: 1e-5 absolute (a mean of ~6);
  * gradients: 1e-3 x the largest |entry| of each gradient tensor, plus
    1e-7 (fp32 reductions in another order, amplified by the random
    model's large attention logits under the JAX fan-in init: measured up
    to 3.9e-4 of the scale);
  * attention backward: 2e-5 x each gradient's largest |entry|;
  * the optimizers on the same gradients: 2e-6 of each tensor's scale (one
    bf16 ulp for bf16 tensors); a train step's moments and residuals as
    gradients (Adam's normalised update turns sign noise of near-zero
    gradients into changes of size lr, so parameters after a step are held
    on the same gradients, as tests/test_training_serving.py holds the
    first moments);
  * sparsification: exact on the same gradients; after a train step the
    residual and moments as gradients, except at most 2 entries a tensor at
    the threshold;
  * data batches: bytes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JSyntheticPipeline
from repro.kernels import ref as JR
from repro.models import DecoderLM as JDecoderLM
from repro.statestore.checkpoint import flatten_named as j_flatten_named
from repro.training import OptConfig as JOptConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import apply_opt as j_apply_opt
from repro.training import init_opt_state as j_init_opt_state
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.models import DecoderLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import (OptConfig, StragglerWatchdog, TrainConfig, Trainer,
                                  TrainerConfig, apply_opt, init_opt_state, init_train_state,
                                  make_train_step)
from repro_torch.training.trainer import deterministic_cuda
from repro_torch.tree import dtype_name, flatten_named, from_numpy, tree_map_named


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _grad_close(got, want, tol=1e-3):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-7 + tol * np.abs(want).max()


# ------------------------------------------------------------------ pipeline
@pytest.mark.parametrize("seed,step,n_hosts,host_id,embed_dim", [
    (0, 0, 1, 0, 0), (3, 17, 1, 0, 0), (5, 2, 2, 1, 0), (1, 9, 4, 3, 0), (2, 4, 1, 0, 16),
])
def test_pipeline_batches_are_byte_identical(seed, step, n_hosts, host_id, embed_dim):
    kw = dict(vocab_size=1000, global_batch=8, seq_len=24, seed=seed, n_hosts=n_hosts,
              host_id=host_id, embed_dim=embed_dim)
    got = SyntheticPipeline(DataConfig(**kw)).batch_at(step)
    want = JSyntheticPipeline(JDataConfig(**kw)).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


# ---------------------------------------------------------- attention backward
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", [
    (2, 4, 2, 40, 40, 16, True, None),    # GQA, causal
    (1, 6, 2, 33, 33, 32, True, 7),       # group of 3, local window
    (1, 4, 4, 24, 24, 16, False, None),   # MHA, no mask
    (1, 8, 1, 20, 52, 16, True, None),    # MQA, Sk > Sq (q_offset)
])
def test_flash_backward_plain_matches_jax_vjp(b, hq, hkv, sq, sk, d, causal, window):
    rng = np.random.default_rng(sq * 7 + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=sk - sq)

    def f(q_, k_, v_):
        return JR.flash_attention_reference(q_, k_, v_, block_k=16, **kw)

    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = TR.flash_attention_reference(tq, tk, tv, block_k=16, return_lse=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=2e-5, rtol=1e-5)
    got = TR.flash_attention_backward_reference(tq, tk, tv, out, lse, torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        assert np.abs(_np(g) - _np(w)).max() <= 2e-5 * np.abs(_np(w)).max()

    # the same gradients through the differentiable route the model takes
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = ops.flash_attention(*leaves, block_k=16, **kw)
    o.backward(torch.from_numpy(do))
    for leaf, g in zip(leaves, got):
        torch.testing.assert_close(leaf.grad, g, atol=0, rtol=0)


def test_flash_lse_is_the_row_logsumexp():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 30, 16)).astype(np.float32))
               for _ in range(3))
    _, lse = tflash.flash_attention(q, k, v, causal=True, return_lse=True)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    logits = logits.masked_fill(torch.ones(30, 30, dtype=torch.bool).triu(1), -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), atol=1e-5, rtol=1e-6)


# --------------------------------------------------------------- loss + grads
def _models(arch="llama3.2-3b", **over):
    jcfg = j_get_smoke_config(arch, dtype="float32", **over)
    cfg = get_smoke_config(arch, dtype="float32", **over)
    jm, model = JDecoderLM(jcfg), DecoderLM(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    named = {n: np.asarray(a) for n, a in j_flatten_named(jp)}
    return jm, jp, model, params_from_numpy(named, model, "cpu")


def _batch(cfg_vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg_vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg_vocab, (b, s)).astype(np.int32)}


# recurrentgemma-9b's gradients at the JAX init: within 3e-3 of each one's
# scale (measured up to 2.75e-3, at its local-attention layer's FFN).  Its one
# KV head gets fan-in 1 under the JAX rule (wk of std 1), so its attention
# logits are large and the softmax near one-hot, and fp32 summation order is
# amplified as for llama's (tests/test_torch_models.py's LOGITS_CLOSE holds
# its logits to scale for the same reason).  The FFN after that attention has
# a small gradient (~5e-3 against ~5 in the RG-LRU layers), so the same
# absolute noise is a larger share of it.  With wq and wk at the standard
# fan-in every gradient is within 5e-6: the test below.
GRAD_TOL = {"recurrentgemma-9b": 3e-3}


def _loss_and_grads_both(arch, standard_fan_in=False):
    """(torch loss, JAX loss, torch grads, JAX grads) from the same weights
    and batch; with `standard_fan_in`, wq and wk scaled in both from the JAX
    rule's fan-in (shape[-2]) to d_model."""
    jm, jp, model, params = _models(arch)
    if standard_fan_in:
        named = {n: np.asarray(a) for n, a in j_flatten_named(jp)}
        for n, a in named.items():
            if n.endswith(("/wq", "/wk")):
                named[n] = (a * np.sqrt(a.shape[-2] / a.shape[-3])).astype(np.float32)
        jp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp),
                                          [jnp.asarray(named[n]) for n, _ in j_flatten_named(jp)])
        params = params_from_numpy(named, model, "cpu")
    batch = _batch(model.cfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {n: p.clone().requires_grad_(True) for n, p in flatten_named(params)}
    loss = model.loss(tree_map_named(lambda n, _: leaves[n], params),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return (float(loss.detach()), float(jloss), {n: t.grad for n, t in leaves.items()},
            dict(j_flatten_named(jgrads)))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen1.5-0.5b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "kimi-k2-1t-a32b", "grok-1-314b"])
def test_loss_and_gradients_match_jax(arch):
    """The recurrent archs differentiate their scans through the autograd
    Functions' plain route (the reverse-scan references)."""
    loss, jloss, grads, want = _loss_and_grads_both(arch)
    assert abs(loss - jloss) <= 1e-5
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        _grad_close(g, want[name], GRAD_TOL.get(arch, 1e-3))


def test_recurrentgemma_gradients_match_jax_at_standard_fan_in():
    """The dense archs' bound holds for recurrentgemma-9b once its attention
    logits are of order one: its GRAD_TOL is the JAX init's, not the port's."""
    loss, jloss, grads, want = _loss_and_grads_both("recurrentgemma-9b", standard_fan_in=True)
    assert abs(loss - jloss) <= 1e-5
    for name, g in grads.items():
        _grad_close(g, want[name])


def _sparse_close(got, want):
    """What a sparsified step leaves: the residual (zero where an entry was
    sent) and AdamW's moments (zero where none was).  An entry within the
    gradients' tolerance of the threshold may be sent by one package and
    kept by the other: at most 2 a tensor.  Everywhere else as gradients."""
    got, want = _np(got), _np(want)
    flip = (got == 0) != (want == 0)
    assert flip.sum() <= 2
    both = ~flip
    assert np.abs(got[both] - want[both]).max(initial=0) <= 1e-7 + 1e-3 * np.abs(want).max()


def test_sparsify_matches_jax_on_the_same_gradients():
    """Per-tensor top-k with error feedback, given the same gradients and
    residuals: sent entries and new residuals exactly equal."""
    from repro.training.train_step import _sparsify as j_sparsify
    from repro_torch.training.train_step import _sparsify

    rng = np.random.default_rng(11)
    shapes = [(40, 30), (7,), (3, 5, 8)]
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    res = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    for frac in (0.01, 0.1, 0.5):
        jsent, jres = j_sparsify([jnp.asarray(g) for g in grads], [jnp.asarray(r) for r in res],
                                 frac)
        tres = [torch.from_numpy(r.copy()) for r in res]
        sent = _sparsify([torch.from_numpy(g) for g in grads], tres, frac)
        for a, b in zip(sent + tres, list(jsent) + list(jres)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


# --------------------------------------------------------- optimizers + step
def _from_jax(arr, like):
    return from_numpy(np.array(arr), dtype_name(like)).to(like.dtype)


def _state_from_jax(jstate, model, tcfg):
    """The port's train state holding the JAX state's numbers."""
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    named = dict(j_flatten_named(jstate))
    return tree_map_named(lambda name, t: _from_jax(named[name], t), state)


@pytest.mark.parametrize("kind,momentum", [("adamw", "float32"), ("adafactor", "float32"),
                                           ("adafactor", "bfloat16")])
def test_apply_opt_matches_jax_on_the_same_gradients(kind, momentum):
    """Three updates from the same params, moments and gradients (clipping
    active on the first): params and moments within 2e-6 of each tensor's
    scale (fp32 means and pow in another order; bf16 momentum within one
    bf16 ulp)."""
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "stack": (2, 4, 3), "b": (7,)}
    jparams = {n: jnp.asarray(rng.standard_normal(s).astype(np.float32)) for n, s in shapes.items()}
    jparams["h"] = jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16)
    jcfg, cfg = JOptConfig(kind=kind, momentum_dtype=momentum), OptConfig(kind=kind,
                                                                            momentum_dtype=momentum)
    jstate = j_init_opt_state(jparams, jcfg)
    params = {n: _from_jax(a, torch.zeros((), dtype=torch.bfloat16 if n == "h" else torch.float32))
              for n, a in jparams.items()}
    state = init_opt_state(params, cfg)
    for step in range(3):
        grads = {n: rng.standard_normal(np.shape(a)).astype(np.float32) * (3.0 if step == 0 else 0.1)
                 for n, a in jparams.items()}
        jg = {n: jnp.asarray(g, jparams[n].dtype) for n, g in grads.items()}
        jparams, jstate, jnorm = j_apply_opt(jparams, jg, jstate, jcfg, jnp.int32(step))
        tg = [_from_jax(jg[n], params[n]) for n, _ in flatten_named(params)]
        norm = apply_opt(params, tg, state, cfg, torch.tensor(step, dtype=torch.int32))
        assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
        for name, w in list(j_flatten_named(jparams)) + list(j_flatten_named(jstate)):
            t = dict(flatten_named(params), **{f"s/{n}": s for n, s in flatten_named(state)})[
                name if name in dict(flatten_named(params)) else f"s/{name}"]
            scale = np.abs(_np(w)).max()
            ulp = 2 ** -7 if t.dtype == torch.bfloat16 else 2e-6
            assert np.abs(_np(t) - _np(w)).max() <= ulp * scale + 1e-12, (step, name)


@pytest.mark.parametrize("kind,momentum", [("adamw", "float32"), ("adafactor", "bfloat16")])
def test_apply_opt_takes_stacked_tensors_in_pieces(monkeypatch, kind, momentum):
    """A tensor of rank >= 3 is updated in pieces of whole first-axis slices
    (at most PIECE elements): the same parameters, moments and norm as in
    one piece, within fp32 rounding of the norm's order of summation."""
    from repro_torch.training import optimizer

    rng = np.random.default_rng(3)
    shapes = {"stack": (5, 4, 3), "deep": (3, 2, 2, 3), "w": (6, 5), "b": (7,)}
    cfg = OptConfig(kind=kind, momentum_dtype=momentum)
    runs = []
    for piece in (1 << 28, 24):  # one piece; then 2 slices of "stack", 2 of "deep"
        monkeypatch.setattr(optimizer, "PIECE", piece)
        params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for n, s in shapes.items()}
        rng = np.random.default_rng(3)
        state, norms = init_opt_state(params, cfg), []
        grng = np.random.default_rng(4)
        for step in range(2):
            grads = [torch.from_numpy(grng.standard_normal(p.shape).astype(np.float32))
                     for _, p in flatten_named(params)]
            norms.append(float(apply_opt(params, grads, state, cfg,
                                         torch.tensor(step, dtype=torch.int32))))
        runs.append((dict(flatten_named(params)), dict(flatten_named(state)), norms))
    (p1, s1, n1), (p2, s2, n2) = runs
    np.testing.assert_allclose(n1, n2, rtol=1e-6)
    for name in p1:
        torch.testing.assert_close(p1[name], p2[name], atol=1e-6, rtol=1e-6)
    for name in s1:
        torch.testing.assert_close(s1[name].float(), s2[name].float(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("opt,extra", [
    ("adamw", {}),
    ("adafactor", {}),
    ("adafactor", {"momentum_dtype": "bfloat16"}),
    ("adamw", {"accum": 2}),
    ("adamw", {"grad_topk_frac": 0.1}),
])
def test_one_train_step_matches_jax(opt, extra):
    """loss, grad_norm and what carries the gradients: AdamW's m and v,
    Adafactor's vr/vc (or v) and the sparsification residual, each against
    its scale (the gradients' tolerance).  The normalised updates (the
    params, Adafactor's m) turn sign noise of near-zero gradients into
    changes of size lr, so they are held on the same gradients above."""
    extra = dict(extra)
    accum = extra.pop("accum", 1)
    topk = extra.pop("grad_topk_frac", 0.0)
    jm, jp, model, _ = _models("qwen1.5-0.5b")
    jt = JTrainConfig(opt=JOptConfig(kind=opt, lr=1e-3, **extra), accum_steps=accum,
                      grad_topk_frac=topk)
    tc = TrainConfig(opt=OptConfig(kind=opt, lr=1e-3, **extra), accum_steps=accum,
                     grad_topk_frac=topk)
    js = j_init_train_state(jm, jax.random.PRNGKey(0), jt)
    js["params"] = jp
    state = _state_from_jax(js, model, tc)
    batch = _batch(model.cfg.vocab_size, b=4, s=12, seed=1)
    jnew, jmet = j_make_train_step(jm, jt)(js, {k: jnp.asarray(v) for k, v in batch.items()})
    new, met = make_train_step(model, tc)(state, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-5
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= 1e-4 * float(jmet["grad_norm"])
    assert int(new["step"]) == int(jnew["step"]) == 1
    want = dict(j_flatten_named(jnew))
    got = dict(flatten_named(new))
    assert sorted(got) == sorted(want)
    held = 0
    for name, t in got.items():
        assert str(t.dtype) == f"torch.{np.asarray(want[name]).dtype}", name
        last = name.rsplit("/", 1)[-1]
        if name.startswith("residual/") or (topk and name.startswith("opt/")):
            _sparse_close(t, want[name])
            held += 1
        elif name.startswith("opt/") and (
                last in ("vr", "vc", "v") or (opt == "adamw" and last == "m")):
            _grad_close(t, want[name])
            held += 1
    assert held >= len(list(flatten_named(new["params"])))


def test_trainer_loss_decreases_and_watchdog():
    cfg = get_smoke_config("llama3.2-3b")
    model = DecoderLM(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=32)
    tr = Trainer(model, TrainConfig(opt=OptConfig(lr=1e-3)), dcfg, seed=1, device="cpu")
    tr.init()
    out = tr.run(TrainerConfig(total_steps=12))
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 12 and all(np.isfinite(losses))
    assert min(losses[-4:]) < losses[0]
    w = StragglerWatchdog(tolerance=2.0)
    for i in range(10):
        w.observe(i, 0.1)
    assert not w.observe(10, 0.15) and w.observe(11, 0.5) and w.events[0]["step"] == 11


def test_deterministic_mode_is_scoped_to_its_block():
    """The trainer's deterministic mode holds inside its block only: the
    caller's settings come back after it, after an exception too."""
    det = torch.utils.deterministic
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(), det.fill_uninitialized_memory)
    try:
        for mode in ((False, False), (True, True)):
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
            det.fill_uninitialized_memory = True
            with pytest.raises(KeyError):
                with deterministic_cuda():
                    assert torch.are_deterministic_algorithms_enabled()
                    assert not torch.is_deterministic_algorithms_warn_only_enabled()
                    assert not det.fill_uninitialized_memory
                    raise KeyError("a failing step")
            assert (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled(),
                    det.fill_uninitialized_memory) == (*mode, True)
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        det.fill_uninitialized_memory = saved[2]


def test_train_cli_on_cpu_returns_totals():
    """main returns its totals and gives SIGTERM back to the caller's
    handler (the trainer's handler would keep the trainer and its state
    alive in the caller's process)."""
    import signal

    from repro_torch.launch import train

    before = signal.getsignal(signal.SIGTERM)
    out = train.main(["--device", "cpu", "--arch", "qwen1.5-0.5b", "--steps", "2",
                      "--seq-len", "16", "--optimizer", "adafactor"])
    assert out["device"] == "cpu" and out["final_step"] == 2 and out["all_finite"]
    assert len(out["losses"]) == 2 and out["tokens"] == 2 * 4 * 16
    assert signal.getsignal(signal.SIGTERM) is before


def test_train_entry_points_need_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    cfg = get_smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(DecoderLM(cfg), TrainConfig(),
                DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=8))

#!/usr/bin/env python3
"""Step-0 gradient norm of the JAX package and of the PyTorch port's plain
(CPU) path, from the same weights and batch, at llama3.2-3b widths cut to a
few depths, in float32.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_grad_norm_vs_jax.py --depths 2 4 8

For each depth the JAX package initialises the weights (seed 0), takes the
loss and its gradient on a numpy batch and writes the weights to a fresh
directory under the temporary directory (`TMPDIR`), removed at the end;
then, in a second process, the port loads those weights and does the same,
once more with attention blocks of 64 keys (the same function summed in
another order over the 128 tokens: how far the random model amplifies
rounding).
One package runs at a time (depth 8 holds ~1.6 B fp32 parameters and their
gradients, ~13 GB a process).  Norms are summed in float64.  Prints one JSON
line per depth: both losses, both global norms and the largest tensors'.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ARCH = "llama3.2-3b"


def _batch(vocab: int, batch: int, seq: int):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32)}


def _report(loss: float, norms: dict) -> dict:
    top = sorted(norms, key=lambda n: -norms[n])[:5]
    return {"loss": loss, "global_norm": float(np.sqrt(sum(v * v for v in norms.values()))),
            "largest": {n: norms[n] for n in top}}


def run_jax(depth: int, batch: int, seq: int, tmp: Path) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import DecoderLM
    from repro.statestore.checkpoint import flatten_named

    cfg = dataclasses.replace(get_config(ARCH), n_layers=depth, dtype="float32")
    model = DecoderLM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    np.savez(tmp / "params.npz", **{n: np.asarray(a) for n, a in flatten_named(params)})
    data = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size, batch, seq).items()}
    loss, grads = jax.value_and_grad(model.loss)(params, data)
    norms = {n: float(np.sqrt(np.sum(np.square(np.asarray(g, np.float64)))))
             for n, g in flatten_named(grads)}
    return _report(float(loss), norms)


def run_torch(depth: int, batch: int, seq: int, tmp: Path) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.tree import flatten_named, tree_map_named

    cfg = dataclasses.replace(get_config(ARCH), n_layers=depth, dtype="float32")
    model = DecoderLM(cfg)  # the layout params_from_numpy fills
    with np.load(tmp / "params.npz") as f:
        params = params_from_numpy({n: f[n] for n in f.files}, model, "cpu")
    leaves = {n: p.requires_grad_(True) for n, p in flatten_named(params)}
    data = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, batch, seq).items()}
    out = {}
    for block_k in (cfg.attn_block_k, 64):  # the port against itself: another summation order
        m = DecoderLM(dataclasses.replace(cfg, attn_block_k=block_k))
        loss = m.loss(tree_map_named(lambda n, _: leaves[n], params), data)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        norms = {n: float(g.double().norm()) for n, g in zip(leaves, grads)}
        out[block_k] = _report(float(loss.detach()), norms)
        del grads
    return dict(out[cfg.attn_block_k], block_k_64=out[64])


def _compare(args, tmp: Path) -> None:
    for depth in args.depths:
        out = {"arch": ARCH, "layers": depth, "dtype": "float32", "batch": args.batch,
               "seq_len": args.seq_len}
        for side in ("jax", "torch"):
            proc = subprocess.run(
                [sys.executable, __file__, "--side", side, "--depths", str(depth), "--batch",
                 str(args.batch), "--seq-len", str(args.seq_len), "--tmp", str(tmp)],
                capture_output=True, text=True, check=True, env=dict(os.environ))
            out[side] = json.loads(proc.stdout.strip().splitlines()[-1])
        out["norm_ratio_torch_over_jax"] = out["torch"]["global_norm"] / out["jax"]["global_norm"]
        print(json.dumps(out), flush=True)
        (tmp / "params.npz").unlink()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)  # the weights' directory, for --side
    ap.add_argument("--side", choices=("jax", "torch"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:  # one package, in its own process
        run = run_jax if args.side == "jax" else run_torch
        print(json.dumps(run(args.depths[0], args.batch, args.seq_len, Path(args.tmp))))
        return 0
    tmp = Path(tempfile.mkdtemp(prefix="gradnorm-"))
    try:
        _compare(args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's GPipe schedule (repro_torch.training.pipeline) on 4 gloo
ranks, against sequential application and the JAX package's pipeline_apply
on 4 fake host devices, on the same numpy inputs: err < 1e-5, the bound of
tests/test_pipeline.py."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_ranks import REPO, run_ranks

S, B, D = 4, 8, 16

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.training.pipeline import pipeline_apply
    inp = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((4,), ("stage",))
    with jax.set_mesh(mesh):
        out = pipeline_apply(lambda p, h: jnp.tanh(h @ p), jnp.asarray(inp["w"]),
                             jnp.asarray(inp["x"]), mesh, axis="stage", n_micro=4)
    np.save(sys.argv[2], np.asarray(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    np.savez(d / "pipe4.in.npz", w=w, x=x)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(d / "pipe4.in.npz"),
                                str(d / "jax.npy")], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    run_ranks("pipe4", 4, d, timeout=200)
    _, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, err[-3000:]
    ref = x
    for s in range(S):
        ref = np.tanh(ref @ w[s])
    return torch.load(d / "pipe4.out.pt", weights_only=False), np.load(d / "jax.npy"), ref


@pytest.mark.parametrize("key", ["y", "y_dtensor"])
def test_pipeline_on_4_ranks_matches_sequential_and_jax(runs, key):
    out, y_jax, ref = runs
    assert out[key].shape == ref.shape
    assert np.abs(out[key] - ref).max() < 1e-5
    assert np.abs(out[key] - y_jax).max() < 1e-5

"""Runs a function of tests/_torch_mesh_worker.py on N CPU ranks.

Each rank is its own Python process, joined to the others by a gloo
process group over a ``file://`` store in the given directory (never a TCP
port: test files run side by side).  The ranks write their results into
that directory; a rank that fails or outlives `timeout` fails the call.
Nothing of the process group reaches the calling process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"


def run_ranks(scenario: str, world: int, directory, timeout: float = 300.0) -> None:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    logs = [open(directory / f"{scenario}.{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), scenario, str(r), str(world),
                               str(directory)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tail = (directory / f"{scenario}.{bad[0]}.log").read_text()[-4000:]
        raise AssertionError(f"{scenario}: ranks {bad} failed (codes "
                             f"{[procs[r].returncode for r in bad]}); rank {bad[0]}:\n{tail}")

"""Launch a gloo world of the port on the CPU for the parallelism tests.

run_world(n, job, tmp) starts n processes of tests/torch_mesh_worker.py
with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT). The worker imports torch and the port only, never a test
module (tests/conftest.py imports JAX). Inputs go to the worker as one
.npz of flattened trees (flatten / unflatten: "a/b/0/c" keys) beside a
JSON job; each rank writes rank<r>.npz, which run_world returns in rank
order. Every launch has a time limit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")


def flatten(tree, prefix=""):
    """{path: numpy array} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(n: int, job: dict, arrays: dict, tmp):
    """Start `job` on an n-rank gloo world; returns the processes."""
    tmp = str(tmp)
    np.savez(os.path.join(tmp, "in.npz"), **arrays)
    job = dict(job, inputs=os.path.join(tmp, "in.npz"), out_dir=tmp)
    path = os.path.join(tmp, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    port = free_port()
    base = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
                OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = []
    for r in range(n):
        env = dict(base, RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen([sys.executable, WORKER, path], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def stop_world(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


def run_world(n: int, job: dict, arrays: dict, tmp, timeout: float = 150.0):
    """Run `job` on an n-rank gloo world; returns each rank's outputs."""
    procs = start_world(n, job, arrays, tmp)
    tmp = str(tmp)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(n)]

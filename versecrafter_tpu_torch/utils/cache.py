"""Entry-point runtime setup: the process group of a torchrun launch.

The counterpart of the JAX package's utils/cache.py. Its persistent compile
cache has no counterpart here (the port's kernels are cached by source hash
in kernels/_build.py), and its RNG switch none either (seeds go through
utils/prng.py's threefry). What is left is the world's bootstrap:
maybe_init_distributed reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joins the process group, NCCL on
the card and gloo when the caller runs on the CPU. Every CLI and server
calls it first.

A world of several ranks has two kinds of traffic. The model's collectives
run on the default group and the mesh's groups, where a rank that never
arrives fails the others after TIMEOUT. The control traffic (rank 0's task
announcements to the serving ranks, their agreement on each task's outcome,
wait_all where one rank works alone) runs on control_group(): gloo, with a
timeout long enough for any idle time between two requests.
"""

from __future__ import annotations

import datetime
import os

# a collective that one rank never enters fails after this long instead of
# hanging the world
TIMEOUT = datetime.timedelta(seconds=60)
# the control group's: a serving rank waits this long for rank 0's next task
CONTROL_TIMEOUT = datetime.timedelta(days=365)

_CONTROL = None


def _launched() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def maybe_init_distributed(device=None) -> bool:
    """Join torchrun's world when its environment is set: NCCL with
    torch.cuda.set_device(LOCAL_RANK) unless `device` is the CPU, then
    gloo; a world of several ranks also gets its control group. Returns
    True when this call initialised the group; False without the
    environment (a single process) and when the group exists already (the
    CLIs, factories and servers may each call it)."""
    import torch
    import torch.distributed as dist

    global _CONTROL
    if not _launched() or dist.is_initialized():
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo" if cpu else "nccl", timeout=TIMEOUT)
    _CONTROL = (dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
                if dist.get_world_size() > 1 else None)
    return True


def control_group():
    """The world's control group (maybe_init_distributed made it)."""
    if _CONTROL is None:
        raise RuntimeError("no control group: the world of several ranks was not "
                           "initialised by utils.cache.maybe_init_distributed")
    return _CONTROL


def wait_all() -> None:
    """Meet every rank of the world on the control group, where ranks
    arrive at their own pace (after a load, a checkpoint save) and the
    model's next collective would otherwise time out. Nothing in one
    process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(group=control_group())
